// The fused path-trace kernel's texture instantiations (3', the TPU
// kernel's tex_cfg: fetch_bundle16 and the map application,
// wavefront/pallas_pt.py:701-813, 1017-1079, its table pack_tex_table
// :316-368): pt_fused_kernel<kTex, specular, pbr, prims>, in a source of
// their own so the per-source parallel build keeps its time. The kernel,
// what bounds it and the texture unit's design are in pt_fused.cuh.
#include "pt_fused.cuh"

namespace ort_fused {

void launch_tex(const FusedArgs& a, bool specular, bool pbr, bool prims) {
  launch_geometry<kTex>(a, specular, pbr, prims);
}

}  // namespace ort_fused
