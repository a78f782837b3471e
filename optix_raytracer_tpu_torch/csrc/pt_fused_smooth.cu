// The fused path-trace kernel's smooth-normal instantiations (3', the TPU
// kernel's smooth=True with its winner-attribute fetch:
// wavefront/pallas_pt.py:963-1016, pack_shade2 :371-391):
// pt_fused_kernel<kSmooth, specular, pbr, prims>, in a source of their own
// so the per-source parallel build keeps its time. The kernel is in
// pt_fused.cuh.
#include "pt_fused.cuh"

namespace ort_fused {

void launch_smooth(const FusedArgs& a, bool specular, bool pbr,
                   bool prims) {
  launch_geometry<kSmooth>(a, specular, pbr, prims);
}

}  // namespace ort_fused
