// The fused path-trace kernel's instance instantiations (3', the TPU
// kernel's inst_ranges: wavefront/pallas_pt.py:689-699, 858-884,
// 1146-1158): pt_fused_kernel<kInst, specular, pbr, prims>, in a source of
// their own so the per-source parallel build keeps its time. The kernel is
// in pt_fused.cuh.
#include "pt_fused.cuh"

namespace ort_fused {

void launch_inst(const FusedArgs& a, bool specular, bool pbr, bool prims) {
  launch_geometry<kInst>(a, specular, pbr, prims);
}

}  // namespace ort_fused
