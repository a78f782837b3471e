// The fused path-trace kernel's flat instantiations (kernel 3, the Cornell
// configuration, and its specular / PBR / prim variants 3') and the C entry
// of all of them. The kernel itself, what it replaces, what bounds it and
// its design are in pt_fused.cuh; pt_fused_inst.cu, pt_fused_smooth.cu and
// pt_fused_tex.cu instantiate the instance, smooth-normal and texture modes.
#include "pt_fused.cuh"

namespace ort_fused {

void launch_flat(const FusedArgs& a, bool specular, bool pbr, bool prims) {
  launch_geometry<kFlat>(a, specular, pbr, prims);
}

}  // namespace ort_fused

// geometry: 0 flat, 1 instances (inst [n_inst, 16], inst_ranges [n_inst, 2]),
// 2 smooth normals (corner [m, 9]), 3 textures (corner [m, 20], bundles
// [n_b, atlas_h, atlas_w, 16], bundle_mip [n_b, n_levels, 4]);
// kernels.GEOMETRY.
extern "C" int ort_pt_fused(const float* tri, int m, const float* prims,
                            int np, const float* mats, int k,
                            const float* light, const float* cam,
                            const long long* subframe, int width, int height,
                            int full_w, int full_h, int y0, int spl,
                            int max_depth, int specular, int pbr,
                            int geometry, const float* inst,
                            const int* inst_ranges, int n_inst,
                            const float* corner, const float* bundles,
                            const int* bundle_mip, int n_levels, int atlas_h,
                            int atlas_w, float* rad, int* count,
                            void* stream) {
  if (width * height > 0) {
    const ort_fused::FusedArgs a{
        tri, m, prims, np, mats, k, light, cam, subframe, width, height,
        full_w, full_h, y0, spl, max_depth, rad, count, inst, inst_ranges,
        n_inst, corner, bundles, bundle_mip, n_levels, atlas_h, atlas_w,
        static_cast<cudaStream_t>(stream)};
    const bool sp = specular != 0, pb = pbr != 0, pr = np > 0;
    if (geometry == 1) {
      ort_fused::launch_inst(a, sp, pb, pr);
    } else if (geometry == 2) {
      ort_fused::launch_smooth(a, sp, pb, pr);
    } else if (geometry == 3) {
      ort_fused::launch_tex(a, sp, pb, pr);
    } else if (geometry == 0) {
      ort_fused::launch_flat(a, sp, pb, pr);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
