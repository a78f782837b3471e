// The fused Cornell path-trace kernel: a whole progressive launch per pixel.
//
// Replaces wavefront/pallas_pt.py::render_sum_fused -> _make_kernel/kernel
// in its Cornell configuration (has_specular=False, has_pbr=False, no
// custom prims, no instances, no textures, smooth=False). Per pixel, spl
// times: TEA seed, jittered raygen with the ortho and thin-lens selects,
// then up to max_depth bounces of closest hit, miss / emission, NEE toward
// the parallelogram light with an any-hit shadow ray, cosine bounce and
// Russian roulette. Outputs the radiance sum [H, W, 3] f32 and the rays
// traced per pixel [H*W] as int32 (the TPU kernel's f32 count is inexact
// past 2^24; the wrapper sums these in int64).
//
// What bounds it on the H100: FP32 issue and divergence. A bounce tests
// every triangle twice (closest, then shadow) at ~20 flops each; the scene
// (32 triangles = 2 KB) lives in shared memory and every read is a
// broadcast; HBM sees 16 bytes per pixel out. Paths end at different
// depths, so warps lose lanes as paths die.
//
// Design: one thread per pixel, the path state in registers, a per-thread
// loop of spl samples x max_depth bounces. A path that misses or loses
// Russian roulette leaves the bounce loop; that gives the values of both
// the lock-step and the regeneration schedules of the TPU kernel, whose
// dead lanes add nothing. The shadow test is skipped when the light faces
// away (its weight is zero either way) and stops at the first occluder.
// The RNG draws follow the engine's order exactly: jitter, lens pair, then
// per bounce NEE, bounce direction, the unused glass pair, Russian roulette.
// Normalisation is x * (1 / sqrt(max(x.x, 1e-20))), pallas_pt.py's rsqrt
// form with each step correctly rounded. Where the TPU kernel multiplies by
// a reciprocal (the light direction, the roulette weight) this kernel
// divides, and it forms the NEE term as (T*albedo*Le)*w, both as the
// wavefront engine does: with -fmad=false the two paths then round alike
// and agree bit for bit, not only within the parity bars.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kRayTmin = 1e-2f;           // engine.RAY_TMIN
constexpr float kShadowTmaxScale = 0.999f;  // engine.SHADOW_TMAX_SCALE
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.283185307179586f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 normalize3(V3 a) {
  const float inv = 1.0f / sqrtf(fmaxf(dot3(a, a), 1e-20f));
  return {a.x * inv, a.y * inv, a.z * inv};
}

// pallas_pt.py::_cosine_sample: concentric disk + Frisvad/Duff basis.
__device__ __forceinline__ V3 cosine_sample(float u1, float u2, V3 n) {
  const float ox = 2.0f * u1 - 1.0f;
  const float oy = 2.0f * u2 - 1.0f;
  const bool x_major = fabsf(ox) > fabsf(oy);
  float r = x_major ? ox : oy;
  const float safe_ox = ox == 0.0f ? 1.0f : ox;
  const float safe_oy = oy == 0.0f ? 1.0f : oy;
  const float quarter_pi = 0.7853981633974483f;
  const float half_pi = 1.5707963267948966f;
  const float theta = x_major ? quarter_pi * (oy / safe_ox)
                              : half_pi - quarter_pi * (ox / safe_oy);
  if (ox == 0.0f && oy == 0.0f) r = 0.0f;
  const float dx = r * cosf(theta);
  const float dy = r * sinf(theta);
  const float dz = sqrtf(fmaxf(0.0f, 1.0f - dx * dx - dy * dy));
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float b = n.x * n.y * a;
  const V3 t = {1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x};
  const V3 bt = {b, sign + n.y * n.y * a, -n.y};
  return normalize3({dx * t.x + dy * bt.x + dz * n.x,
                     dx * t.y + dy * bt.y + dz * n.y,
                     dx * t.z + dy * bt.z + dz * n.z});
}

__global__ void __launch_bounds__(kThreads)
pt_fused_cornell_kernel(const float* __restrict__ tri, int m,
                        const float* __restrict__ mats, int k,
                        const float* __restrict__ light,
                        const float* __restrict__ cam,
                        const long long* __restrict__ subframe_in,
                        int width, int height, int full_w, int full_h, int y0,
                        int spl, int max_depth, float* __restrict__ rad_out,
                        int* __restrict__ count_out) {
  // Shared: triangles [m,16] (col 15 = material id), materials [k,16],
  // light [16], camera [2,16].
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_mat = s_tri + 16 * m;
  float* s_light = s_mat + 16 * k;
  float* s_cam = s_light + 16;
  for (int i = threadIdx.x; i < 16 * m; i += blockDim.x) s_tri[i] = tri[i];
  for (int i = threadIdx.x; i < 16 * k; i += blockDim.x) s_mat[i] = mats[i];
  for (int i = threadIdx.x; i < 16; i += blockDim.x) s_light[i] = light[i];
  for (int i = threadIdx.x; i < 32; i += blockDim.x) s_cam[i] = cam[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= width * height) return;
  const int gx = p % width;
  const int gy = p / width + y0;
  const uint32_t pixel_index =
      static_cast<uint32_t>(gy) * static_cast<uint32_t>(full_w) +
      static_cast<uint32_t>(gx);
  const uint32_t subframe0 = static_cast<uint32_t>(*subframe_in);

  const V3 eye = {s_cam[0], s_cam[1], s_cam[2]};
  const V3 U = {s_cam[3], s_cam[4], s_cam[5]};
  const V3 V = {s_cam[6], s_cam[7], s_cam[8]};
  const V3 W = {s_cam[9], s_cam[10], s_cam[11]};
  const float aperture = s_cam[12], focal = s_cam[13];
  const bool is_ortho = s_cam[14] > 0.0f;
  const float ohx = s_cam[16], ohy = s_cam[17];
  const V3 miss = {s_cam[18], s_cam[19], s_cam[20]};
  const V3 lc = {s_light[0], s_light[1], s_light[2]};
  const V3 lv1 = {s_light[3], s_light[4], s_light[5]};
  const V3 lv2 = {s_light[6], s_light[7], s_light[8]};
  const V3 ln = {s_light[9], s_light[10], s_light[11]};
  const V3 lem = {s_light[12], s_light[13], s_light[14]};
  const float larea = s_light[15];

  const float ulen = sqrtf(fmaxf(dot3(U, U), 1e-20f));
  const float vlen = sqrtf(fmaxf(dot3(V, V), 1e-20f));
  const float wlen = sqrtf(fmaxf(dot3(W, W), 1e-20f));
  const V3 un = {U.x / ulen, U.y / ulen, U.z / ulen};
  const V3 vn = {V.x / vlen, V.y / vlen, V.z / vlen};
  const V3 wn = {W.x / wlen, W.y / wlen, W.z / wlen};
  const float gxf = static_cast<float>(gx), gyf = static_cast<float>(gy);
  const float full_wf = static_cast<float>(full_w);
  const float full_hf = static_cast<float>(full_h);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  int count = 0;
  for (int s = 0; s < spl; ++s) {
    // --- raygen (pallas_pt.py raygen_state) ---
    uint32_t rng = ort::tea4(pixel_index, subframe0 + static_cast<uint32_t>(s));
    const float jx = ort::uniform(rng);
    const float jy = ort::uniform(rng);
    const float ndc_x = 2.0f * ((gxf + jx) / full_wf) - 1.0f;
    const float ndc_y = 1.0f - 2.0f * ((gyf + jy) / full_hf);
    V3 d = normalize3({ndc_x * U.x + ndc_y * V.x + W.x,
                       ndc_x * U.y + ndc_y * V.y + W.y,
                       ndc_x * U.z + ndc_y * V.z + W.z});
    V3 o = eye;
    if (is_ortho) {
      o = {eye.x + ndc_x * ohx * un.x + ndc_y * ohy * vn.x,
           eye.y + ndc_x * ohx * un.y + ndc_y * ohy * vn.y,
           eye.z + ndc_x * ohx * un.z + ndc_y * ohy * vn.z};
      d = wn;
    }
    const float lu1 = ort::uniform(rng);   // thin-lens pair, always drawn
    const float lu2 = ort::uniform(rng);
    if (aperture > 0.0f) {
      const float r_l = sqrtf(lu1) * aperture;
      const float phi = kTwoPi * lu2;
      const float c = r_l * cosf(phi), sn = r_l * sinf(phi);
      const V3 f = {o.x + focal * d.x, o.y + focal * d.y, o.z + focal * d.z};
      o = {o.x + (c * un.x + sn * vn.x), o.y + (c * un.y + sn * vn.y),
           o.z + (c * un.z + sn * vn.z)};
      d = normalize3({f.x - o.x, f.y - o.y, f.z - o.z});
    }

    V3 thr = {1.f, 1.f, 1.f};
    V3 rad = {0.f, 0.f, 0.f};
    bool prev_spec = true;
    float tmin = 1e-4f;           // camera rays: Rays.make's default tmin
    for (int depth = 0; depth < max_depth; ++depth) {
      // --- closest hit ---
      float bt = 1e16f;
      int bid = -1;
      const float* bc = nullptr;
      for (int t = 0; t < m; ++t) {
        const float* c = s_tri + 16 * t;
        float tt, uu, vv, dpz;
        ort::tri_test(c, o.x, o.y, o.z, d.x, d.y, d.z, tt, uu, vv, dpz);
        if (ort::tri_accept(tt, uu, vv, dpz, tmin, bt)) {
          bt = tt; bid = t; bc = c;
        }
      }
      count += 1;
      if (bid < 0) {                 // miss: constant background, path ends
        rad.x += thr.x * miss.x;
        rad.y += thr.y * miss.y;
        rad.z += thr.z * miss.z;
        break;
      }
      const float* mt = s_mat + 16 * static_cast<int>(bc[15]);
      const V3 alb = {mt[1], mt[2], mt[3]};
      const V3 em = {mt[4], mt[5], mt[6]};
      // two-sided normal: flip when it faces along the ray
      const float flip = (bc[12] * d.x + bc[13] * d.y + bc[14] * d.z) > 0.0f
                             ? -1.0f : 1.0f;
      const V3 n = {bc[12] * flip, bc[13] * flip, bc[14] * flip};
      const V3 hp = {o.x + bt * d.x, o.y + bt * d.y, o.z + bt * d.z};
      if (prev_spec) {
        rad.x += thr.x * em.x;
        rad.y += thr.y * em.y;
        rad.z += thr.z * em.z;
      }
      const V3 ta = {thr.x * alb.x, thr.y * alb.y, thr.z * alb.z};

      // --- NEE toward the parallelogram light ---
      const float u1 = ort::uniform(rng);
      const float u2 = ort::uniform(rng);
      const V3 lp = {lc.x + u1 * lv1.x + u2 * lv2.x,
                     lc.y + u1 * lv1.y + u2 * lv2.y,
                     lc.z + u1 * lv1.z + u2 * lv2.z};
      const V3 dl = {lp.x - hp.x, lp.y - hp.y, lp.z - hp.z};
      const float dist2 = fmaxf(dot3(dl, dl), 1e-12f);
      const float dist = sqrtf(dist2);
      const V3 wi = {dl.x / dist, dl.y / dist, dl.z / dist};
      const float n_dl = dot3(n, wi);
      const float ln_dl = fabsf(ln.x * wi.x + ln.y * wi.y + ln.z * wi.z);
      if (n_dl > 0.0f) {
        const float sh_tmax = dist * kShadowTmaxScale;
        bool occ = false;
        for (int t = 0; t < m && !occ; ++t) {
          float tt, uu, vv, dpz;
          ort::tri_test(s_tri + 16 * t, hp.x, hp.y, hp.z, wi.x, wi.y, wi.z,
                        tt, uu, vv, dpz);
          occ = ort::tri_accept(tt, uu, vv, dpz, kRayTmin, sh_tmax);
        }
        if (!occ) {
          const float w_l = n_dl * ln_dl * larea / (kPi * dist2);
          rad.x += ta.x * lem.x * w_l;
          rad.y += ta.y * lem.y * w_l;
          rad.z += ta.z * lem.z * w_l;
        }
      }
      count += 1;                    // the shadow ray of a diffuse hit

      // --- next direction: cosine lobe; the glass pair is drawn unused ---
      const float b1 = ort::uniform(rng);
      const float b2 = ort::uniform(rng);
      const V3 nd = cosine_sample(b1, b2, n);
      ort::advance2(rng);
      const float off = (dot3(nd, n) >= 0.0f ? 1.0f : -1.0f) * kRayTmin;
      o = {hp.x + n.x * off, hp.y + n.y * off, hp.z + n.z * off};
      d = nd;
      tmin = kRayTmin;
      prev_spec = false;

      // --- Russian roulette from depth 1 ---
      const float u5 = ort::uniform(rng);
      (void)ort::uniform(rng);
      const float q = fminf(fmaxf(fmaxf(ta.x, fmaxf(ta.y, ta.z)), 0.05f), 1.0f);
      thr = ta;
      if (depth >= 1) {
        if (u5 >= q) break;
        thr = {ta.x / q, ta.y / q, ta.z / q};
      }
    }
    acc_r += rad.x;
    acc_g += rad.y;
    acc_b += rad.z;
  }
  rad_out[3 * p] = acc_r;
  rad_out[3 * p + 1] = acc_g;
  rad_out[3 * p + 2] = acc_b;
  count_out[p] = count;
}

}  // namespace

extern "C" int ort_pt_fused_cornell(const float* tri, int m, const float* mats,
                                    int k, const float* light,
                                    const float* cam,
                                    const long long* subframe, int width,
                                    int height, int full_w, int full_h, int y0,
                                    int spl, int max_depth, float* rad,
                                    int* count, void* stream) {
  const int n = width * height;
  if (n > 0) {
    const size_t smem = sizeof(float) * (16 * (m + k) + 16 + 32);
    pt_fused_cornell_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        tri, m, mats, k, light, cam, subframe, width, height, full_w, full_h,
        y0, spl, max_depth, rad, count);
  }
  return static_cast<int>(cudaGetLastError());
}
