// Shared device helpers of the port's kernels: the Woop unit-triangle test,
// the group-box slab test of kernels 1-3 and the counter RNG, each the same
// arithmetic as its JAX or plain PyTorch counterpart.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ort {

constexpr float kDegenEps = 1e-12f;   // accel/pallas_bf.py _DEGEN_EPS
constexpr float kSlabBig = 3.0e38f;   // clusters._BIG: the slab's start

// accel/pallas_bf.py::_tri_test. c is one tri_consts row: M^-1 rows (0:9),
// offsets (9:12), face normal (12:15). Every product and sum is rounded on
// its own (_rn intrinsics; no FMA contraction), in the Pallas kernel's
// order, so the hit ids equal those of the plain PyTorch version bit for bit
// whatever the file's -fmad setting.
__device__ __forceinline__ void tri_test(const float* c, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float& tt, float& uu,
                                         float& vv, float& dpz) {
  const float opx = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, c[0]),
      __fmul_rn(oy, c[1])), __fmul_rn(oz, c[2])), c[9]);
  const float opy = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, c[3]),
      __fmul_rn(oy, c[4])), __fmul_rn(oz, c[5])), c[10]);
  const float opz = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, c[6]),
      __fmul_rn(oy, c[7])), __fmul_rn(oz, c[8])), c[11]);
  const float dpx = __fadd_rn(__fadd_rn(__fmul_rn(dx, c[0]),
      __fmul_rn(dy, c[1])), __fmul_rn(dz, c[2]));
  const float dpy = __fadd_rn(__fadd_rn(__fmul_rn(dx, c[3]),
      __fmul_rn(dy, c[4])), __fmul_rn(dz, c[5]));
  dpz = __fadd_rn(__fadd_rn(__fmul_rn(dx, c[6]), __fmul_rn(dy, c[7])),
                  __fmul_rn(dz, c[8]));
  const float inv = __frcp_rn(dpz);
  tt = __fmul_rn(-opz, inv);
  uu = __fadd_rn(opx, __fmul_rn(tt, dpx));
  vv = __fadd_rn(opy, __fmul_rn(tt, dpy));
}

// The acceptance test of pallas_bf.py:87-89 / 124-126, in its order:
// strict |dpz| > eps, u >= 0, v >= 0, u + v <= 1, tmin < t < tmax.
__device__ __forceinline__ bool tri_accept(float tt, float uu, float vv,
                                           float dpz, float tmin,
                                           float tmax) {
  return fabsf(dpz) > kDegenEps && uu >= 0.0f && vv >= 0.0f &&
         __fadd_rn(uu, vv) <= 1.0f && tt > tmin && tt < tmax;
}

// clusters._slab_cross's finite pseudo-inverse: +-1e12 below |d| = 1e-12
// (-0.0 gets +1e12).
__device__ __forceinline__ float pseudo_inv(float d) {
  return fabsf(d) > kDegenEps ? __frcp_rn(d) : (d < 0.f ? -1e12f : 1e12f);
}

// The slab test of kernel 4 (accel/clusters.py::_slab_cross) against one
// group box b0 = (lo x, lo y, lo z, hi x), b1 = (hi y, hi z, pad, pad) (a
// tri_groups.fused_group_boxes row): per axis t0, t1 = (box - o) * inv,
// tn = max(tn, min(t0, t1)), tf = min(tf, max(t0, t1)) from (-kSlabBig,
// kSlabBig); the ray crosses when max(tn, tmin) <= min(tf, tmax)
// (tri_groups.fused_group_admitted_plain).
__device__ __forceinline__ bool box_cross(float4 b0, float4 b1, float ox,
                                          float oy, float oz, float ivx,
                                          float ivy, float ivz, float tmin,
                                          float tmax) {
  float t0 = __fmul_rn(__fsub_rn(b0.x, ox), ivx);
  float t1 = __fmul_rn(__fsub_rn(b0.w, ox), ivx);
  float tn = fmaxf(-kSlabBig, fminf(t0, t1));
  float tf = fminf(kSlabBig, fmaxf(t0, t1));
  t0 = __fmul_rn(__fsub_rn(b0.y, oy), ivy);
  t1 = __fmul_rn(__fsub_rn(b1.x, oy), ivy);
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = __fmul_rn(__fsub_rn(b0.z, oz), ivz);
  t1 = __fmul_rn(__fsub_rn(b1.y, oz), ivz);
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  return fmaxf(tn, tmin) <= fminf(tf, tmax);
}

// core/rng.py: tea<4> seed, LCG advance + constant-shift finalizer.
__device__ __forceinline__ uint32_t tea4(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0u;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

__device__ __forceinline__ float uniform(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  uint32_t x = state;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

// Two draws whose values nothing reads (the glass pair of engine.py:536):
// the stream still advances, so it stays in step with the engine.
__device__ __forceinline__ void advance2(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  state = state * 747796405u + 2891336453u;
}

}  // namespace ort
