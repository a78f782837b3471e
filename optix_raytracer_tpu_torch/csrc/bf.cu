// Brute-force closest-hit and any-hit: every ray against every triangle.
//
// Replaces accel/pallas_bf.py::closest_hit -> _closest_kernel and
// accel/pallas_bf.py::any_hit -> _anyhit_kernel (the TPU kernels that give
// the XLA wavefront its intersections).
//
// What bounds it on the H100: FP32 issue. Each ray-triangle test is ~20
// flops and one reciprocal on 64 bytes of triangle constants that every
// thread of a block reads at the same address; a ray costs 40 bytes in and
// 36 out (closest) or 4 out (any). At 32 triangles that is ~640 flops per
// 76 bytes, so compute bounds it once the rays stream at full bandwidth.
//
// Design: one thread per ray, its running minimum in registers. The block
// stages the triangle table into shared memory in tiles of kTile triangles
// (16 floats each), so reads are broadcasts and there is no cap on the
// triangle count (the TPU kernel's 512-triangle cap was an SMEM budget).
// The ragged edges are masked by index: rays past n and triangles past m are
// never tested, and no padding lanes are made. The any-hit thread stops
// testing at its first hit. Rays arrive as [N,3] origin / direction and [N]
// tmin / tmax; outputs are t, prim, mat [N], uv [N,2], normal [N,3].
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;   // triangles per shared-memory pass: 16 KB

__device__ __forceinline__ void stage_tile(float* s_tri,
                                           const float* __restrict__ tri,
                                           int base, int cnt) {
  const float* src = tri + static_cast<size_t>(base) * 16;
  for (int k = threadIdx.x; k < cnt * 16; k += blockDim.x) s_tri[k] = src[k];
}

__global__ void __launch_bounds__(kThreads)
bf_closest_kernel(const float* __restrict__ tri,
                  const int* __restrict__ tri_mat, int m,
                  const float* __restrict__ org,
                  const float* __restrict__ dir,
                  const float* __restrict__ tmin_in,
                  const float* __restrict__ tmax_in, int n,
                  float* __restrict__ t_out, int* __restrict__ prim_out,
                  int* __restrict__ mat_out, float* __restrict__ uv_out,
                  float* __restrict__ n_out) {
  __shared__ float s_tri[kTile * 16];
  __shared__ int s_mat[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, bt = 0.f;
  if (live) {
    ox = org[3 * i]; oy = org[3 * i + 1]; oz = org[3 * i + 2];
    dx = dir[3 * i]; dy = dir[3 * i + 1]; dz = dir[3 * i + 2];
    tmin = tmin_in[i];
    bt = tmax_in[i];
  }
  int bid = -1, bmid = -1;
  float bu = 0.f, bv = 0.f, bnx = 0.f, bny = 0.f, bnz = 0.f;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();
    stage_tile(s_tri, tri, base, cnt);
    for (int k = threadIdx.x; k < cnt; k += blockDim.x)
      s_mat[k] = tri_mat[base + k];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* c = s_tri + 16 * j;
      float tt, uu, vv, dpz;
      ort::tri_test(c, ox, oy, oz, dx, dy, dz, tt, uu, vv, dpz);
      if (ort::tri_accept(tt, uu, vv, dpz, tmin, bt)) {  // running min
        bt = tt; bid = base + j; bmid = s_mat[j];
        bu = uu; bv = vv; bnx = c[12]; bny = c[13]; bnz = c[14];
      }
    }
  }
  if (!live) return;
  t_out[i] = bt;
  prim_out[i] = bid;
  mat_out[i] = bmid;
  uv_out[2 * i] = bu; uv_out[2 * i + 1] = bv;
  n_out[3 * i] = bnx; n_out[3 * i + 1] = bny; n_out[3 * i + 2] = bnz;
}

__global__ void __launch_bounds__(kThreads)
bf_any_kernel(const float* __restrict__ tri, int m,
              const float* __restrict__ org, const float* __restrict__ dir,
              const float* __restrict__ tmin_in,
              const float* __restrict__ tmax_in, int n,
              int* __restrict__ occ_out) {
  __shared__ float s_tri[kTile * 16];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = 0.f;
  if (live) {
    ox = org[3 * i]; oy = org[3 * i + 1]; oz = org[3 * i + 2];
    dx = dir[3 * i]; dy = dir[3 * i + 1]; dz = dir[3 * i + 2];
    tmin = tmin_in[i];
    tmax = tmax_in[i];
  }
  bool occ = false;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();
    stage_tile(s_tri, tri, base, cnt);
    __syncthreads();
    if (!live || occ) continue;
    for (int j = 0; j < cnt; ++j) {
      float tt, uu, vv, dpz;
      ort::tri_test(s_tri + 16 * j, ox, oy, oz, dx, dy, dz, tt, uu, vv, dpz);
      if (ort::tri_accept(tt, uu, vv, dpz, tmin, tmax)) {
        occ = true;
        break;
      }
    }
  }
  if (live) occ_out[i] = occ ? 1 : 0;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int ort_bf_closest(const float* tri, const int* tri_mat, int m,
                              const float* org, const float* dir,
                              const float* tmin, const float* tmax, int n,
                              float* t, int* prim, int* mat, float* uv,
                              float* normal, void* stream) {
  if (n > 0) {
    bf_closest_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        tri, tri_mat, m, org, dir, tmin, tmax, n, t, prim, mat, uv, normal);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ort_bf_any(const float* tri, int m, const float* org,
                          const float* dir, const float* tmin,
                          const float* tmax, int n, int* occ, void* stream) {
  if (n > 0) {
    bf_any_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        tri, m, org, dir, tmin, tmax, n, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ort_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
