// The threaded-BVH walk: closest hit and any-hit of a ray wavefront through
// an LBVH (or the native SAH tree) in DFS order with escape pointers.
//
// Replaces no pallas_call: the JAX package walks its LBVH with an XLA
// while_loop (optix_raytracer_tpu/accel/traverse.py:51, traverse), which
// steps the whole wavefront one node a step until the slowest ray is done.
// In eager PyTorch each of those steps is ~25 ops over the wavefront and a
// 4M-triangle mesh takes thousands of steps, so the walk past the cluster
// tier's cap (4,194,304 triangles) is this kernel; the lock-step loop stays
// as its plain version (accel/traverse.py::walk_plain).
//
// What bounds it on the H100: the dependent node loads. A ray's walk is a
// chain of 32-byte node reads (and 48 bytes of Woop constants at a leaf
// whose box it hits), each waiting on the last; the FP32 work a visit (a
// 20-operation slab test, a 30-operation triangle test) is small beside
// that latency, and the rays of a warp diverge through the tree. The bound
// PERF.md gives it is the larger of those operations over 67 TFLOP/s and
// the bytes the function must move over 3.35 TB/s: the rays in and the
// hits out once, and once each node row and triangle row any ray touches
// (tools/api_probe.py::walk_parity). The tree's top is read again by
// every ray, from L2, so the kernel is latency-bound well above that
// bound.
//
// Design (a simple kernel that is right; making it fast is later work):
// - one thread a ray walks the skip pointers in registers: no stack, no
//   shared memory, the whole wavefront in one launch (the reference's
//   chunk_size guards a TPU watchdog);
// - a node is one [8] f32 row (lo, skip bits, hi, prim bits), two 16-byte
//   loads through the read-only path (__ldg); a leaf's triangle row three
//   16-byte loads of its 12 Woop constants;
// - a ray with tmax <= tmin (a dead lane) writes its miss row without a
//   walk: no t satisfies tmin < t < tmax there.
// Every sum and product is rounded on its own (_rn intrinsics) in the
// plain version's order: the slab's (box - o) * inv with inv = 1 / d_safe,
// the 3x3 products written out, t = -op_z / safe as a true division, the
// strict t < best t. A NaN slab value misses the box, as torch's minimum /
// maximum carry it. So ids, t, uv and normals equal walk_plain's bit for
// bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

struct Args {
  const float4* nodes;   // [num_nodes, 8] f32 as float4 pairs
  int num_nodes;
  const float4* tri;     // [m, 16] tri_consts as float4 quads
  const int* tri_mat;    // [m] (closest only)
  const float* org;      // [n, 3]
  const float* dir;      // [n, 3]
  const float* tmin;     // [n]
  const float* tmax;     // [n]
  int n;
  float* t;              // closest: [n]
  int* prim;             // [n]
  int* mat;              // [n]
  float* uv;             // [n, 2]
  float* normal;         // [n, 3]
  uint8_t* occ;          // any: [n] bool
};

// traverse.slab_reciprocal: 1 / d with |d| clamped to 1e-12, sign kept
// (-0.0 takes +1e-12).
__device__ __forceinline__ float slab_inv(float d) {
  const float safe = fabsf(d) < ort::kDegenEps
                         ? (d < 0.f ? -ort::kDegenEps : ort::kDegenEps)
                         : d;
  return __fdiv_rn(1.0f, safe);
}

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

template <bool kClosest>
__global__ void __launch_bounds__(kThreads) bvh_walk_kernel(const Args a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.n) return;
  const float ox = a.org[3 * p], oy = a.org[3 * p + 1],
              oz = a.org[3 * p + 2];
  const float dx = a.dir[3 * p], dy = a.dir[3 * p + 1],
              dz = a.dir[3 * p + 2];
  const float tmin = a.tmin[p], tmax = a.tmax[p];
  float bt = tmax, bu = 0.f, bv = 0.f;
  int bid = -1;
  bool occ = false;
  if (tmax > tmin) {
    const float ivx = slab_inv(dx), ivy = slab_inv(dy), ivz = slab_inv(dz);
    int ptr = 0;
    while (ptr < a.num_nodes) {
      const float4 n0 = __ldg(a.nodes + 2 * static_cast<size_t>(ptr));
      const float4 n1 = __ldg(a.nodes + 2 * static_cast<size_t>(ptr) + 1);
      const int skip = __float_as_int(n0.w);
      const int leaf = __float_as_int(n1.w);
      // the slab test against [tmin, best t]
      const float t0x = __fmul_rn(__fsub_rn(n0.x, ox), ivx);
      const float t1x = __fmul_rn(__fsub_rn(n1.x, ox), ivx);
      const float t0y = __fmul_rn(__fsub_rn(n0.y, oy), ivy);
      const float t1y = __fmul_rn(__fsub_rn(n1.y, oy), ivy);
      const float t0z = __fmul_rn(__fsub_rn(n0.z, oz), ivz);
      const float t1z = __fmul_rn(__fsub_rn(n1.z, oz), ivz);
      const bool nan = is_nan(t0x) || is_nan(t1x) || is_nan(t0y) ||
                       is_nan(t1y) || is_nan(t0z) || is_nan(t1z);
      const float t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                 fminf(t0z, t1z));
      const float t_far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                fmaxf(t0z, t1z));
      const bool box = !nan && fmaxf(t_near, tmin) <= fminf(t_far, bt);
      if (box && leaf < 0) {   // an internal node: descend
        ++ptr;
        continue;
      }
      if (box) {
        const float4* row = a.tri + 4 * static_cast<size_t>(leaf);
        const float4 c0 = __ldg(row), c1 = __ldg(row + 1),
                     c2 = __ldg(row + 2);
        const float opx = __fadd_rn(__fadd_rn(__fadd_rn(
            __fmul_rn(c0.x, ox), __fmul_rn(c0.y, oy)), __fmul_rn(c0.z, oz)),
            c2.y);
        const float opy = __fadd_rn(__fadd_rn(__fadd_rn(
            __fmul_rn(c0.w, ox), __fmul_rn(c1.x, oy)), __fmul_rn(c1.y, oz)),
            c2.z);
        const float opz = __fadd_rn(__fadd_rn(__fadd_rn(
            __fmul_rn(c1.z, ox), __fmul_rn(c1.w, oy)), __fmul_rn(c2.x, oz)),
            c2.w);
        const float dpx = __fadd_rn(__fadd_rn(__fmul_rn(c0.x, dx),
            __fmul_rn(c0.y, dy)), __fmul_rn(c0.z, dz));
        const float dpy = __fadd_rn(__fadd_rn(__fmul_rn(c0.w, dx),
            __fmul_rn(c1.x, dy)), __fmul_rn(c1.y, dz));
        const float dpz = __fadd_rn(__fadd_rn(__fmul_rn(c1.z, dx),
            __fmul_rn(c1.w, dy)), __fmul_rn(c2.x, dz));
        const bool small = fabsf(dpz) < ort::kDegenEps;
        const float safe = small ? ort::kDegenEps : dpz;
        const float tt = __fdiv_rn(-opz, safe);
        const float uu = __fadd_rn(opx, __fmul_rn(tt, dpx));
        const float vv = __fadd_rn(opy, __fmul_rn(tt, dpy));
        if (!small && uu >= 0.f && vv >= 0.f && __fadd_rn(uu, vv) <= 1.0f &&
            tt > tmin && tt < bt) {
          if constexpr (kClosest) {
            bt = tt; bid = leaf; bu = uu; bv = vv;
          } else {
            occ = true;
            break;
          }
        }
      }
      ptr = skip;
    }
  }
  if constexpr (kClosest) {
    float nx = 0.f, ny = 0.f, nz = 0.f;
    int mid = -1;
    if (bid >= 0) {   // the winner's normal and material, read once
      const float4 c3 = __ldg(a.tri + 4 * static_cast<size_t>(bid) + 3);
      nx = c3.x; ny = c3.y; nz = c3.z;
      mid = __ldg(a.tri_mat + bid);
    }
    a.t[p] = bt; a.prim[p] = bid; a.mat[p] = mid;
    a.uv[2 * p] = bu; a.uv[2 * p + 1] = bv;
    a.normal[3 * p] = nx; a.normal[3 * p + 1] = ny; a.normal[3 * p + 2] = nz;
  } else {
    a.occ[p] = occ;
  }
}

template <bool kClosest>
int launch(const Args& a, void* stream) {
  if (a.n <= 0) return 0;
  bvh_walk_kernel<kClosest><<<(a.n + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ort_bvh_closest(const float* nodes, int num_nodes,
                               const float* tri, const int* tri_mat,
                               const float* org, const float* dir,
                               const float* tmin, const float* tmax, int n,
                               float* t, int* prim, int* mat, float* uv,
                               float* normal, void* stream) {
  Args a{reinterpret_cast<const float4*>(nodes), num_nodes,
         reinterpret_cast<const float4*>(tri), tri_mat, org, dir, tmin, tmax,
         n, t, prim, mat, uv, normal, nullptr};
  return launch<true>(a, stream);
}

extern "C" int ort_bvh_any(const float* nodes, int num_nodes,
                           const float* tri, const float* org,
                           const float* dir, const float* tmin,
                           const float* tmax, int n, uint8_t* occ,
                           void* stream) {
  Args a{reinterpret_cast<const float4*>(nodes), num_nodes,
         reinterpret_cast<const float4*>(tri), nullptr, org, dir, tmin, tmax,
         n, nullptr, nullptr, nullptr, nullptr, nullptr, occ};
  return launch<false>(a, stream);
}
