// Brute-force closest-hit and any-hit: every live ray against the triangle
// table, culled by groups where the caller gives the group boxes.
//
// Replaces accel/pallas_bf.py::closest_hit -> _closest_kernel and
// accel/pallas_bf.py::any_hit -> _anyhit_kernel (the TPU kernels that give
// the XLA wavefront its intersections).
//
// What bounds it on the H100: FP32 issue and divergence where the rays are
// many, live and the table large; latency where they are few or the table
// small. With -fmad=false a ray-triangle test is ~70 SASS instructions
// (two 3x4 transforms whose products and sums are each rounded on their
// own, __frcp_rn with its range check, the uv and window tests, the
// running minimum and the three row loads); a ray moves 32 bytes in and 32
// (closest) or 1 (any: the bool plane the wrapper returns) out, 0.02-0.04
// ms a 1080p wavefront at the HBM rate. A warp runs the union of the groups its lanes admit, so on
// incoherent rays the tests a warp issues exceed the tests a ray needs
// (tools/bench_bf.py prints the needed work, brute force's and the issue
// floor per set).
//
// Design:
// - live rays only: a block stages a tile of kT rays, each warp its slice
//   of 32 kRounds rays (origin, direction, tmin, tmax) with coalesced
//   16-byte loads. A block whose rays are all live tests them in place,
//   each thread kRounds rays one after the other, with no barrier past
//   the vote. Otherwise it lists its live rays (tmax > tmin; warp ballots
//   and a prefix over the warps into shared memory) and deals them out
//   over all its threads, and a dead ray gets its miss row (t = tmax, ids
//   -1, uv = normal = 0; occluded 0) without a test: no t satisfies
//   tmin < t < tmax there.
// - few loads a test: a triangle row is read as three 16-byte loads of its
//   12 Woop constants through the read-only path: every lane of a warp
//   reads the same row, so each is one L1 broadcast, and the table (32 KB
//   at 512 rows) stays in L1 without a block staging it. The winner's t,
//   id and uv are kept in the loop; its normal and material are read once
//   at the end, and each thread stores its output row (staging the rows in
//   shared memory to store coalesced planes measured 1-7% slower).
// - group culling (tri_groups, as the fused kernel does): with boxes, the
//   table is cut into groups of `group` consecutive triangles (the
//   wrapper passes tri_groups.FUSED_GROUP), and a ray
//   tests a group's rows only when its slab test crosses the group's
//   widened box inside its window: [tmin, best t) for closest hits, [tmin,
//   tmax) for any-hit. Groups go in ascending order and rows in ascending
//   order within a group, with the strict t < best t, so the lowest index
//   still wins a tie and a skipped group holds no pair that brute force
//   would take (pallas_bf._group_walk). The any-hit ray stops at its
//   first occluder.
// Every test is ort::tri_test + ort::tri_accept, in the plain version's
// order of operations, so ids, t, uv and normals equal
// pallas_bf.closest_hit_plain's and occlusion any_hit_plain's bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 2;                 // rays a thread of the tile
constexpr int kW = 32 * kRounds;           // rays of a warp's slice
constexpr int kT = kThreads * kRounds;     // rays of the block's tile
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* tri;      // [m, 16] tri_consts, 16-byte aligned
  const int* tri_mat;    // [m]
  int m;
  const float* boxes;    // [ceil(m / group), 8] group boxes, or null
  int group;             // triangles a group (with boxes)
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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// n consecutive floats from global src to shared dst by the 32 lanes of a
// warp, 16 bytes a lane at a time where src is 16-byte aligned.
__device__ __forceinline__ void warp_load(float* dst, const float* src,
                                          int n, bool vec, int lane) {
  int done = 0;
  if (vec) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = lane; k < n4; k += 32) d4[k] = s4[k];
    done = n4 << 2;
  }
  for (int k = done + lane; k < n; k += 32) dst[k] = src[k];
}

// One row's 12 Woop constants: three 16-byte loads through the read-only
// path (every lane of a warp reads the same row: one L1 broadcast each).
__device__ __forceinline__ void load_row(const float4* row, float c[12]) {
  const float4 c0 = __ldg(row), c1 = __ldg(row + 1), c2 = __ldg(row + 2);
  c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
  c[4] = c1.x; c[5] = c1.y; c[6] = c1.z; c[7] = c1.w;
  c[8] = c2.x; c[9] = c2.y; c[10] = c2.z; c[11] = c2.w;
}

// A warp's slice of the block's tile in shared memory: kW rays as origin
// [kW, 3], direction [kW, 3], tmin [kW] and tmax [kW], laid out as the
// ray planes are.
struct Slice {
  const float* w;
  __device__ const float* o(int i) const { return w + 3 * i; }
  __device__ const float* d(int i) const { return w + 3 * kW + 3 * i; }
  __device__ float tmin(int i) const { return w[6 * kW + i]; }
  __device__ float tmax(int i) const { return w[7 * kW + i]; }
};

// The test of one ray (position i of slice sl, ray p of the batch) against
// the table, culled by the group boxes, and its output row.
template <bool kClosest>
__device__ __forceinline__ void trace(const Args& a, const Slice& sl, int i,
                                      size_t p, int n_g) {
  const float ox = sl.o(i)[0], oy = sl.o(i)[1], oz = sl.o(i)[2];
  const float dx = sl.d(i)[0], dy = sl.d(i)[1], dz = sl.d(i)[2];
  const float tmin = sl.tmin(i), tmax = sl.tmax(i);
  const bool cull = a.boxes != nullptr;
  const float4* tri4 = reinterpret_cast<const float4*>(a.tri);
  const float4* box4 = reinterpret_cast<const float4*>(a.boxes);
  const int gsize = cull ? a.group : a.m;
  float ivx = 0.f, ivy = 0.f, ivz = 0.f;
  if (cull) {
    ivx = ort::pseudo_inv(dx);
    ivy = ort::pseudo_inv(dy);
    ivz = ort::pseudo_inv(dz);
  }
  float bt = tmax, bu = 0.f, bv = 0.f;
  int bid = -1;
  bool occ = false;
  for (int g = 0, r0 = 0; g < n_g && !occ; ++g, r0 += gsize) {
    if (cull && !ort::box_cross(__ldg(box4 + 2 * g), __ldg(box4 + 2 * g + 1),
                                ox, oy, oz, ivx, ivy, ivz, tmin,
                                kClosest ? bt : tmax)) {
      continue;
    }
    const int r1 = min(r0 + gsize, a.m);
    for (int r = r0; r < r1; ++r) {
      float c[12];
      load_row(tri4 + 4 * r, c);
      float tt, uu, vv, dpz;
      ort::tri_test(c, ox, oy, oz, dx, dy, dz, tt, uu, vv, dpz);
      if constexpr (kClosest) {
        if (ort::tri_accept(tt, uu, vv, dpz, tmin, bt)) {
          bt = tt; bid = r; bu = uu; bv = vv;
        }
      } else if (ort::tri_accept(tt, uu, vv, dpz, tmin, tmax)) {
        occ = true;
        break;
      }
    }
  }
  if constexpr (kClosest) {
    float nx = 0.f, ny = 0.f, nz = 0.f;
    int mid = -1;
    if (bid >= 0) {   // the winner's normal and material, read once
      const float4 c3 = __ldg(tri4 + 4 * static_cast<size_t>(bid) + 3);
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

// The miss row of a dead ray p: no t satisfies tmin < t < tmax there.
template <bool kClosest>
__device__ __forceinline__ void miss(const Args& a, size_t p, float tmax) {
  if constexpr (kClosest) {
    a.t[p] = tmax; a.prim[p] = -1; a.mat[p] = -1;
    a.uv[2 * p] = 0.f; a.uv[2 * p + 1] = 0.f;
    a.normal[3 * p] = 0.f; a.normal[3 * p + 1] = 0.f;
    a.normal[3 * p + 2] = 0.f;
  } else {
    a.occ[p] = 0;
  }
}

template <bool kClosest>
__global__ void __launch_bounds__(kThreads) bf_kernel(const Args a) {
  __shared__ __align__(16) float s_ray[8 * kT];
  __shared__ unsigned short s_list[kT];
  __shared__ int s_cnt[kRounds * kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  // The warp stages its slice, rays [w0, w0 + cw) of the batch.
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kT;
  const size_t w0 = b0 + static_cast<size_t>(warp) * kW;
  const int cw = static_cast<int>(
      min(static_cast<long long>(kW),
          max(0LL, static_cast<long long>(a.n) -
                       static_cast<long long>(w0))));
  float* mine = s_ray + 8 * kW * warp;
  const bool vec = aligned16(a.org) && aligned16(a.dir) &&
                   aligned16(a.tmin) && aligned16(a.tmax);
  warp_load(mine, a.org + 3 * w0, 3 * cw, vec, lane);
  warp_load(mine + 3 * kW, a.dir + 3 * w0, 3 * cw, vec, lane);
  warp_load(mine + 6 * kW, a.tmin + w0, cw, vec, lane);
  warp_load(mine + 7 * kW, a.tmax + w0, cw, vec, lane);
  __syncwarp();

  const int n_g = a.boxes != nullptr ? (a.m + a.group - 1) / a.group : 1;
  // Position i = lane + 32 k of a slice. A block whose rays are all live
  // tests them in place, a warp its own slice; otherwise the block lists
  // its live rays (tile position warp * kW + i, in order) and deals them
  // out over all its threads, and the dead rays get their miss rows.
  const Slice sl{mine};
  unsigned bal[kRounds];
  bool all_live = true;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int i = lane + 32 * k;
    const bool in = i < cw;
    const bool live = in && sl.tmax(i) > sl.tmin(in ? i : 0);
    bal[k] = __ballot_sync(kFull, live);
    all_live = all_live && (live || !in);
  }
  if (__syncthreads_and(all_live)) {
#pragma unroll 1
    for (int k = 0; k < kRounds; ++k) {
      const int i = lane + 32 * k;
      if (i < cw) trace<kClosest>(a, sl, i, w0 + i, n_g);
    }
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kRounds; ++k) s_cnt[warp * kRounds + k] =
        __popc(bal[k]);
  }
  __syncthreads();
  int n_live = 0, before = 0;
#pragma unroll
  for (int j = 0; j < kRounds * kWarps; ++j) {
    n_live += s_cnt[j];
    if (j < warp * kRounds) before += s_cnt[j];
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int i = lane + 32 * k;
    if ((bal[k] >> lane) & 1u) {
      s_list[before + __popc(bal[k] & lt)] =
          static_cast<unsigned short>(warp * kW + i);
    } else if (i < cw) {
      miss<kClosest>(a, w0 + i, sl.tmax(i));
    }
    before += __popc(bal[k]);
  }
  __syncthreads();
#pragma unroll 1
  for (int e = tid; e < n_live; e += kThreads) {
    const int p = s_list[e];
    trace<kClosest>(a, Slice{s_ray + 8 * kW * (p / kW)}, p % kW, b0 + p,
                    n_g);
  }
}

template <bool kClosest>
int launch(const Args& a, void* stream) {
  if (a.n <= 0) return 0;
  if (a.boxes != nullptr && a.group < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bf_kernel<kClosest><<<(a.n + kT - 1) / kT, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ort_bf_closest(const float* tri, const int* tri_mat, int m,
                              const float* boxes, int group,
                              const float* org, const float* dir,
                              const float* tmin, const float* tmax, int n,
                              float* t, int* prim, int* mat, float* uv,
                              float* normal, void* stream) {
  Args a{tri, tri_mat, m, boxes, group, org, dir, tmin, tmax, n,
         t, prim, mat, uv, normal, nullptr};
  return launch<true>(a, stream);
}

extern "C" int ort_bf_any(const float* tri, int m, const float* boxes,
                          int group, const float* org, const float* dir,
                          const float* tmin, const float* tmax, int n,
                          uint8_t* occ, void* stream) {
  Args a{tri, nullptr, m, boxes, group, org, dir, tmin, tmax, n,
         nullptr, nullptr, nullptr, nullptr, nullptr, occ};
  return launch<false>(a, stream);
}

extern "C" const char* ort_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
