// Cluster-culled traversal for large meshes: the exact cull and the cluster
// walks of the resident, streaming and supercluster tiers (kernels 4-6 and
// 5c/6c of the port), and the cluster-major queue traversal (kernels 7-8).
//
// Replaces, in optix_raytracer_tpu/accel/clusters.py:
//   kernel 4  cull_exact_kernel<5, true> <- _exact_cull_kernel (:231), called
//             by _exact_block_cull (pallas_call at :312);
//   kernel 5  cluster_closest_kernel     <- _closest_kernel (:453) and
//             _closest_kernel_stream (:537), called by _closest_core (:1150);
//   kernel 6  cluster_any_kernel         <- _any_kernel (:669) and
//             _any_kernel_stream (:603), called by _any_core (:1372);
//   kernel 5c cluster_sc_closest_kernel  <- _sc_closest_kernel (:858), called
//             by _closest_core (:1150);
//   kernel 6c cluster_sc_any_kernel      <- _sc_any_kernel (:933), called by
//             _any_core (:1372);
// and in optix_raytracer_tpu/accel/qwalk.py:
//   kernel 7  cull_exact_kernel<3, false> <- _oct_cull_kernel (:69), called
//             by _oct_cull (pallas_call at :117);
//   kernel 8  qwalk_closest_kernel, qwalk_any_kernel <- _q_closest_kernel
//             (:227), _q_any_kernel (:208), called by _run_queue (:283).
//
// Rays arrive packed as [N, 8] f32 (ox oy oz dx dy dz tmin tmax) in blocks of
// kSub = 256; a cluster is 128 triangle slots whose constants are
// comp[c] = [32 rows][128 slots] f32 (accel/clusters.py ClusterSet).
//
// Kernel 4. What bounds it: FP32 issue, ~20 operations per (ray, cluster)
// pair on 32 bytes of staged ray data. Design: one CTA per 256-ray block; the
// block's rays (origin, pseudo-inverse direction, window) are staged once in
// shared memory as two float4 per ray; each thread owns clusters c = tid,
// tid + 256, ... and loops over the 256 rays, whose loads are broadcasts. The
// minimum entry and the 8 group bits need no cross-thread reduction, so the
// result is deterministic.
//
// Kernels 5 and 6. What bounds them: FP32 issue in the Woop pair tests
// (~30 operations per ray and triangle slot); a list entry moves 6 KB (any)
// or 11.5 KB (closest) of constants from L2 (25k-triangle table: 3.2 MB) or
// HBM (500k: 64 MB) into shared memory for 256 rays. Design: one CTA of 256
// threads per block, one thread per ray. Each warp is one 32-ray gate group,
// so a clear gate bit skips the cluster for the whole warp without
// divergence. For each list entry the CTA stages the cluster's test
// constants slot-major ([128][12], three 16-byte broadcast loads per slot)
// and the closest kernel also its ids and normal rows; each thread then
// tests its ray against the 128 slots in _pair_test's order of operations.
// One kernel serves the resident (<= 1024 clusters) and the streaming tier:
// the table is read through L2 either way.
//
// Kernels 5c and 6c. A list entry is a supercluster of up to 32 member
// clusters (the 4M-triangle table is 489 MiB, so member slabs come from
// HBM). What bounds them: the same pair tests, on the members that some ray
// of the block crosses (~2 of 32 on coherent primaries), plus 32 slab tests
// per ray and entry. Design: the layout of kernels 5/6; per entry the CTA
// stages the 32 member AABBs (768 B), each live thread slab-tests its ray
// against them into a uint32 (the exact cull's own test), the warps OR their
// masks (__reduce_or_sync) into one shared word (atomicOr), and the CTA pops
// the block-union mask lowest bit first (__ffs), staging and testing one
// member cluster at a time with kernels 5/6's staging and pair-test code.
// Every live ray adds its crossings to the mask, also one whose walk is
// done, so the members tested are those of the plain versions' block union.
//
// Kernel 7 is kernel 4's loop with 8-ray octet bits and no entry distance
// (one template). Kernel 8: a work list (accel/qwalk.py) puts each crossing
// (8-ray octet, cluster) pair in a step of 32 items, 256 marshalled rays of
// one cluster. What bounds it: the pair tests of kernels 5/6, 256 x 128 per
// step with no gate and no early exit, plus the marshalled rays (32 B in)
// and candidates (32 B or 4 B out) per item ray through HBM. Design: one CTA
// of 256 threads per live step, one thread per marshalled ray (planar
// [8][cols] rows, coalesced); the step's cluster is staged with kernels
// 5/6's staging and tested with their closest_step / any_step, whose tie
// rule (smaller t, or equal t at a lower slot) is _q_closest_kernel's. The
// per-ray reduction over steps is PyTorch scatter ops.
//
// Closest hit: a thread keeps one running best and replaces it when
// t < best or (t == best and slot < best slot): over the list order this
// equals the reference's per-lane running minimum with a strict `<` and its
// lowest-winning-lane pick. The walk stops early only when every ray of the
// block already holds a hit nearer than the next cluster's (truncated,
// hence lower) front-to-back bound, strictly; a warp whose rays all do skips
// its tests. Any hit: dead rays start resolved and report 0; a ray resolves
// when occluded or when the next bound passes its tmax; the CTA stops when
// every ray is resolved. Both exits leave the results of the whole-list walk
// of the plain versions unchanged.
#include "common.cuh"

namespace {

constexpr int kSub = 256;        // rays per block (clusters.py SUB)
constexpr int kLanes = 128;      // triangle slots per cluster (LANES)
constexpr int kCompRows = 32;    // constant rows per cluster
constexpr int kTestRows = 12;    // m_inv (9) + offsets (3)
constexpr int kExtRow0 = 16;     // prim, mat, n0 (3), d10 (3), d20 (3)
constexpr int kExtRows = 11;
constexpr int kMaxMembers = 32;  // clusters per supercluster, at most
constexpr float kBig = 3.0e38f;  // clusters.py _BIG
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        size_t i) {
  const float4* p = reinterpret_cast<const float4*>(rays + 8 * i);
  const float4 a = p[0], b = p[1];
  return Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// _exact_cull_kernel's finite pseudo-inverse: +-1e12 below |d| = 1e-12.
__device__ __forceinline__ float pseudo_inv(float d) {
  return fabsf(d) > ort::kDegenEps ? __frcp_rn(d) : (d < 0.f ? -1e12f : 1e12f);
}

// A ray as the slab test reads it: (ox oy oz tmin) and (1/dx 1/dy 1/dz tmax).
__device__ __forceinline__ void slab_ray(const Ray& r, float4& org,
                                         float4& inv) {
  org = make_float4(r.ox, r.oy, r.oz, r.tmin);
  inv = make_float4(pseudo_inv(r.dx), pseudo_inv(r.dy), pseudo_inv(r.dz),
                    r.tmax);
}

// The exact slab test of kernel 4 and the member test of kernels 5c/6c
// (accel/clusters.py::_slab_cross): per axis t0, t1 = (box - o) * inv in
// that rounding, tn = max(tn, min(t0, t1)), tf = min(tf, max(t0, t1)) from
// (-kBig, kBig); the ray crosses when max(tn, tmin) <= min(tf, tmax). The
// caller skips dead rays. tn is the entry distance.
__device__ __forceinline__ bool slab_cross(float lox, float loy, float loz,
                                           float hix, float hiy, float hiz,
                                           const float4& o, const float4& iv,
                                           float& tn) {
  float tf = kBig;
  tn = -kBig;
  float t0 = __fmul_rn(__fsub_rn(lox, o.x), iv.x);
  float t1 = __fmul_rn(__fsub_rn(hix, o.x), iv.x);
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = __fmul_rn(__fsub_rn(loy, o.y), iv.y);
  t1 = __fmul_rn(__fsub_rn(hiy, o.y), iv.y);
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = __fmul_rn(__fsub_rn(loz, o.z), iv.z);
  t1 = __fmul_rn(__fsub_rn(hiz, o.z), iv.z);
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  return fmaxf(tn, o.w) <= fminf(tf, iv.w);
}

// The exact cull of kernels 4 and 7: one CTA per 256-ray block, one thread
// per cluster column. Bit (j >> kShift) of the mask is set when live ray j
// crosses: 32-ray groups for kernel 4 (kShift 5), 8-ray octets for kernel 7
// (kShift 3). Kernel 4 also writes the minimum entry distance (kEntry).
template <int kShift, bool kEntry>
__global__ void __launch_bounds__(kSub)
cull_exact_kernel(const float* __restrict__ aabb, int c_pad,
                  const float* __restrict__ rays, float* __restrict__ tn_out,
                  int* __restrict__ mask_out) {
  __shared__ float4 s_org[kSub];   // ox oy oz tmin
  __shared__ float4 s_inv[kSub];   // 1/dx 1/dy 1/dz tmax
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const Ray r = load_ray(rays, b * kSub + tid);
  const bool live = r.tmax > r.tmin;
  slab_ray(r, s_org[tid], s_inv[tid]);
  const int any_live = __syncthreads_or(live);
  int* mask_row = mask_out + b * c_pad;
  for (int c = tid; c < c_pad; c += kSub) {
    float tnb = kBig;
    unsigned m = 0u;
    if (any_live) {
      const float* ab = aabb + (c / kLanes) * 6 * kLanes + (c % kLanes);
      const float lox = ab[0], loy = ab[kLanes], loz = ab[2 * kLanes];
      const float hix = ab[3 * kLanes], hiy = ab[4 * kLanes],
                  hiz = ab[5 * kLanes];
      for (int j = 0; j < kSub; ++j) {
        const float4 o = s_org[j];
        const float4 iv = s_inv[j];
        if (!(iv.w > o.w)) continue;            // dead ray: never crosses
        float tn;
        if (slab_cross(lox, loy, loz, hix, hiy, hiz, o, iv, tn)) {
          if constexpr (kEntry) tnb = fminf(tnb, fmaxf(tn, 0.f));
          m |= 1u << (j >> kShift);
        }
      }
    }
    if constexpr (kEntry) tn_out[b * c_pad + c] = tnb;
    mask_row[c] = static_cast<int>(m);
  }
}

// Stage comp[c] rows 0-11 slot-major into s_tri ([128][12] floats).
__device__ __forceinline__ void stage_test_rows(float* s_tri,
                                                const float* __restrict__ src) {
  for (int i = threadIdx.x; i < kTestRows * kLanes; i += kSub) {
    const int row = i / kLanes, slot = i % kLanes;
    s_tri[slot * kTestRows + row] = src[i];
  }
}

// The closest walk's staging: the test rows, and the ids and normal rows
// 16-26 as they are ([11][128]).
__device__ __forceinline__ void stage_closest(float* s_tri, float* s_ext,
                                              const float* __restrict__ src) {
  stage_test_rows(s_tri, src);
  for (int i = threadIdx.x; i < kExtRows * kLanes; i += kSub)
    s_ext[i] = src[kExtRow0 * kLanes + i];
}

__device__ __forceinline__ void slot_consts(const float4* s_tri4, int j,
                                            float* c) {
  const float4 a = s_tri4[3 * j], b = s_tri4[3 * j + 1],
               d = s_tri4[3 * j + 2];
  c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
  c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
  c[8] = d.x; c[9] = d.y; c[10] = d.z; c[11] = d.w;
}

// One thread's running closest hit.
struct Closest {
  float bt;
  int blane;
  float bu, bv, bnx, bny, bnz, bprim, bmat;
};

__device__ __forceinline__ Closest closest_init(const Ray& r) {
  return Closest{r.tmax, kLanes, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f, -1.f};
}

// Pair-test the thread's ray against the staged cluster's 128 slots and keep
// the better hit (smaller t, or equal t at a lower slot).
__device__ __forceinline__ void closest_step(const float* s_tri,
                                             const float* s_ext, const Ray& r,
                                             Closest& h) {
  const float4* s_tri4 = reinterpret_cast<const float4*>(s_tri);
  for (int j = 0; j < kLanes; ++j) {
    float cst[kTestRows];
    slot_consts(s_tri4, j, cst);
    float tt, uu, vv, dpz;
    ort::tri_test(cst, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, tt, uu, vv, dpz);
    if (ort::tri_accept(tt, uu, vv, dpz, r.tmin, r.tmax) &&
        (tt < h.bt || (tt == h.bt && j < h.blane))) {
      h.bt = tt;
      h.blane = j;
      h.bu = uu;
      h.bv = vv;
      const float* e = s_ext + j;
      h.bprim = e[0];
      h.bmat = e[kLanes];
      h.bnx = __fadd_rn(__fadd_rn(e[2 * kLanes], __fmul_rn(uu, e[5 * kLanes])),
                        __fmul_rn(vv, e[8 * kLanes]));
      h.bny = __fadd_rn(__fadd_rn(e[3 * kLanes], __fmul_rn(uu, e[6 * kLanes])),
                        __fmul_rn(vv, e[9 * kLanes]));
      h.bnz = __fadd_rn(__fadd_rn(e[4 * kLanes], __fmul_rn(uu, e[7 * kLanes])),
                        __fmul_rn(vv, e[10 * kLanes]));
    }
  }
}

__device__ __forceinline__ void emit_closest(float* __restrict__ out,
                                             size_t ray, const Closest& h) {
  float4* o = reinterpret_cast<float4*>(out + 8 * ray);
  o[0] = make_float4(h.bt, h.bu, h.bv, h.bnx);
  o[1] = make_float4(h.bny, h.bnz, h.bprim, h.bmat);
}

// True when the thread's ray hits one of the staged cluster's 128 slots.
__device__ __forceinline__ bool any_step(const float* s_tri, const Ray& r) {
  const float4* s_tri4 = reinterpret_cast<const float4*>(s_tri);
  for (int j = 0; j < kLanes; ++j) {
    float cst[kTestRows];
    slot_consts(s_tri4, j, cst);
    float tt, uu, vv, dpz;
    ort::tri_test(cst, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, tt, uu, vv, dpz);
    if (ort::tri_accept(tt, uu, vv, dpz, r.tmin, r.tmax)) return true;
  }
  return false;
}

// The block-union member mask of supercluster s: bit c set when some live ray
// of the block crosses member c's AABB (member[s] = [6][members] floats).
// Called by every thread of the CTA; ends with a barrier, after which the
// shared word holds the mask. The word is rewritten only after the next
// entry's opening barrier, when every thread has read it.
__device__ __forceinline__ unsigned member_mask(
    const float* __restrict__ member, int s, int members, bool live,
    const float4& org, const float4& inv, float* s_mem, unsigned* s_mask) {
  const float* src = member + static_cast<size_t>(s) * 6 * members;
  for (int i = threadIdx.x; i < 6 * members; i += kSub) s_mem[i] = src[i];
  if (threadIdx.x == 0) *s_mask = 0u;
  __syncthreads();
  unsigned m = 0u;
  if (live) {
    for (int c = 0; c < members; ++c) {
      float tn;
      if (slab_cross(s_mem[c], s_mem[members + c], s_mem[2 * members + c],
                     s_mem[3 * members + c], s_mem[4 * members + c],
                     s_mem[5 * members + c], org, inv, tn))
        m |= 1u << c;
    }
  }
  m = __reduce_or_sync(kFull, m);
  if ((threadIdx.x & 31) == 0 && m != 0u) atomicOr(s_mask, m);
  __syncthreads();
  return *s_mask;
}

__global__ void __launch_bounds__(kSub)
cluster_closest_kernel(const int* __restrict__ counts,
                       const int* __restrict__ lists,
                       const float* __restrict__ tnear,
                       const float* __restrict__ comp, int n_comp,
                       const float* __restrict__ rays, int c_pad, int gate,
                       float* __restrict__ out) {
  __shared__ __align__(16) float s_tri[kLanes * kTestRows];
  __shared__ float s_ext[kExtRows * kLanes];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const size_t ray = b * kSub + tid;
  const Ray r = load_ray(rays, ray);
  const bool dead = !(r.tmax > r.tmin);
  const int count = counts[b];
  const int* lst = lists + b * c_pad;
  const float* tnl = tnear + b * c_pad;

  Closest h = closest_init(r);
  for (int k = 0; k < count; ++k) {
    const int entry = lst[k];
    const int c = entry & 0xFFFF;
    const unsigned gm = gate ? (static_cast<unsigned>(entry) >> 16) & 0xFFu
                             : 0xFFu;
    const bool done = dead || h.bt < tnl[k];
    // Barrier before restaging; ends the walk once every ray is done.
    if (__syncthreads_and(done)) break;
    if (c >= n_comp) continue;
    stage_closest(s_tri, s_ext,
                  comp + static_cast<size_t>(c) * kCompRows * kLanes);
    __syncthreads();
    const bool warp_done = __all_sync(kFull, done);
    if (!((gm >> warp) & 1u) || warp_done) continue;
    closest_step(s_tri, s_ext, r, h);
  }
  emit_closest(out, ray, h);
}

__global__ void __launch_bounds__(kSub)
cluster_any_kernel(const int* __restrict__ counts,
                   const int* __restrict__ lists,
                   const float* __restrict__ tnear,
                   const float* __restrict__ comp, int n_comp,
                   const float* __restrict__ rays, int c_pad, int gate,
                   int* __restrict__ occ_out) {
  __shared__ __align__(16) float s_tri[kLanes * kTestRows];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const size_t ray = b * kSub + tid;
  const Ray r = load_ray(rays, ray);
  const bool dead = !(r.tmax > r.tmin);
  const int count = counts[b];
  const int* lst = lists + b * c_pad;
  const float* tnl = tnear + b * c_pad;

  bool occ = false;
  for (int k = 0; k < count; ++k) {
    const int entry = lst[k];
    const int c = entry & 0xFFFF;
    const unsigned gm = gate ? (static_cast<unsigned>(entry) >> 16) & 0xFFu
                             : 0xFFu;
    const bool resolved = dead || occ || r.tmax < tnl[k];
    if (__syncthreads_and(resolved)) break;
    if (c >= n_comp) continue;
    stage_test_rows(s_tri, comp + static_cast<size_t>(c) * kCompRows * kLanes);
    __syncthreads();
    const bool warp_done = __all_sync(kFull, resolved);
    if (!((gm >> warp) & 1u) || warp_done || resolved) continue;
    occ = any_step(s_tri, r);
  }
  occ_out[ray] = (occ && !dead) ? 1 : 0;
}

__global__ void __launch_bounds__(kSub)
cluster_sc_closest_kernel(const int* __restrict__ counts,
                          const int* __restrict__ lists,
                          const float* __restrict__ tnear,
                          const float* __restrict__ comp, int n_comp,
                          const float* __restrict__ member, int n_member_rows,
                          int members, const float* __restrict__ rays,
                          int c_pad, float* __restrict__ out) {
  __shared__ __align__(16) float s_tri[kLanes * kTestRows];
  __shared__ float s_ext[kExtRows * kLanes];
  __shared__ float s_mem[6 * kMaxMembers];
  __shared__ unsigned s_mask;
  const size_t b = blockIdx.x;
  const size_t ray = b * kSub + threadIdx.x;
  const Ray r = load_ray(rays, ray);
  const bool dead = !(r.tmax > r.tmin);
  float4 org, inv;
  slab_ray(r, org, inv);
  const int count = counts[b];
  const int* lst = lists + b * c_pad;
  const float* tnl = tnear + b * c_pad;

  Closest h = closest_init(r);
  for (int k = 0; k < count; ++k) {
    const int s = lst[k] & 0xFFFF;     // the group bits are not read
    const bool done = dead || h.bt < tnl[k];
    if (__syncthreads_and(done)) break;
    if (s >= n_member_rows) continue;
    unsigned m = member_mask(member, s, members, !dead, org, inv, s_mem,
                             &s_mask);
    const bool warp_done = __all_sync(kFull, done);
    while (m != 0u) {
      const size_t row = static_cast<size_t>(s) * members + (__ffs(m) - 1);
      m &= m - 1u;
      if (row >= static_cast<size_t>(n_comp)) break;
      __syncthreads();   // the last member's tests read s_tri / s_ext
      stage_closest(s_tri, s_ext, comp + row * kCompRows * kLanes);
      __syncthreads();
      if (!warp_done) closest_step(s_tri, s_ext, r, h);
    }
  }
  emit_closest(out, ray, h);
}

__global__ void __launch_bounds__(kSub)
cluster_sc_any_kernel(const int* __restrict__ counts,
                      const int* __restrict__ lists,
                      const float* __restrict__ tnear,
                      const float* __restrict__ comp, int n_comp,
                      const float* __restrict__ member, int n_member_rows,
                      int members, const float* __restrict__ rays, int c_pad,
                      int* __restrict__ occ_out) {
  __shared__ __align__(16) float s_tri[kLanes * kTestRows];
  __shared__ float s_mem[6 * kMaxMembers];
  __shared__ unsigned s_mask;
  const size_t b = blockIdx.x;
  const size_t ray = b * kSub + threadIdx.x;
  const Ray r = load_ray(rays, ray);
  const bool dead = !(r.tmax > r.tmin);
  float4 org, inv;
  slab_ray(r, org, inv);
  const int count = counts[b];
  const int* lst = lists + b * c_pad;
  const float* tnl = tnear + b * c_pad;

  bool occ = false;
  for (int k = 0; k < count; ++k) {
    const int s = lst[k] & 0xFFFF;
    const bool resolved = dead || occ || r.tmax < tnl[k];
    if (__syncthreads_and(resolved)) break;
    if (s >= n_member_rows) continue;
    unsigned m = member_mask(member, s, members, !dead, org, inv, s_mem,
                             &s_mask);
    const bool warp_done = __all_sync(kFull, resolved);
    while (m != 0u) {
      const size_t row = static_cast<size_t>(s) * members + (__ffs(m) - 1);
      m &= m - 1u;
      if (row >= static_cast<size_t>(n_comp)) break;
      __syncthreads();
      stage_test_rows(s_tri, comp + row * kCompRows * kLanes);
      __syncthreads();
      if (!warp_done && !resolved && !occ) occ = any_step(s_tri, r);
    }
  }
  occ_out[ray] = (occ && !dead) ? 1 : 0;
}

// Kernel 8's view of one step: its cluster, its output column block and its
// marshalled rays' column block, from steps [3][n_steps]. False for a dead
// step (output column past the last step) or an index out of range; the
// step then writes nothing. The same for every thread of the CTA.
__device__ __forceinline__ bool queue_step(const int* __restrict__ steps,
                                           int n_steps, size_t q_cols,
                                           int n_comp, int& c, int& o,
                                           int& q) {
  const int s = blockIdx.x;
  c = steps[s];
  o = steps[n_steps + s];
  q = steps[2 * n_steps + s];
  return c >= 0 && c < n_comp && o >= 0 && o < n_steps && q >= 0 &&
         static_cast<size_t>(q + 1) * kSub <= q_cols;
}

// Marshalled ray i of the planar qrays [8][q_cols].
__device__ __forceinline__ Ray load_planar(const float* __restrict__ q,
                                           size_t q_cols, size_t i) {
  return Ray{q[i], q[q_cols + i], q[2 * q_cols + i], q[3 * q_cols + i],
             q[4 * q_cols + i], q[5 * q_cols + i], q[6 * q_cols + i],
             q[7 * q_cols + i]};
}

__global__ void __launch_bounds__(kSub)
qwalk_closest_kernel(const int* __restrict__ steps, int n_steps,
                     const float* __restrict__ qrays, size_t q_cols,
                     const float* __restrict__ comp, int n_comp,
                     float* __restrict__ out) {
  __shared__ __align__(16) float s_tri[kLanes * kTestRows];
  __shared__ float s_ext[kExtRows * kLanes];
  int c, o, q;
  if (!queue_step(steps, n_steps, q_cols, n_comp, c, o, q)) return;
  const Ray r = load_planar(qrays, q_cols,
                            static_cast<size_t>(q) * kSub + threadIdx.x);
  stage_closest(s_tri, s_ext, comp + static_cast<size_t>(c) * kCompRows *
                                         kLanes);
  __syncthreads();
  Closest h = closest_init(r);
  closest_step(s_tri, s_ext, r, h);
  const size_t cols = static_cast<size_t>(n_steps) * kSub;
  float* col = out + static_cast<size_t>(o) * kSub + threadIdx.x;
  col[0] = h.bt;
  col[cols] = h.bu;
  col[2 * cols] = h.bv;
  col[3 * cols] = h.bnx;
  col[4 * cols] = h.bny;
  col[5 * cols] = h.bnz;
  col[6 * cols] = h.bprim;
  col[7 * cols] = h.bmat;
}

__global__ void __launch_bounds__(kSub)
qwalk_any_kernel(const int* __restrict__ steps, int n_steps,
                 const float* __restrict__ qrays, size_t q_cols,
                 const float* __restrict__ comp, int n_comp,
                 float* __restrict__ out) {
  __shared__ __align__(16) float s_tri[kLanes * kTestRows];
  int c, o, q;
  if (!queue_step(steps, n_steps, q_cols, n_comp, c, o, q)) return;
  const Ray r = load_planar(qrays, q_cols,
                            static_cast<size_t>(q) * kSub + threadIdx.x);
  stage_test_rows(s_tri, comp + static_cast<size_t>(c) * kCompRows * kLanes);
  __syncthreads();
  out[static_cast<size_t>(o) * kSub + threadIdx.x] =
      any_step(s_tri, r) ? 1.f : 0.f;
}

}  // namespace

extern "C" int ort_cluster_cull_exact(const float* aabb, int c_pad,
                                      const float* rays, int n_blocks,
                                      float* tn, int* gm, void* stream) {
  if (n_blocks > 0) {
    cull_exact_kernel<5, true><<<n_blocks, kSub, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        aabb, c_pad, rays, tn, gm);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ort_qwalk_oct_cull(const float* aabb, int c_pad,
                                  const float* rays, int n_blocks, int* om,
                                  void* stream) {
  if (n_blocks > 0) {
    cull_exact_kernel<3, false><<<n_blocks, kSub, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        aabb, c_pad, rays, nullptr, om);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ort_qwalk_closest(const int* steps, int n_steps,
                                 const float* qrays, long long q_cols,
                                 const float* comp, int n_comp, float* out,
                                 void* stream) {
  if (n_steps > 0) {
    qwalk_closest_kernel<<<n_steps, kSub, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        steps, n_steps, qrays, static_cast<size_t>(q_cols), comp, n_comp,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ort_qwalk_any(const int* steps, int n_steps,
                             const float* qrays, long long q_cols,
                             const float* comp, int n_comp, float* out,
                             void* stream) {
  if (n_steps > 0) {
    qwalk_any_kernel<<<n_steps, kSub, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        steps, n_steps, qrays, static_cast<size_t>(q_cols), comp, n_comp,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ort_cluster_closest(const int* counts, const int* lists,
                                   const float* tnear, const float* comp,
                                   int n_comp, const float* rays,
                                   int n_blocks, int c_pad, int gate,
                                   float* out, void* stream) {
  if (n_blocks > 0) {
    cluster_closest_kernel<<<n_blocks, kSub, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        counts, lists, tnear, comp, n_comp, rays, c_pad, gate, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ort_cluster_any(const int* counts, const int* lists,
                               const float* tnear, const float* comp,
                               int n_comp, const float* rays, int n_blocks,
                               int c_pad, int gate, int* occ, void* stream) {
  if (n_blocks > 0) {
    cluster_any_kernel<<<n_blocks, kSub, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        counts, lists, tnear, comp, n_comp, rays, c_pad, gate, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ort_cluster_sc_closest(const int* counts, const int* lists,
                                      const float* tnear, const float* comp,
                                      int n_comp, const float* member,
                                      int n_member_rows, int members,
                                      const float* rays, int n_blocks,
                                      int c_pad, float* out, void* stream) {
  if (members < 1 || members > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    cluster_sc_closest_kernel<<<n_blocks, kSub, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        counts, lists, tnear, comp, n_comp, member, n_member_rows, members,
        rays, c_pad, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ort_cluster_sc_any(const int* counts, const int* lists,
                                  const float* tnear, const float* comp,
                                  int n_comp, const float* member,
                                  int n_member_rows, int members,
                                  const float* rays, int n_blocks, int c_pad,
                                  int* occ, void* stream) {
  if (members < 1 || members > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    cluster_sc_any_kernel<<<n_blocks, kSub, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        counts, lists, tnear, comp, n_comp, member, n_member_rows, members,
        rays, c_pad, occ);
  }
  return static_cast<int>(cudaGetLastError());
}
