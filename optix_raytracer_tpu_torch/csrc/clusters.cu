// Cluster-culled traversal for large meshes: the exact cull and the cluster
// walks of the resident, streaming and supercluster tiers (kernels 4-6 and
// 5c/6c of the port), and the cluster-major queue traversal (kernels 7-8).
//
// Replaces, in optix_raytracer_tpu/accel/clusters.py:
//   kernel 4  cull_exact_kernel<5, true, K> <- _exact_cull_kernel (:231),
//             called by _exact_block_cull (pallas_call at :312);
//   kernel 5  cluster_walk_kernel<true, false> <- _closest_kernel (:453) and
//             _closest_kernel_stream (:537), called by _closest_core (:1150);
//   kernel 6  cluster_walk_kernel<false, false> <- _any_kernel (:669) and
//             _any_kernel_stream (:603), called by _any_core (:1372);
//   kernel 5c cluster_walk_kernel<true, true> <- _sc_closest_kernel (:858),
//             called by _closest_core (:1150);
//   kernel 6c cluster_walk_kernel<false, true> <- _sc_any_kernel (:933),
//             called by _any_core (:1372);
// and in optix_raytracer_tpu/accel/qwalk.py:
//   kernel 7  cull_exact_kernel<3, false, K> <- _oct_cull_kernel (:69),
//             called by _oct_cull (pallas_call at :117);
//   kernel 8  qwalk_closest_kernel, qwalk_any_kernel <- _q_closest_kernel
//             (:227), _q_any_kernel (:208), called by _run_queue (:283).
//
// Rays arrive packed as [N, 8] f32 (ox oy oz dx dy dz tmin tmax) in blocks of
// kSub = 256; a cluster is 128 triangle slots whose constants are
// comp[c] = [32 rows][128 slots] f32 (accel/clusters.py ClusterSet).
//
// Kernels 4 and 7, the exact cull: one template, cull_exact_kernel<kShift,
// kEntry, kGroup>. Its outputs need only the (live ray, cluster) pairs whose
// slab test crosses (3.4-7.6 clusters a live ray on the 25k knot's strip
// queries), so what bounds it is bytes: the rays in, the boxes, and the
// [blocks, c_pad] tables out. A test of every ray against every column,
// as the TPU's (256, 128) tile does it, costs a live block 256 x c_pad slab
// tests and a dead ray a loop trip each. Design: one CTA per 256-ray block:
// - live rays only: the block's live rays are listed in shared memory (warp
//   ballots and a prefix over the warps); a block with none writes its
//   empty rows (kBig, 0) and exits;
// - columns in tiles of kCullTile: the tile's boxes are staged once
//   (coalesced), and consecutive columns form groups of kGroup whose box is
//   the exact min / max of their real (lo <= hi) members' boxes, built in the
//   kernel. A live ray slab-tests a group box with slab_cross and its
//   members only where that crosses. The group tests go out as units
//   (group, 32 live rays) dealt to the warps in turn, so a block of few
//   live rays still spreads them over every warp. Nothing is dropped: a
//   member box lies inside its group box, round-to-nearest is monotone and
//   the ray's reciprocal is fixed, so the ray's rounded slab interval for
//   the group box holds its interval for the member (accel/clusters.py
//   cull_admitted_pairs_plain is the plain form). An inverted box crosses
//   every live ray, so it cannot sit in a group box: the canonical padding
//   box (lo = kBig, hi = -kBig) is tested once a ray and its result applied
//   to every padding column; a group with any other inverted (or NaN)
//   member is admitted whole;
// - admitted (ray, group) pairs go to a work list in shared memory (a warp
//   ballot and one atomicAdd a warp and group), in rounds of kCullWork
//   entries; the pairs are spread over the block's 256 threads, one a
//   thread testing the group's members in turn, and merged with shared
//   atomics: atomicOr of the ray's group (kernel 4, kShift 5) or octet
//   (kernel 7, kShift 3) bit, atomicMin of the bits of max(tn, 0), since
//   non-negative floats order as their bits (a -0.0 entry is taken as
//   +0.0, as the card's torch.clamp_min gives it). OR and min are
//   order-free, so the rows are deterministic; each row is written once,
//   coalesced.
// On the H100 this reaches about a fifth of the bytes bound on dense
// blocks: a live block's chain (stage the boxes, build the group boxes,
// two barriers a round, write the rows) is latency, which six CTAs an SM
// hide only in part.

// Kernels 5 / 6 and 5c / 6c, the cluster walks: one template,
// cluster_walk_kernel<kClosest, kSc>. At the resident (<= 1024 clusters)
// and streaming (<= 8192) tiers a list entry is one 128-slot cluster, with
// 8 gate bits (one per 32-ray group) on a gated walk; at the supercluster
// tier it is a supercluster of up to 32 member clusters. The plain walks,
// like the reference, test every ray of the block (of a group whose gate
// bit is set) against every slot of each listed cluster (of each member
// some ray crosses): on the TPU a (256, 128) tile is one vector op. On this
// card that is 16x the pair tests the rays need at 25k strip bounce 1
// (gated) and 140x at 4M. Once only the pairs a ray can use are tested,
// what bounds the walks is the fixed cost of each round of list entries
// (the block's barriers, the admission slab tests, the first slab's load
// latency), then the admitted pair tests. The tables come from L2 (25k
// table: 3.2 MB) or HBM (500k: 64 MB; 4M: 489 MiB). Design:
// - rounds: the unit of admission, staging and barriers is a round: at the
//   supercluster tier one list entry (its members), at the other tiers
//   `width` consecutive list entries (accel/clusters.py WALK_WINDOW = 4),
//   so that a block whose rays need ~1.4 clusters each still fills its
//   warps. A round admits at the rays' best t as it stood at its start,
//   so wide rounds prune less: on the H100 4 entries beat 1, 2 and 8-32
//   on the main path's strip queries and the primaries (8-16 only on the
//   500k knot's shadow rays, 124 entries a block), and neither a small
//   first round nor doubling rounds did better;
// - admission: a (ray, cluster) pair is tested only when the ray is live
//   (6 / 6c: and not yet occluded), its own slab test (the exact cull's)
//   crosses the cluster's box widened by kMarginRel * extent +
//   kMarginFloor * magnitude (why that is enough: at the constants), (5 /
//   5c) that box's entry distance is not above the ray's best t at the
//   round's start, and the plain walk itself would test the pair: on a
//   gated walk the ray's group bit is set in the entry (a grazing ray whose
//   bit is clear is never tested, even where it crosses the widened box);
//   at the supercluster tier the member is in the block union (some live
//   ray's own slab test crosses it unwidened). A Woop hit lies inside the
//   widened box and its t is not below the box's entry distance, and best
//   t only falls, so the rule drops no pair of the plain walks that could
//   change a row or a flag: accel/clusters.py admitted_pairs_plain and
//   sc_admitted_pairs_plain are its plain forms, held by the CPU tests and
//   by chip_smoke.py's dropped-pair audits on the card;
// - work list: each ray first tests the widened union of the round's boxes
//   (it holds every widened box, so this drops no admitted pair); the rays
//   that cross it are listed, and their (ray, cluster) slab tests are
//   spread over the block, each admitted pair appended to its cluster's
//   list in shared memory (shared atomics; the order is free, the merge
//   below is order-free). Work items (cluster, quarter of 32 slots, 16
//   rays) go to the warps in turn, lane l testing slot 32 * quarter + l
//   against each listed ray;
// - closest hit: each ray's best is one 64-bit key in shared memory, t's
//   order-preserving bits over the slot (7 bits) over the visit (round *
//   32 + the cluster's index in the round, so list order), merged with the
//   64-bit atomicMin, so the minimum is the plain walk's winner: the
//   smaller t, then the lower slot, then the earlier visit. After the walk
//   each ray re-runs its winning pair test (the same operations, so the
//   same t, u, v bits) and reads that one slot's ids and normal rows;
// - any hit: one flag per ray in shared memory; an item skips flagged rays;
// - staging: only clusters with an admitted pair are staged, their 12 test
//   rows (6 KB, contiguous) by one 1-D bulk copy each (cp.async.bulk on an
//   mbarrier) into a ring of 2 x 2 slots in dynamic shared memory (about
//   51 KB a block, so four blocks an SM: with latency the limit, a ring of
//   2 x 4 at three blocks an SM measured 14-17% slower at 4M, one of 2 x 8
//   at two 2.5x): the next 2 clusters load while the current 2 are tested.
//   The id and normal rows are never staged. The list words are read two
//   rounds ahead and the boxes fetched one round ahead (cp.async).
// Exit: the CTA stops early only when every ray is dead (5 / 5c), or dead
// or occluded (6 / 6c); a ray's own window and best t already keep it out
// of every pair they rule out (admission). The cull's entry bound (tnear)
// must not end a walk: it covers only the rays whose own slab test crosses
// the box unwidened, so a grazing ray's hit can lie in front of it
// (tests/torch_parity.py lone_gated_rays).
//
// Kernel 7 is kernel 4 with 8-ray octet bits and no entry distance (one
// template). Kernel 8: a work list (accel/qwalk.py) puts each crossing
// (8-ray octet, cluster) pair in a step of 32 items, 256 marshalled rays of
// one cluster, and the kernel writes each marshalled ray's candidate row
// (closest) or flag (any-hit) against that cluster. The list is octet-
// granular and has padding items, so most of a step's rays cannot hit: on
// the 25k knot's strip bounce 1, 3.5x the pair tests the rays' own
// crossings need. What bounds it: the needed pair tests (30 FP32
// operations each) and the marshalled rays (32 B in, 32 B or 4 B out) per
// item ray. Design: one CTA of 256 threads a step, thread tid on lane tid:
// - admission: a ray is tested only when it is live and its own slab test
//   crosses the step's cluster box widened by the walks' margin (the rule
//   and the soundness argument of kernels 5 / 6; accel/qwalk.py
//   queue_admitted_plain is its plain form); a ray left out writes the miss
//   row (flag 0.0), as the plain version gives it there;
// - spread: the admitted rays are listed in shared memory (a warp ballot
//   and a prefix over the warps); work units (chunk of up to 16 listed
//   rays, quarter of 32 slots) go to the warps, warp w holding slot
//   32 * (w & 3) + lane in registers and taking every other chunk;
// - closest: one 64-bit key per ray, t's order-preserving bits over the
//   slot, merged by shared atomicMin (only when lower), so the minimum is
//   the plain version's winner (smaller t, then lower slot; -0.0 taken as
//   +0.0, which compare equal). Each ray with a winner re-runs that one
//   pair test (the same operations, so the same t, u, v bits) and reads
//   the slot's ids and normal rows;
// - any-hit: one flag per ray in shared memory; a unit skips flagged rays
//   (a warp owning its rays and taking the quarters in turn, so that a ray
//   stops at its first hit quarter, measured 3-11% slower on the H100);
// - staging: the step's slab loads by one bulk copy while the rays are
//   admitted: the 12 test rows (6 KB) for any-hit, rows 0-26 (13.5 KB,
//   the ids and normal rows too) for closest, which on the H100 beat
//   reading the winner's rows from the table by 3-4% (and staging them
//   with plain loads by 2%).
// The per-ray reduction over steps is PyTorch scatter ops.
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
using ort::pseudo_inv;

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

constexpr int kCullTile = 512;    // columns staged a pass (a multiple of 128)
constexpr int kCullWork = 2048;   // work-list entries a round
constexpr unsigned short kNoWork = 0xffffu;

// The canonical padding box (accel/clusters.py build_clusters, _sc_tables).
__device__ __forceinline__ bool padding_box(float lox, float loy, float loz,
                                            float hix, float hiy, float hiz) {
  return lox == kBig && loy == kBig && loz == kBig && hix == -kBig &&
         hiy == -kBig && hiz == -kBig;
}

// max(tn, 0) as bits that order as its value (-0.0 taken as +0.0).
__device__ __forceinline__ int entry_bits(float tn) {
  return __float_as_int(fmaxf(tn, 0.f)) & 0x7fffffff;
}

// The exact cull of kernels 4 and 7 (design: at the top of the file). Bit
// (lane >> kShift) of the mask is set when the block's live ray `lane`
// crosses: 32-ray groups for kernel 4 (kShift 5), 8-ray octets for kernel 7
// (kShift 3). Kernel 4 also writes the minimum entry distance (kEntry).
// kGroup columns form a group box. Six CTAs an SM (40 registers): a live
// block's chain of barriers is latency, and on the H100 six CTAs beat the
// four or five that 48-64 registers allow by 3-12% (PERF.md §6).
template <int kShift, bool kEntry, int kGroup>
__global__ void __launch_bounds__(kSub, 6)
cull_exact_kernel(const float* __restrict__ aabb, int c_pad,
                  const float* __restrict__ rays, float* __restrict__ tn_out,
                  int* __restrict__ mask_out) {
  constexpr int kGroups = kCullTile / kGroup;
  constexpr int kWarps = kSub / 32;
  static_assert(kGroups <= kSub && kGroups < 256, "one group a thread");
  __shared__ float4 s_org[kSub];              // live ray i: ox oy oz tmin
  __shared__ float4 s_inv[kSub];              // 1/dx 1/dy 1/dz tmax
  __shared__ unsigned char s_lane[kSub];      // its lane in the block
  __shared__ float s_box[6][kCullTile];       // the tile's boxes
  __shared__ float4 s_glo[kGroups];           // its group boxes' lo
  __shared__ float4 s_ghi[kGroups];           // and hi
  __shared__ unsigned char s_gkind[kGroups];  // 0 skip, 1 box, 2 whole
  __shared__ int s_tn[kCullTile];             // entry bits
  __shared__ unsigned s_m[kCullTile];         // group / octet bits
  __shared__ unsigned short s_work[kCullWork];  // group << 8 | live ray
  __shared__ int s_warp_live[kWarps];
  __shared__ int s_nwork, s_pad_tn;
  __shared__ unsigned s_pad_m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const size_t b = blockIdx.x;
  const Ray r = load_ray(rays, b * kSub + tid);
  const bool live = r.tmax > r.tmin;
  const unsigned ballot = __ballot_sync(kFull, live);
  if (lane == 0) s_warp_live[warp] = __popc(ballot);
  if (tid == 0) {
    s_pad_tn = __float_as_int(kBig);
    s_pad_m = 0u;
  }
  __syncthreads();
  int n_live = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp_live[w] : 0;
    n_live += s_warp_live[w];
  }
  float* tn_row = kEntry ? tn_out + b * c_pad : nullptr;
  int* m_row = mask_out + b * c_pad;
  if (n_live == 0) {
    for (int c = tid; c < c_pad; c += kSub) {
      if constexpr (kEntry) tn_row[c] = kBig;
      m_row[c] = 0;
    }
    return;
  }
  if (live) {
    float4 org, inv;
    slab_ray(r, org, inv);
    const int i = before + __popc(ballot & lt);
    s_org[i] = org;
    s_inv[i] = inv;
    s_lane[i] = static_cast<unsigned char>(tid);
    float tn;   // the padding box, once a ray
    if (slab_cross(kBig, kBig, kBig, -kBig, -kBig, -kBig, org, inv, tn)) {
      atomicOr(&s_pad_m, 1u << (tid >> kShift));
      if constexpr (kEntry) atomicMin(&s_pad_tn, entry_bits(tn));
    }
  }
  // The group pass: units (group g, chunk of 32 live rays), chunk-minor,
  // dealt to the warps in turn, so a block of few live rays spreads its
  // group tests over every warp; a warp keeps its chunk's rays in
  // registers while the chunk stays the same.
  const int n_chunks = (n_live + 31) >> 5;
  const int dg = kWarps / n_chunks, dc = kWarps % n_chunks;
  for (int base = 0; base < c_pad; base += kCullTile) {
    const int cols = min(kCullTile, c_pad - base);
    const int n_groups = cols / kGroup;
    // aabb is [c_pad / 128][6][128]: the tile's rows are contiguous.
    const float* src = aabb + static_cast<size_t>(base) * 6;
    for (int i = tid; i < 6 * cols; i += kSub) {
      const int row = i / (6 * kLanes), rem = i % (6 * kLanes);
      s_box[rem / kLanes][row * kLanes + rem % kLanes] = src[i];
    }
    for (int c = tid; c < cols; c += kSub) {
      s_tn[c] = __float_as_int(kBig);
      s_m[c] = 0u;
    }
    __syncthreads();
    if (tid < n_groups) {
      float lx = kBig, ly = kBig, lz = kBig;
      float hx = -kBig, hy = -kBig, hz = -kBig;
      int kind = 0;
      for (int m = 0; m < kGroup; ++m) {
        const int c = tid * kGroup + m;
        const float blx = s_box[0][c], bly = s_box[1][c], blz = s_box[2][c];
        const float bhx = s_box[3][c], bhy = s_box[4][c], bhz = s_box[5][c];
        if (padding_box(blx, bly, blz, bhx, bhy, bhz)) continue;
        if (blx <= bhx && bly <= bhy && blz <= bhz) {
          kind = max(kind, 1);
          lx = fminf(lx, blx);
          ly = fminf(ly, bly);
          lz = fminf(lz, blz);
          hx = fmaxf(hx, bhx);
          hy = fmaxf(hy, bhy);
          hz = fmaxf(hz, bhz);
        } else {
          kind = 2;
        }
      }
      s_glo[tid] = make_float4(lx, ly, lz, 0.f);
      s_ghi[tid] = make_float4(hx, hy, hz, 0.f);
      s_gkind[tid] = static_cast<unsigned char>(kind);
    }
    int g = warp / n_chunks, chunk = warp % n_chunks;  // the warp's unit
    int held = -1;                                    // chunk in registers
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f), iv = o;
    bool more;
    do {
      for (int i = tid; i < kCullWork; i += kSub) s_work[i] = kNoWork;
      if (tid == 0) s_nwork = 0;
      __syncthreads();
      for (; g < n_groups; g += dg, chunk += dc) {
        if (chunk >= n_chunks) {
          chunk -= n_chunks;
          ++g;
          if (g >= n_groups) break;
        }
        const int kind = s_gkind[g];
        if (kind == 0) continue;
        const int ri = chunk * 32 + lane;
        if (chunk != held) {
          held = chunk;
          if (ri < n_live) {
            o = s_org[ri];
            iv = s_inv[ri];
          }
        }
        bool adm = false;
        if (ri < n_live) {
          if (kind == 2) {
            adm = true;
          } else {
            const float4 glo = s_glo[g], ghi = s_ghi[g];
            float tn;
            adm = slab_cross(glo.x, glo.y, glo.z, ghi.x, ghi.y, ghi.z, o, iv,
                             tn);
          }
        }
        const unsigned bal = __ballot_sync(kFull, adm);
        if (bal == 0u) continue;
        int at = 0;
        if (lane == 0) at = atomicAdd(&s_nwork, __popc(bal));
        at = __shfl_sync(kFull, at, 0);
        if (at + __popc(bal) > kCullWork) break;   // retry next round
        if (adm)
          s_work[at + __popc(bal & lt)] =
              static_cast<unsigned short>((g << 8) | ri);
      }
      __syncthreads();
      // The member pass: one admitted (ray, group) a thread, its kGroup
      // members in turn.
      const int n_items = min(s_nwork, kCullWork);
      for (int it = tid; it < n_items; it += kSub) {
        const unsigned w = s_work[it];
        if (w == kNoWork) continue;
        const int c0 = static_cast<int>(w >> 8) * kGroup;
        const int ri = static_cast<int>(w & 0xffu);
        const float4 ro = s_org[ri], rv = s_inv[ri];
        const unsigned bit = 1u << (s_lane[ri] >> kShift);
        for (int c = c0; c < c0 + kGroup; ++c) {
          const float lox = s_box[0][c], loy = s_box[1][c],
                      loz = s_box[2][c];
          const float hix = s_box[3][c], hiy = s_box[4][c],
                      hiz = s_box[5][c];
          if (padding_box(lox, loy, loz, hix, hiy, hiz)) continue;
          float tn;
          if (slab_cross(lox, loy, loz, hix, hiy, hiz, ro, rv, tn)) {
            if (!(s_m[c] & bit)) atomicOr(&s_m[c], bit);
            if constexpr (kEntry) {
              const int eb = entry_bits(tn);
              if (eb < s_tn[c]) atomicMin(&s_tn[c], eb);
            }
          }
        }
      }
      more = __syncthreads_or(g < n_groups);
    } while (more);
    for (int c = tid; c < cols; c += kSub) {
      const bool pad = padding_box(s_box[0][c], s_box[1][c], s_box[2][c],
                                   s_box[3][c], s_box[4][c], s_box[5][c]);
      if constexpr (kEntry)
        tn_row[base + c] = __int_as_float(pad ? s_pad_tn : s_tn[c]);
      m_row[base + c] = static_cast<int>(pad ? s_pad_m : s_m[c]);
    }
    __syncthreads();
  }
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

// A winner's ids and unnormalised normal n0 + u * d10 + v * d20 (the plain
// walks' order) from its slot's rows 16-26 (e: row 16; rows kLanes apart).
__device__ __forceinline__ void winner_ext(const float* __restrict__ e,
                                           Closest& h) {
  h.bprim = e[0];
  h.bmat = e[kLanes];
  const float u = h.bu, v = h.bv;
  h.bnx = __fadd_rn(__fadd_rn(e[2 * kLanes], __fmul_rn(u, e[5 * kLanes])),
                    __fmul_rn(v, e[8 * kLanes]));
  h.bny = __fadd_rn(__fadd_rn(e[3 * kLanes], __fmul_rn(u, e[6 * kLanes])),
                    __fmul_rn(v, e[9 * kLanes]));
  h.bnz = __fadd_rn(__fadd_rn(e[4 * kLanes], __fmul_rn(u, e[7 * kLanes])),
                    __fmul_rn(v, e[10 * kLanes]));
}

__device__ __forceinline__ void emit_closest(float* __restrict__ out,
                                             size_t ray, const Closest& h) {
  float4* o = reinterpret_cast<float4*>(out + 8 * ray);
  o[0] = make_float4(h.bt, h.bu, h.bv, h.bnx);
  o[1] = make_float4(h.bny, h.bnz, h.bprim, h.bmat);
}

// ---------------------------------------------------------------------------
// Kernels 5 / 6 and 5c / 6c: the cluster walks (see the note at the head).
// ---------------------------------------------------------------------------

// The pair admission margin (accel/clusters.py SC_MARGIN_REL,
// SC_MARGIN_FLOOR): a cluster box is widened on every side by
// extent * kMarginRel + magnitude * kMarginFloor (extent its largest side,
// magnitude its largest |coordinate|). Why it is enough: a Woop test that
// accepts a hit puts it within a few ulps of the triangle, which lies in
// the unwidened box, and the f32 slab test errs by a few ulps of the
// distance along the ray; the floor, 2^9 ulps of the box's largest
// coordinate, covers both for rays that start in the scene, and the
// relative term, 1/64 of the box, the Woop test's error growth on thin
// triangles. Powers of two, so the scaling is exact and the plain forms
// (`admitted_pairs_plain`, `sc_admitted_pairs_plain`) round as the kernel
// does.
constexpr float kMarginRel = 0.015625f;         // 2^-6
constexpr float kMarginFloor = 6.103515625e-05f; // 2^-14
constexpr int kWin = 2;                  // cluster slabs per window
constexpr int kRing = 2 * kWin;          // one window tested, one loading
constexpr int kChunk = 16;               // rays per work item
constexpr unsigned kSlabBytes = kTestRows * kLanes * sizeof(float);  // 6 KB
constexpr int kWarps = kSub / 32;

struct WalkShared {
  float slab[kRing][kTestRows * kLanes];  // cluster test rows, [12][128] each
  float4 ray[kSub][2];                    // ox oy oz dx, dy dz tmin tmax
  float4 inv[kSub];                       // 1/dx 1/dy 1/dz (pseudo), tmax
  unsigned long long key[kSub];           // 5 / 5c: each ray's best key
  int occ[kSub];                          // 6 / 6c: each ray's occlusion flag
  float raw[2][6][kMaxMembers];           // the round's boxes, fetched ahead
  float box[6][kMaxMembers];              // the round's boxes
  float wbox[6][kMaxMembers];             // the same, widened
  float sc_box[6];                        // their union's, widened
  int cnt[kMaxMembers];                   // admitted rays per cluster
  unsigned char list[kMaxMembers][kSub];  // their ids, cluster-major
  unsigned char open[kSub];               // rays that cross sc_box
  int n_open;
  unsigned long long bar[kRing];          // one mbarrier per ring slot
  unsigned real;                          // clusters that hold a triangle
  unsigned in_union[2];                   // 5c / 6c: members a live ray crosses
  int cid[kMaxMembers];                   // 5 / 6: each entry's cluster
  unsigned gm[kMaxMembers];               // 5 / 6: each entry's gate bits
  unsigned gor;                           // 5 / 6: their union
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Ring slot i's next cluster slab: comp[row] rows 0-11 (6 KB, contiguous;
// kernel 8's closest variant rows 0-26) in one bulk copy that completes on
// the slot's mbarrier.
__device__ __forceinline__ void bulk_load_slab(float* dst,
                                               const float* __restrict__ src,
                                               unsigned long long* bar,
                                               unsigned bytes = kSlabBytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// t's order-preserving bits (after -0 -> +0), and back.
__device__ __forceinline__ unsigned t_bits(float t) {
  const unsigned u = __float_as_uint(__fadd_rn(t, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float bits_t(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A box (lo, hi) widened by the admission margin into dst[0..5 * stride]
// (rows lo xyz, hi xyz), in the order of sc_widened_boxes.
__device__ __forceinline__ void widen_box(const float* lo, const float* hi,
                                          float* dst, int stride) {
  const float ext = fmaxf(fmaxf(__fsub_rn(hi[0], lo[0]),
                                __fsub_rn(hi[1], lo[1])),
                          __fsub_rn(hi[2], lo[2]));
  const float mag = fmaxf(fmaxf(fmaxf(fabsf(lo[0]), fabsf(hi[0])),
                                fmaxf(fabsf(lo[1]), fabsf(hi[1]))),
                          fmaxf(fabsf(lo[2]), fabsf(hi[2])));
  const float m = __fadd_rn(__fmul_rn(ext, kMarginRel),
                            __fmul_rn(mag, kMarginFloor));
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    dst[a * stride] = __fsub_rn(lo[a], m);
    dst[(3 + a) * stride] = __fadd_rn(hi[a], m);
  }
}

// Warp 0's asynchronous fetch of a round's boxes into dst, one commit group
// a call (empty where `valid` is false), so the next round's boxes arrive
// while this one is walked: lane l copies the box whose six rows start at
// src and lie `stride` floats apart (a supercluster's member boxes
// member[s] = [6][members], or a cluster's column of aabb [rows][6][128]).
__device__ __forceinline__ void fetch_boxes(float (*dst)[kMaxMembers],
                                            const float* __restrict__ src,
                                            int stride, bool valid,
                                            int lane) {
  if (valid) {
#pragma unroll
    for (int a = 0; a < 6; ++a)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   :: "r"(smem_u32(&dst[a][lane])), "l"(src + a * stride)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The index of the n-th set bit of m (n < popc(m)).
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1u;
  return __ffs(m) - 1;
}

// One CTA per 256-ray block, for the four walks: kClosest (5 / 5c, else
// 6 / 6c) and kSc (the supercluster tier, 5c / 6c). A round is the unit of
// admission: at the supercluster tier one list entry, whose `width` member
// clusters are the round's clusters; at the resident and streaming tiers
// `width` consecutive list entries, one cluster each. Cluster j of round k
// is visit k * 32 + j.
template <bool kClosest, bool kSc>
__global__ void __launch_bounds__(kSub, 4)
cluster_walk_kernel(const int* __restrict__ counts,
                    const int* __restrict__ lists,
                    const float* __restrict__ comp, int n_comp,
                    const float* __restrict__ boxes, int n_box_rows,
                    int width, const float* __restrict__ rays,
                    int c_pad, int gate, float* __restrict__ out,
                    int* __restrict__ occ_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WalkShared& sh = *reinterpret_cast<WalkShared*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const size_t ray = b * kSub + tid;
  const Ray r = load_ray(rays, ray);
  const bool dead = !(r.tmax > r.tmin);
  float4 org, inv;
  slab_ray(r, org, inv);
  sh.ray[tid][0] = make_float4(r.ox, r.oy, r.oz, r.dx);
  sh.ray[tid][1] = make_float4(r.dy, r.dz, r.tmin, r.tmax);
  sh.inv[tid] = inv;
  if constexpr (kClosest)
    sh.key[tid] = (static_cast<unsigned long long>(t_bits(r.tmax)) << 32) |
                  0xffffffffull;
  else
    sh.occ[tid] = 0;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(&sh.bar[i])), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  unsigned parity = 0u;     // bit i: the phase ring slot i completes next
  const int count = counts[b];
  const int* lst = lists + b * c_pad;
  const int rounds = kSc ? count : (count + width - 1) / width;

  // The list word each thread holds for a round: the round's supercluster
  // (5c / 6c; its group bits are not read), or its lane's entry of the
  // round (5 / 6, warp 0 only; -1 past the round or the list). Words are
  // read two rounds ahead and the boxes fetched one round ahead (cp.async),
  // so neither is a round trip on a round's critical path.
  auto word_of = [&](int k) {
    if constexpr (kSc) return lst[k] & 0xFFFF;
    const int p = k * width + lane;
    return warp == 0 && lane < width && p < count ? lst[p] : -1;
  };
  auto fetch_round = [&](int k, int w) {
    if constexpr (kSc)
      fetch_boxes(sh.raw[k & 1],
                  boxes + static_cast<size_t>(w) * 6 * width + lane, width,
                  k < rounds && lane < width && w < n_box_rows, lane);
    else
      fetch_boxes(sh.raw[k & 1],
                  boxes + static_cast<size_t>((w & 0xFFFF) >> 7) * 6 * kLanes +
                      (w & 127),
                  kLanes, k < rounds && w >= 0 && (w & 0xFFFF) < n_comp,
                  lane);
  };
  int w_a = rounds > 0 ? word_of(0) : 0;
  int w_b = rounds > 1 ? word_of(1) : 0;
  if (warp == 0 && rounds > 0) fetch_round(0, w_a);

  for (int k = 0; k < rounds; ++k) {
    const int w = w_a;
    w_a = w_b;
    if (k + 2 < rounds) w_b = word_of(k + 2);
    // The previous round's work items ended at a barrier, so the shared
    // best and flag are final here. The barrier also ends the round's
    // reads of the shared lists before warp 0 rewrites them.
    float best = 0.f;
    bool done;
    if constexpr (kClosest) {
      best = bits_t(static_cast<unsigned>(sh.key[tid] >> 32));
      done = dead;
    } else {
      done = dead || sh.occ[tid] != 0;
    }
    if (__syncthreads_and(done)) break;
    if (warp == 0)   // round k + 1's boxes (an empty group past the list)
      fetch_round(k + 1, w_a);
    if constexpr (kSc) {
      if (w >= n_box_rows) continue;
    }

    // The round's boxes and their union's, each widened by the admission
    // margin (warp 0, one lane per cluster); 5 / 6 also each entry's
    // cluster and gate bits.
    if (warp == 0) {
      asm volatile("cp.async.wait_group 1;" ::: "memory");   // round k's
      bool real = false;
      float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
      if (lane < width) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = sh.raw[k & 1][a][lane];
          hi[a] = sh.raw[k & 1][3 + a][lane];
        }
        if constexpr (kSc)
          real = lo[0] <= hi[0] && lo[1] <= hi[1] && lo[2] <= hi[2] &&
                 static_cast<size_t>(w) * width + lane <
                     static_cast<size_t>(n_comp);
        else
          real = w >= 0 && (w & 0xFFFF) < n_comp && lo[0] <= hi[0] &&
                 lo[1] <= hi[1] && lo[2] <= hi[2];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          sh.box[a][lane] = lo[a];
          sh.box[3 + a][lane] = hi[a];
        }
        widen_box(lo, hi, &sh.wbox[0][lane], kMaxMembers);
      }
      const unsigned rm = __ballot_sync(kFull, real);
      if constexpr (!kSc) {
        const unsigned g =
            !real ? 0u : gate ? (static_cast<unsigned>(w) >> 16) & 0xFFu
                              : 0xFFu;
        sh.cid[lane] = w & 0xFFFF;
        sh.gm[lane] = g;
        const unsigned gor = __reduce_or_sync(kFull, g);
        if (lane == 0) sh.gor = gor;
      }
      // The union of the real boxes: it holds every widened box (the
      // margin grows with the extent and the magnitude, and every rounding
      // is monotone), so a ray whose slab test misses it misses them all;
      // the pre-test drops no admitted pair.
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float l = real ? lo[a] : kBig, h = real ? hi[a] : -kBig;
        for (int d = 16; d > 0; d >>= 1) {
          l = fminf(l, __shfl_xor_sync(kFull, l, d));
          h = fmaxf(h, __shfl_xor_sync(kFull, h, d));
        }
        lo[a] = l;
        hi[a] = h;
      }
      if (lane == 0) {
        widen_box(lo, hi, sh.sc_box, 1);
        sh.real = rm;
        sh.n_open = 0;
        sh.in_union[0] = sh.in_union[1] = 0u;
      }
      if (lane < kMaxMembers) sh.cnt[lane] = 0;
    }
    __syncthreads();

    // The pair admission rule, first against the union (one slab test per
    // ray; the rays that cross it are listed), then per (listed ray,
    // cluster) pair spread over the block, each admitted pair appended to
    // its cluster's list (their order is free: the merge is). On a gated
    // walk (5 / 6) a ray is tested only where its 32-ray group's bit is
    // set, as in the plain walks. At the supercluster tier a member is
    // walked only when some live ray's own slab test crosses its box, as in
    // the plain walks: an admitted ray that crosses it says so; for a
    // member none of them does, every ray of the block is asked.
    const unsigned rm = sh.real;
    {
      bool open = !dead && rm != 0u;
      if constexpr (!kSc) open = open && ((sh.gor >> warp) & 1u);
      if constexpr (!kClosest) open = open && sh.occ[tid] == 0;
      float tn;
      if (open && slab_cross(sh.sc_box[0], sh.sc_box[1], sh.sc_box[2],
                             sh.sc_box[3], sh.sc_box[4], sh.sc_box[5], org,
                             inv, tn) &&
          (!kClosest || tn <= best))
        sh.open[atomicAdd(&sh.n_open, 1)] = static_cast<unsigned char>(tid);
    }
    __syncthreads();
    const int n_pairs = sh.n_open * width;
    for (int i = tid; i < n_pairs; i += kSub) {
      const int oi = i / width, c = i - oi * width;
      if (!((rm >> c) & 1u)) continue;
      const int rid = sh.open[oi];
      if constexpr (!kSc) {
        if (!((sh.gm[c] >> (rid >> 5)) & 1u)) continue;
      }
      const float4 ra = sh.ray[rid][0], rb = sh.ray[rid][1];
      float tn;
      const float4 o4 = make_float4(ra.x, ra.y, ra.z, rb.z);
      if (slab_cross(sh.wbox[0][c], sh.wbox[1][c], sh.wbox[2][c],
                     sh.wbox[3][c], sh.wbox[4][c], sh.wbox[5][c], o4,
                     sh.inv[rid], tn) &&
          (!kClosest ||
           tn <= bits_t(static_cast<unsigned>(sh.key[rid] >> 32)))) {
        sh.list[c][atomicAdd(&sh.cnt[c], 1)] = static_cast<unsigned char>(rid);
        if constexpr (kSc) {
          if (slab_cross(sh.box[0][c], sh.box[1][c], sh.box[2][c],
                         sh.box[3][c], sh.box[4][c], sh.box[5][c], o4,
                         sh.inv[rid], tn))
            atomicOr(&sh.in_union[0], 1u << c);
        }
      }
    }
    __syncthreads();
    // The walked clusters: admitted (and, 5c / 6c, in the block union),
    // every thread alike.
    unsigned um = __ballot_sync(kFull, lane < width && sh.cnt[lane] > 0);
    if constexpr (kSc) {
      const unsigned ask = um & ~sh.in_union[0];
      if (ask != 0u) {
        if (!dead) {
          for (unsigned m = ask; m != 0u; m &= m - 1u) {
            const int c = __ffs(m) - 1;
            float tn;
            if (slab_cross(sh.box[0][c], sh.box[1][c], sh.box[2][c],
                           sh.box[3][c], sh.box[4][c], sh.box[5][c], org,
                           inv, tn))
              atomicOr(&sh.in_union[1], 1u << c);
          }
        }
        __syncthreads();
      }
      um &= sh.in_union[0] | sh.in_union[1];
    }
    const int nu = __popc(um);
    // Cluster j of the round: its constants in the table.
    const float* sc_src = comp + static_cast<size_t>(w) * width *
                                     kCompRows * kLanes;
    auto slab_src = [&](int j) {
      return kSc ? sc_src + static_cast<size_t>(j) * kCompRows * kLanes
                 : comp + static_cast<size_t>(sh.cid[j]) * kCompRows * kLanes;
    };

    // Windows of kWin clusters: window v is tested from ring half v & 1
    // while window v + 1 loads into the other.
    if (tid == 0) {
      for (int j = 0; j < kWin && j < nu; ++j)
        bulk_load_slab(sh.slab[j], slab_src(nth_bit(um, j)), &sh.bar[j]);
    }
    for (int v = 0; v * kWin < nu; ++v) {
      const int half = (v & 1) * kWin;
      if (tid == 0) {
        const int nxt = (v + 1) * kWin, other = kWin - half;
        for (int j = 0; j < kWin && nxt + j < nu; ++j)
          bulk_load_slab(sh.slab[other + j], slab_src(nth_bit(um, nxt + j)),
                         &sh.bar[other + j]);
      }
      // The window's clusters: index in the round, first list position,
      // rays, work items.
      int mc[kWin], mbeg[kWin], mn[kWin], mitems[kWin];
      int total = 0;
#pragma unroll
      for (int j = 0; j < kWin; ++j) {
        const int i = v * kWin + j;
        mc[j] = i < nu ? nth_bit(um, i) : 0;
        mbeg[j] = mc[j] * kSub;
        mn[j] = i < nu ? sh.cnt[mc[j]] : 0;
        mitems[j] = 4 * ((mn[j] + kChunk - 1) / kChunk);
        total += mitems[j];
        if (i < nu) {
          mbar_wait(&sh.bar[half + j], (parity >> (half + j)) & 1u);
          parity ^= 1u << (half + j);
        }
      }
      // Work items: (cluster, quarter of 32 slots, chunk of kChunk rays),
      // one per warp at a time; lane l tests slot 32 * quarter + l.
      for (int it = warp; it < total; it += kWarps) {
        // Item it → the window's j-th cluster (constant indices only, so
        // the window's arrays stay in registers).
        int j = 0, local = it, beg = mbeg[0], n = mn[0], c = mc[0];
#pragma unroll
        for (int q = 0; q + 1 < kWin; ++q) {
          if (j == q && local >= mitems[q]) {
            local -= mitems[q];
            j = q + 1;
            beg = mbeg[q + 1];
            n = mn[q + 1];
            c = mc[q + 1];
          }
        }
        const int slot = 32 * (local & 3) + lane;
        const float* sl = sh.slab[half + j];
        float cst[kTestRows];
#pragma unroll
        for (int q = 0; q < kTestRows; ++q) cst[q] = sl[q * kLanes + slot];
        const int p0 = beg + (local >> 2) * kChunk;
        const int p1 = min(p0 + kChunk, beg + n);
        const unsigned lo_key = (static_cast<unsigned>(slot) << 25) |
                                static_cast<unsigned>(k * 32 + c);
        for (int p = p0; p < p1; ++p) {
          const int rid = (&sh.list[0][0])[p];
          if constexpr (!kClosest) {
            if (sh.occ[rid]) continue;
          }
          const float4 ra = sh.ray[rid][0], rb = sh.ray[rid][1];
          float tt, uu, vv, dpz;
          ort::tri_test(cst, ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, tt, uu, vv,
                        dpz);
          if (ort::tri_accept(tt, uu, vv, dpz, rb.z, rb.w)) {
            if constexpr (kClosest)
              atomicMin(&sh.key[rid],
                        (static_cast<unsigned long long>(t_bits(tt)) << 32) |
                            lo_key);
            else
              sh.occ[rid] = 1;
          }
        }
      }
      __syncthreads();
    }
  }

  asm volatile("cp.async.wait_all;" ::: "memory");
  if constexpr (kClosest) {
    // The winner's row: its pair test again (the same operations, so the
    // same t, u, v bits), its ids and normal rows read from the table.
    const unsigned long long key = sh.key[tid];
    const unsigned lo_key = static_cast<unsigned>(key);
    if (lo_key == 0xffffffffu) {
      emit_closest(out, ray, closest_init(r));
    } else {
      const int visit = lo_key & 0x1ffffff;
      const int slot = lo_key >> 25;
      const size_t row =
          kSc ? static_cast<size_t>(lst[visit >> 5] & 0xFFFF) * width +
                    (visit & 31)
              : static_cast<size_t>(
                    lst[(visit >> 5) * width + (visit & 31)] & 0xFFFF);
      const float* e = comp + row * kCompRows * kLanes + slot;
      float cst[kTestRows];
#pragma unroll
      for (int q = 0; q < kTestRows; ++q) cst[q] = e[q * kLanes];
      Closest h = closest_init(r);
      float dpz;
      ort::tri_test(cst, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, h.bt, h.bu, h.bv,
                    dpz);
      winner_ext(e + kExtRow0 * kLanes, h);
      emit_closest(out, ray, h);
    }
  } else {
    occ_out[ray] = (sh.occ[tid] != 0 && !dead) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// Kernel 8: the queue (see the note at the head).
// ---------------------------------------------------------------------------

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

constexpr unsigned long long kNoKey = ~0ull;

// Kernel 8, closest (kClosest) or any-hit: one CTA a step, thread tid on
// lane tid. The step's cluster slab (the test rows; closest: rows 0-26,
// with the ids and normal rows) loads by one bulk copy while the rays are
// admitted. Five CTAs an SM (48 registers): on the H100 they beat four (54
// registers) by 2-4% on every set, and one step a CTA beat a loop over two
// or four (the next slab loading while a step is tested) by 7-12%
// (PERF.md §6).
template <bool kClosest>
__global__ void __launch_bounds__(kSub, 5)
qwalk_kernel(const int* __restrict__ steps, int n_steps,
             const float* __restrict__ qrays, size_t q_cols,
             const float* __restrict__ comp, int n_comp,
             const float* __restrict__ aabb, float* __restrict__ out) {
  constexpr int kRows = kClosest ? kExtRow0 + kExtRows : kTestRows;
  constexpr unsigned kBytes = kRows * kLanes * sizeof(float);
  __shared__ __align__(128) float s_slab[kRows * kLanes];
  __shared__ float4 s_ray[kSub][2];     // admitted ray i: ox oy oz dx,
                                        // dy dz tmin tmax
  __shared__ unsigned long long s_key[kClosest ? kSub : 1];  // its best key
  __shared__ int s_occ[kClosest ? 1 : kSub];                 // its flag
  __shared__ int s_warp[kWarps];        // admitted rays per warp
  __shared__ unsigned long long s_bar;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int c, o, q;
  if (!queue_step(steps, n_steps, q_cols, n_comp, c, o, q)) return;
  const float* src = comp + static_cast<size_t>(c) * kCompRows * kLanes;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(&s_bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_load_slab(s_slab, src, &s_bar, kBytes);
  }
  // Admission: live, and the ray's own slab test crosses the cluster's box
  // widened by the margin (a box that is not real admits every live ray).
  // A Woop hit lies in the widened box, so a ray left out has no hit here
  // and writes the miss row, as the plain version gives it.
  const Ray r = load_planar(qrays, q_cols,
                            static_cast<size_t>(q) * kSub + tid);
  const float* bx =
      aabb + static_cast<size_t>(c >> 7) * 6 * kLanes + (c & (kLanes - 1));
  float lo[3], hi[3], wb[6];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = bx[a * kLanes];
    hi[a] = bx[(3 + a) * kLanes];
  }
  const bool real = lo[0] <= hi[0] && lo[1] <= hi[1] && lo[2] <= hi[2];
  widen_box(lo, hi, wb, 1);
  float4 org, inv;
  slab_ray(r, org, inv);
  float tn;
  const bool adm =
      r.tmax > r.tmin &&
      (!real ||
       slab_cross(wb[0], wb[1], wb[2], wb[3], wb[4], wb[5], org, inv, tn));
  // The admitted rays, listed: a warp ballot and a prefix over the warps.
  const unsigned bal = __ballot_sync(kFull, adm);
  if (lane == 0) s_warp[warp] = __popc(bal);
  __syncthreads();
  int n_adm = 0, i = __popc(bal & lt);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    i += w < warp ? s_warp[w] : 0;
    n_adm += s_warp[w];
  }
  if (adm) {
    s_ray[i][0] = make_float4(r.ox, r.oy, r.oz, r.dx);
    s_ray[i][1] = make_float4(r.dy, r.dz, r.tmin, r.tmax);
    if constexpr (kClosest)
      s_key[i] = kNoKey;
    else
      s_occ[i] = 0;
  }
  __syncthreads();
  mbar_wait(&s_bar, 0u);
  // Work units (chunk of up to 16 admitted rays, quarter of 32 slots): warp
  // w holds slot 32 * (w & 3) + lane and takes every other chunk, so the 8
  // warps share the pair tests evenly.
  if (n_adm > 0) {
    const int n_chunks = 2 * ((n_adm + 31) >> 5);
    const int chunk = (n_adm + n_chunks - 1) / n_chunks;
    const int slot = 32 * (warp & 3) + lane;
    float cst[kTestRows];
#pragma unroll
    for (int k = 0; k < kTestRows; ++k) cst[k] = s_slab[k * kLanes + slot];
    for (int k = warp >> 2; k < n_chunks; k += 2) {
      const int p1 = min((k + 1) * chunk, n_adm);
      for (int p = k * chunk; p < p1; ++p) {
        if constexpr (!kClosest) {
          if (s_occ[p]) continue;
        }
        const float4 ra = s_ray[p][0], rb = s_ray[p][1];
        float tt, uu, vv, dpz;
        ort::tri_test(cst, ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, tt, uu, vv,
                      dpz);
        if (ort::tri_accept(tt, uu, vv, dpz, rb.z, rb.w)) {
          if constexpr (kClosest) {
            // t's order-preserving bits over the slot: the minimum is the
            // plain version's winner (smaller t, then lower slot).
            const unsigned long long key =
                (static_cast<unsigned long long>(t_bits(tt)) << 32) |
                static_cast<unsigned>(slot);
            if (key < s_key[p]) atomicMin(&s_key[p], key);
          } else {
            s_occ[p] = 1;
          }
        }
      }
    }
  }
  __syncthreads();
  float* col = out + static_cast<size_t>(o) * kSub + tid;
  if constexpr (kClosest) {
    // The winner's row: its pair test again (the same operations, so the
    // same t, u, v bits), its ids and normal rows from the slab.
    Closest h = closest_init(r);
    const unsigned long long key = adm ? s_key[i] : kNoKey;
    if (key != kNoKey) {
      const int slot = static_cast<int>(key & (kLanes - 1));
      float cst[kTestRows];
#pragma unroll
      for (int k = 0; k < kTestRows; ++k) cst[k] = s_slab[k * kLanes + slot];
      const float4 ra = s_ray[i][0], rb = s_ray[i][1];
      float dpz;
      ort::tri_test(cst, ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, h.bt, h.bu,
                    h.bv, dpz);
      winner_ext(s_slab + kExtRow0 * kLanes + slot, h);
    }
    const size_t cols = static_cast<size_t>(n_steps) * kSub;
    col[0] = h.bt;
    col[cols] = h.bu;
    col[2 * cols] = h.bv;
    col[3 * cols] = h.bnx;
    col[4 * cols] = h.bny;
    col[5 * cols] = h.bnz;
    col[6 * cols] = h.bprim;
    col[7 * cols] = h.bmat;
  } else {
    col[0] = adm && s_occ[i] ? 1.f : 0.f;
  }
}

}  // namespace

// Kernels 4 and 7 with kGroup columns a group box: one CTA a ray block.
template <int kShift, bool kEntry, int kGroup>
int launch_cull_group(const float* aabb, int c_pad, const float* rays,
                      int n_blocks, float* tn, int* mask, void* stream) {
  cull_exact_kernel<kShift, kEntry, kGroup>
      <<<n_blocks, kSub, 0, static_cast<cudaStream_t>(stream)>>>(
          aabb, c_pad, rays, tn, mask);
  return static_cast<int>(cudaGetLastError());
}

// Kernels 4 and 7 at a group size of 4, 8, 16 or 32 columns; any other is
// refused.
template <int kShift, bool kEntry>
int launch_cull(const float* aabb, int c_pad, const float* rays,
                int n_blocks, float* tn, int* mask, int group, void* stream) {
  if (c_pad % kLanes) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks <= 0) return 0;
  switch (group) {
    case 4:
      return launch_cull_group<kShift, kEntry, 4>(aabb, c_pad, rays, n_blocks,
                                                  tn, mask, stream);
    case 8:
      return launch_cull_group<kShift, kEntry, 8>(aabb, c_pad, rays, n_blocks,
                                                  tn, mask, stream);
    case 16:
      return launch_cull_group<kShift, kEntry, 16>(aabb, c_pad, rays,
                                                   n_blocks, tn, mask, stream);
    case 32:
      return launch_cull_group<kShift, kEntry, 32>(aabb, c_pad, rays,
                                                   n_blocks, tn, mask, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int ort_cluster_cull_exact(const float* aabb, int c_pad,
                                      const float* rays, int n_blocks,
                                      float* tn, int* gm, int group,
                                      void* stream) {
  return launch_cull<5, true>(aabb, c_pad, rays, n_blocks, tn, gm, group,
                              stream);
}

extern "C" int ort_qwalk_oct_cull(const float* aabb, int c_pad,
                                  const float* rays, int n_blocks, int* om,
                                  int group, void* stream) {
  return launch_cull<3, false>(aabb, c_pad, rays, n_blocks, nullptr, om,
                               group, stream);
}

// Kernel 8: one CTA a step; aabb is the table's cluster boxes
// [c_pad / 128][6][128].
template <bool kClosest>
int launch_queue(const int* steps, int n_steps, const float* qrays,
                 long long q_cols, const float* comp, int n_comp,
                 const float* aabb, float* out, void* stream) {
  if (n_steps <= 0) return 0;
  qwalk_kernel<kClosest><<<n_steps, kSub, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      steps, n_steps, qrays, static_cast<size_t>(q_cols), comp, n_comp, aabb,
      out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ort_qwalk_closest(const int* steps, int n_steps,
                                 const float* qrays, long long q_cols,
                                 const float* comp, int n_comp,
                                 const float* aabb, float* out,
                                 void* stream) {
  return launch_queue<true>(steps, n_steps, qrays, q_cols, comp, n_comp,
                            aabb, out, stream);
}

extern "C" int ort_qwalk_any(const int* steps, int n_steps,
                             const float* qrays, long long q_cols,
                             const float* comp, int n_comp, const float* aabb,
                             float* out, void* stream) {
  return launch_queue<false>(steps, n_steps, qrays, q_cols, comp, n_comp,
                             aabb, out, stream);
}

// Kernels 5 / 6 and 5c / 6c. The kernel needs its shared memory limit raised
// above 48 KB first; a refusal is returned, and the wrapper raises.
template <bool kClosest, bool kSc>
int launch_walk(const int* counts, const int* lists, const float* comp,
                int n_comp, const float* boxes, int n_box_rows, int width,
                const float* rays, int n_blocks, int c_pad, int gate,
                float* out, int* occ, void* stream) {
  if (width < 1 || width > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      cluster_walk_kernel<kClosest, kSc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(WalkShared)));
  if (err != cudaSuccess) return static_cast<int>(err);
  cluster_walk_kernel<kClosest, kSc><<<n_blocks, kSub, sizeof(WalkShared),
                                       static_cast<cudaStream_t>(stream)>>>(
      counts, lists, comp, n_comp, boxes, n_box_rows, width, rays, c_pad,
      gate, out, occ);
  return static_cast<int>(cudaGetLastError());
}

// Kernels 5 / 6: aabb is the table's cluster boxes [c_pad / 128][6][128],
// win the list entries of a round.
extern "C" int ort_cluster_closest(const int* counts, const int* lists,
                                   const float* comp, int n_comp,
                                   const float* aabb, const float* rays,
                                   int n_blocks, int c_pad, int gate, int win,
                                   float* out, void* stream) {
  return launch_walk<true, false>(counts, lists, comp, n_comp, aabb, 0, win,
                                  rays, n_blocks, c_pad, gate, out, nullptr,
                                  stream);
}

extern "C" int ort_cluster_any(const int* counts, const int* lists,
                               const float* comp, int n_comp,
                               const float* aabb, const float* rays,
                               int n_blocks, int c_pad, int gate, int win,
                               int* occ, void* stream) {
  return launch_walk<false, false>(counts, lists, comp, n_comp, aabb, 0, win,
                                   rays, n_blocks, c_pad, gate, nullptr, occ,
                                   stream);
}

extern "C" int ort_cluster_sc_closest(const int* counts, const int* lists,
                                      const float* comp, int n_comp,
                                      const float* member, int n_member_rows,
                                      int members, const float* rays,
                                      int n_blocks, int c_pad, float* out,
                                      void* stream) {
  return launch_walk<true, true>(counts, lists, comp, n_comp, member,
                                 n_member_rows, members, rays, n_blocks,
                                 c_pad, 0, out, nullptr, stream);
}

extern "C" int ort_cluster_sc_any(const int* counts, const int* lists,
                                  const float* comp, int n_comp,
                                  const float* member, int n_member_rows,
                                  int members, const float* rays,
                                  int n_blocks, int c_pad, int* occ,
                                  void* stream) {
  return launch_walk<false, true>(counts, lists, comp, n_comp, member,
                                  n_member_rows, members, rays, n_blocks,
                                  c_pad, 0, nullptr, occ, stream);
}
