// The counter RNG's seed and draws (core/rng.py::seed, ::uniform2) on the
// card.
//
// Replaces no pallas_call: the JAX package's RNG is jnp code that XLA fuses
// into its callers (optix_raytracer_tpu/core/rng.py). In eager PyTorch the
// same words cost one op a step: torch's CPU uint32 lacks add and shifts, so
// the plain version carries each 32-bit word in an int64, masks it after
// every step and builds a 32-bit product from 16-bit halves. That is 74
// aten ops a seed and 60 a uniform2, each streaming whole int64 planes: in
// a progressive launch of the SPD tetra on an H100 (1920x1088, 16 samples)
// ~9,200 ops and ~200 ms of its ~530 ms of torch ops. Here a seed and a
// uniform2 are one launch each, with the words in uint32_t (common.cuh's
// tea4 and uniform, which kernel 3 uses), bit-equal to the plain version:
// the state stays an int64 holding a value in [0, 2^32), and every lane
// advances, dead ones included.
//
// What bounds it on the H100: bytes. A uniform2 reads a lane's 8-byte state
// and writes two f32 draws and the 8-byte next state, 24 bytes a lane
// (30 us for a 4.18M-lane strip at 3.35 TB/s); its 14 integer operations a
// draw are far below the card's rate. A seed reads its operands (broadcast,
// so mostly from L1 / L2) and writes 8 bytes a lane.
//
// Design: uniform2 takes two pairs of lanes a thread a step, each pair one
// 16-byte state load (consecutive threads on consecutive pairs), one 8-byte
// store of each draw and one 16-byte store of the next state, both loads in
// flight before the arithmetic; a grid of at most 8 blocks of 256 an SM
// strides over the lanes. An odd last lane, or a state that is not 16-byte
// aligned (a view), takes the one-lane loop. The seed's grid is the output's
// shape (rank <= 3): z and y its first two indices, x strides along a row,
// so no lane divides to find its indices. It reads each operand through the
// strides of its broadcast to that shape (a zero stride where broadcast) or
// takes it as a value (a Python int, a CPU scalar); a device subframe is
// read from device memory, so both launch inside a captured CUDA graph.
// Neither syncs nor allocates; both run on the caller's stream.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 2;          // pairs of lanes a thread takes a step
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ void draw2(long long s, float& u1, float& u2,
                                      long long& next) {
  uint32_t st = static_cast<uint32_t>(s);
  u1 = ort::uniform(st);
  u2 = ort::uniform(st);
  next = static_cast<long long>(st);
}

__global__ void __launch_bounds__(kThreads)
rng_uniform2_kernel(const long long* __restrict__ state, long long n,
                    bool paired, float* __restrict__ u1,
                    float* __restrict__ u2, long long* __restrict__ next) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  long long first_single = 0;
  if (paired) {
    const long long n_pairs = n >> 1;
    const longlong2* s2 = reinterpret_cast<const longlong2*>(state);
    for (long long base = static_cast<long long>(blockIdx.x) * kThreads *
                          kPairs;
         base < n_pairs; base += threads * kPairs) {
      longlong2 s[kPairs];
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const long long p = base + k * kThreads + threadIdx.x;
        if (p < n_pairs) s[k] = __ldg(s2 + p);
      }
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const long long p = base + k * kThreads + threadIdx.x;
        if (p < n_pairs) {
          float2 a, b;
          longlong2 nx;
          draw2(s[k].x, a.x, b.x, nx.x);
          draw2(s[k].y, a.y, b.y, nx.y);
          reinterpret_cast<float2*>(u1)[p] = a;
          reinterpret_cast<float2*>(u2)[p] = b;
          reinterpret_cast<longlong2*>(next)[p] = nx;
        }
      }
    }
    first_single = n_pairs * 2;
  }
  for (long long i = first_single + tid; i < n; i += threads) {
    draw2(__ldg(state + i), u1[i], u2[i], next[i]);
  }
}

// One operand of the seed: a device plane read through strides s0-s2
// (zero where broadcast), or `value` when `ptr` is null.
struct Operand {
  const long long* ptr;
  long long value, s0, s1, s2;
};

__device__ __forceinline__ uint32_t word(const Operand& o, long long i0,
                                         long long i1, long long i2) {
  return static_cast<uint32_t>(o.ptr ? __ldg(o.ptr + i0 * o.s0 + i1 * o.s1 +
                                             i2 * o.s2)
                                     : o.value);
}

__global__ void __launch_bounds__(kThreads)
rng_seed_kernel(Operand a, Operand b, long long d0, long long d1,
                long long d2, long long* __restrict__ out) {
  for (long long i0 = blockIdx.z; i0 < d0; i0 += gridDim.z) {
    for (long long i1 = blockIdx.y; i1 < d1; i1 += gridDim.y) {
      long long* row = out + (i0 * d1 + i1) * d2;
      for (long long i2 = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
           i2 < d2; i2 += static_cast<long long>(gridDim.x) * kThreads) {
        row[i2] = static_cast<long long>(
            ort::tea4(word(a, i0, i1, i2), word(b, i0, i1, i2)));
      }
    }
  }
}

// At most kBlocksPerSm blocks an SM, the SM count read at the first launch:
// later launches ask the driver nothing.
long long grid_cap() {
  static const long long cap = [] {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return static_cast<long long>(sms) * kBlocksPerSm;
  }();
  return cap;
}

int grid_for(long long items) {
  const long long need = (items + kThreads - 1) / kThreads;
  return static_cast<int>(need < grid_cap() ? need : grid_cap());
}

}  // namespace

// state [n] int64 (values in [0, 2^32)) -> u1, u2 [n] f32, next [n] int64.
extern "C" int ort_rng_uniform2(const long long* state, long long n,
                                float* u1, float* u2, long long* next,
                                void* stream) {
  if (n > 0) {
    const bool paired =
        ((reinterpret_cast<uintptr_t>(state) |
          reinterpret_cast<uintptr_t>(next)) % 16 == 0) &&
        ((reinterpret_cast<uintptr_t>(u1) |
          reinterpret_cast<uintptr_t>(u2)) % 8 == 0);
    const long long items = paired ? ((n >> 1) + kPairs - 1) / kPairs : n;
    rng_uniform2_kernel<<<grid_for(items > 0 ? items : 1), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        state, n, paired, u1, u2, next);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [d0, d1, d2] int64 = tea4(a, b) over the broadcast of a and b. Each
// operand is a device int64 plane read at i0 * s0 + i1 * s1 + i2 * s2, or,
// with a null pointer, the value `*_value`.
extern "C" int ort_rng_seed(const long long* a, long long a_value,
                            long long a_s0, long long a_s1, long long a_s2,
                            const long long* b, long long b_value,
                            long long b_s0, long long b_s1, long long b_s2,
                            long long d0, long long d1, long long d2,
                            long long* out, void* stream) {
  if (d0 > 0 && d1 > 0 && d2 > 0) {
    constexpr long long kMaxYZ = 65535;
    const long long z = d0 < kMaxYZ ? d0 : kMaxYZ;
    const long long y = d1 < kMaxYZ ? d1 : kMaxYZ;
    const long long x_cap = grid_cap() / (y * z);
    const long long x_need = (d2 + kThreads - 1) / kThreads;
    const dim3 grid(static_cast<unsigned>(
                        x_need < x_cap ? x_need : (x_cap > 0 ? x_cap : 1)),
                    static_cast<unsigned>(y), static_cast<unsigned>(z));
    rng_seed_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        Operand{a, a_value, a_s0, a_s1, a_s2},
        Operand{b, b_value, b_s0, b_s1, b_s2}, d0, d1, d2, out);
  }
  return static_cast<int>(cudaGetLastError());
}
