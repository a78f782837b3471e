// Kernel 9: the texture-fetch study's block-tile row fetch.
//
// Replaces tools/bench_texfetch.py::onehot_fetch -> _onehot_kernel (the TPU
// kernel DMAs each 256-lane block's 2-tile window of a bf16 [n_rows, 128]
// atlas into VMEM and resolves each lane's row with a one-hot bf16 MXU
// contraction). It computes: lane l of block b gets row tile_idx[b] *
// tile_w + local[b, l] (local in [0, 2 tile_w)), widened to f32 -> out
// [n_blocks * 256, 128].
//
// What bounds it on the H100: bytes. Each lane writes a 512-byte f32 row
// and reads a 256-byte bf16 row; there is no arithmetic. The window is
// 2 tile_w rows of 256 bytes (256 KB at tile_w 512, past the 227 KB of
// shared memory an SM has), and a block reads each of its 256 rows once,
// so nothing is staged in shared memory: rows come straight from L2 (the
// study's 16 MB atlas fits the 50 MB L2), and the one-hot product, a TPU
// gather device, is a plain indexed copy here. The copy is exact.
//
// Design: one 256-thread block per lane block, eight warps of 32 lanes
// each. A warp loads its 32 lanes' indices with one coalesced read, then
// copies one row per step: each thread reads 4 bf16 (8 bytes) through the
// read-only path and writes 4 f32 (16 bytes), so a row is one 256-byte read
// and one 512-byte write of the whole warp.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;     // lanes per block (bench_texfetch.BLOCK)
constexpr int kRowW = 128;      // bf16 per row (bench_texfetch.ROW_W)

__global__ void __launch_bounds__(kBlock)
texfetch_kernel(const __nv_bfloat16* __restrict__ atlas,
                const int* __restrict__ tile_idx,
                const int* __restrict__ local, int tile_w,
                float* __restrict__ out) {
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(__ldg(tile_idx + b)) * tile_w;
  const int first = b * kBlock + warp * 32;
  const int my_local = __ldg(local + first + lane);
  for (int i = 0; i < 32; ++i) {
    const long long row = base + __shfl_sync(0xffffffffu, my_local, i);
    const uint2 packed = __ldg(reinterpret_cast<const uint2*>(
        atlas + row * kRowW) + lane);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(
        &packed.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(
        &packed.y);
    const float2 f0 = __bfloat1622float2(lo);
    const float2 f1 = __bfloat1622float2(hi);
    reinterpret_cast<float4*>(out + static_cast<long long>(first + i) *
                              kRowW)[lane] = make_float4(f0.x, f0.y, f1.x,
                                                         f1.y);
  }
}

}  // namespace

// atlas [n_rows, 128] bf16, tile_idx [n_blocks] int32, local [n_blocks, 256]
// int32, out [n_blocks * 256, 128] f32.
extern "C" int ort_texfetch(const void* atlas, const int* tile_idx,
                            const int* local, int tile_w, int n_blocks,
                            float* out, void* stream) {
  if (n_blocks > 0) {
    texfetch_kernel<<<n_blocks, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(atlas), tile_idx, local, tile_w,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}
