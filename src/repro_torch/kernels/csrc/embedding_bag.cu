// embedding_bag: a sum-mode EmbeddingBag, out[i] = sum_j w[i,j] *
// table[idx[i,j]], with idx < 0 marking a padded slot.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::
// embedding_bag_pallas (pallas_call at line 76), which DMA'd one table
// row per (bag, slot) from HBM into a VMEM accumulator tile. Here one
// warp owns a bag: the lanes lie over the row's D columns (kCols of them
// a lane per pass, so a pass covers 32 * kCols columns), read the slot's
// index and weight once (one broadcast load for the warp) and add the
// row's columns, read coalesced, into registers.
//
//   * Accumulation is in f32, slot by slot, acc = acc + row * w with the
//     product and the sum each rounded on its own (no FMA), the order
//     kernels/ref.py repeats; a bf16 table's row is widened exactly and
//     the sum rounded to bf16 once, at the end (round to nearest even).
//   * A padded slot adds nothing. The TPU kernel and the oracle add
//     0 * table[0] there, which differs only when table[0] holds an inf
//     or a NaN.
//   * weights may be null: every weight is then 1.
//
// Bound on an H100: the bytes of the rows the valid slots name, read
// once, plus the indices, the weights and the output, at 3.35 TB/s. The
// row loads of successive slots do not depend on each other, so the
// unrolled slot loop keeps several in flight per warp.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // 8 warps, 8 bags a block
constexpr int kCols = 4;     // columns a lane holds per pass

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* out, float x) { *out = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* out, float x) {
  *out = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kBlock) embedding_bag_kernel(
    const T* __restrict__ table, const int* __restrict__ indices,
    const float* __restrict__ weights, int n_bags, int bag, int D,
    T* out) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * (kBlock / 32) + threadIdx.x / 32;
  if (i >= n_bags) return;
  const int* ix = indices + (size_t)i * bag;
  const float* wt = weights ? weights + (size_t)i * bag : nullptr;
  for (int d0 = 0; d0 < D; d0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < bag; ++j) {
      const int r = ix[j];
      if (r < 0) continue;
      const float w = wt ? wt[j] : 1.0f;
      const T* row = table + (size_t)r * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = d0 + c * 32 + lane;
        if (d < D) acc[c] = __fadd_rn(acc[c], __fmul_rn(widen(row[d]), w));
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = d0 + c * 32 + lane;
      if (d < D) narrow(out + (size_t)i * D + d, acc[c]);
    }
  }
}

}  // namespace

// bf16 != 0 selects the bf16 table (and output). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int embedding_bag_launch(const void* table, const void* indices,
                                    const void* weights, void* out,
                                    int n_bags, int bag, int D, int bf16,
                                    void* stream) {
  const int per_block = kBlock / 32;
  const int grid = (n_bags + per_block - 1) / per_block;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    embedding_bag_kernel<__nv_bfloat16><<<grid, kBlock, 0, s>>>(
        (const __nv_bfloat16*)table, (const int*)indices,
        (const float*)weights, n_bags, bag, D, (__nv_bfloat16*)out);
  else
    embedding_bag_kernel<float><<<grid, kBlock, 0, s>>>(
        (const float*)table, (const int*)indices, (const float*)weights,
        n_bags, bag, D, (float*)out);
  return (int)cudaGetLastError();
}
