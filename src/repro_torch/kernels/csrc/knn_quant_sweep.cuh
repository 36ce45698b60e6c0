// Shared device code of the port's two quantized KNN kernels
// (knn_lambda_quant.cu, knn_rank_audited_quant.cu): the sweep over the
// packed db (launch A') and the per-query merge, guard, exact re-score,
// re-rank and weighting. Both kernels run this code verbatim, so on the
// same queries and pack their lambda-hat agree bitwise.
//
// Replaces the shared bodies of the TPU kernels in
// src/repro/kernels/knn_topk.py (_db_slab_merge_quant, _quant_init,
// _quant_lambda_flush), whose grid swept the packed db slab by slab on
// one core with a running top-(k+8) that carried each survivor's
// dequantized row, lambda row and |x~|^2 in VMEM. On the card:
//
//   Launch A', grid (query tiles x db chunks), the f32 sweep's shape
//     (knn_sweep.cuh): kQT queries per block, 8 threads per query, each
//     with a register list of the best k_keep = k + 8 (d2q, global
//     index), ties to the lowest index. The pack's rows stream through
//     shared memory in their storage type:
//       int8: each query is quantized once per block (sq = max|q|/127,
//         qi = rint(q/sq) clipped to +-127), rows are padded to whole
//         32-bit words with zeros, and the cross term is an exact int32
//         dot by __dp4a (exact in f32 too: d * 127^2 < 2^24). Then
//         d2q = q2 - ((2 sq) scale[row / slab]) cross + y2_q[row],
//         each operation rounded on its own, clamped at 0.
//       bf16: rows are widened to f32 exactly and the dot is summed
//         coordinate by coordinate: d2q = q2 - 2 cross + y2_q[row].
//     The pack's slab (the storage format's, 512 by default) and the
//     chunk are independent: the kernel reads scale[row / slab]. The
//     pack's padding rows carry y2 = PAD_Y2 and never reach the final k
//     while n_train >= k.
//   merge_quant, one block per query: merges the partial lists into the
//     k_keep survivors (knn_sweep.cuh's merge_lists), computes the
//     margin guard on the quantized k/(k+1) gap against the exact
//     error |2 (q - sq qi) . x~| of the two boundary survivors (0 in
//     bf16), gathers the survivors' rows by index, dequantizes them and
//     re-scores exactly, q2 - 2 (q . x~) + y2_q, re-ranks to k by
//     (d2, index) and weights them (knn_sweep.cuh's idw_weights) with
//     y2 taken from y2_q.
//
// The plain version of all of this is kernels/common.py's quant helpers
// with core/predictors.knn_quant_scan; both repeat the same rounded
// operations in the same order.
//
// Bound on an H100: at the serving bucket the pack's bytes (1 or 2 bytes
// per coordinate plus 4 for y2), read once at 3.35 TB/s; at a large
// batch the dot (int8 or bf16 tensor-core peak) and the f32 epilogue.
// This first kernel runs the dot on the integer (dp4a) and f32 pipes,
// not the tensor cores: an int8 tensor-core sweep is later work.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#include "knn_sweep.cuh"

namespace knn {

constexpr int kQKMax = kKMax + 8;  // KNN_QUANT_MAX_KEEP: survivors kept
constexpr int kMaxD = 128;         // KNN_MAX_D: covariates of a query

// sq = max|q| / 127 over the row's D coordinates, 1 for a zero row
__device__ __forceinline__ float query_scale(const float* q, int D) {
  float m = 0.0f;
  for (int d = 0; d < D; ++d) m = fmaxf(m, fabsf(q[d]));
  const float s = __fdiv_rn(m, 127.0f);
  return s > 0.0f ? s : 1.0f;
}

// qi = rint(q / sq) clipped to [-127, 127] (round half to even)
__device__ __forceinline__ float quantize(float q, float sq) {
  return fminf(fmaxf(rintf(__fdiv_rn(q, sq)), -127.0f), 127.0f);
}

// Launch A'. Shared memory: qs (kQT*D f32 queries), x2s (kQT), sqs
// (kQT), qw (kQT*Dw words of int8 qi), then a region holding either the
// db tile or, after the sweep, the kQT*kSub lists to merge (KK floats
// and KK ints each). The int8 tile is rw (st*Dw words), y2s (st) and
// scs (st, each row's slab scale); the bf16 tile dbs (st*D) and y2s.
template <bool kInt8>
__global__ void __launch_bounds__(kBlock) quant_chunk_topk_kernel(
    const float* __restrict__ xq, const void* __restrict__ xdbq,
    const float* __restrict__ q_scale, const float* __restrict__ y2q, int B,
    int N, int D, int KK, int slab, int chunk, int st, int n_chunks,
    float* ws_d2, int* ws_idx) {
  extern __shared__ float smem[];
  const int Dw = (D + 3) / 4;
  float* qs = smem;
  float* x2s = qs + kQT * D;
  float* sqs = x2s + kQT;
  int* qw = reinterpret_cast<int*>(sqs + kQT);
  float* region = reinterpret_cast<float*>(qw + kQT * Dw);
  int* rw = reinterpret_cast<int*>(region);           // int8 tile
  float* dbs = region;                                // bf16 tile
  float* y2s = kInt8 ? region + st * Dw : region + st * D;
  float* scs = y2s + st;

  const int tid = threadIdx.x;
  const int ql = tid / kSub, sub = tid % kSub;
  const int q0 = blockIdx.x * kQT;
  const int q = q0 + ql;
  const int chunk_id = blockIdx.y;
  const int r0 = chunk_id * chunk;
  const int r1 = min(N, r0 + chunk);

  for (int i = tid; i < kQT * D; i += blockDim.x) {
    const int qq = q0 + i / D;
    qs[i] = qq < B ? xq[(size_t)qq * D + i % D] : 0.0f;
  }
  __syncthreads();
  if (tid < kQT) {
    const float* qv = qs + tid * D;
    x2s[tid] = sq_norm(qv, D);
    if (kInt8) {
      const float sq = query_scale(qv, D);
      sqs[tid] = sq;
      signed char* qb = reinterpret_cast<signed char*>(qw + tid * Dw);
      for (int d = 0; d < Dw * 4; ++d)
        qb[d] = d < D ? (signed char)(int)quantize(qv[d], sq) : 0;
    }
  }

  float bd[kQKMax];
  int bi[kQKMax];
  float wd;
  int wi;
  init_list(bd, bi, wd, wi);

  const signed char* src8 = static_cast<const signed char*>(xdbq);
  const __nv_bfloat16* src16 = static_cast<const __nv_bfloat16*>(xdbq);
  for (int t0 = r0; t0 < r1; t0 += st) {
    const int rows = min(st, r1 - t0);
    __syncthreads();  // the previous tile is consumed
    if (kInt8) {
      const signed char* src = src8 + (size_t)t0 * D;
      if (D % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
        const int* w = reinterpret_cast<const int*>(src);
        for (int i = tid; i < rows * Dw; i += blockDim.x) rw[i] = w[i];
      } else {
        signed char* tb = reinterpret_cast<signed char*>(rw);
        for (int i = tid; i < rows * Dw * 4; i += blockDim.x) {
          const int r = i / (Dw * 4), c = i % (Dw * 4);
          tb[i] = c < D ? src[(size_t)r * D + c] : 0;
        }
      }
      for (int r = tid; r < rows; r += blockDim.x)
        scs[r] = q_scale[(t0 + r) / slab];
    } else {
      const __nv_bfloat16* src = src16 + (size_t)t0 * D;
      for (int i = tid; i < rows * D; i += blockDim.x)
        dbs[i] = __bfloat162float(src[i]);
    }
    for (int r = tid; r < rows; r += blockDim.x) y2s[r] = y2q[t0 + r];
    __syncthreads();
    if (q < B) {
      const float x2 = x2s[ql];
      for (int r = sub; r < rows; r += kSub) {
        float d2;
        if (kInt8) {
          const int* qv = qw + ql * Dw;
          const int* xv = rw + r * Dw;
          int cross = 0;
          for (int w = 0; w < Dw; ++w) cross = __dp4a(qv[w], xv[w], cross);
          const float coef = __fmul_rn(__fmul_rn(2.0f, sqs[ql]), scs[r]);
          d2 = __fadd_rn(__fsub_rn(x2, __fmul_rn(coef, (float)cross)),
                         y2s[r]);
        } else {
          const float* qv = qs + ql * D;
          const float* xv = dbs + r * D;
          float cross = 0.0f;
          for (int d = 0; d < D; ++d)
            cross = __fadd_rn(cross, __fmul_rn(qv[d], xv[d]));
          d2 = __fadd_rn(__fsub_rn(x2, 2.0f * cross), y2s[r]);
        }
        d2 = fmaxf(d2, 0.0f);
        const int gid = t0 + r;
        if (nearer(d2, gid, wd, wi)) insert(bd, bi, KK, d2, gid, wd, wi);
      }
    }
  }
  __syncthreads();  // the db tile region becomes the merge region
  float* md = region;
  int* mi = reinterpret_cast<int*>(md + kQT * kSub * KK);
  const int slot = (ql * kSub + sub) * KK;
#pragma unroll
  for (int j = 0; j < kQKMax; ++j)
    if (j < KK) { md[slot + j] = bd[j]; mi[slot + j] = bi[j]; }
  __syncthreads();
  if (sub == 0 && q < B) {
    for (int s = 1; s < kSub; ++s) {
      const int base = (ql * kSub + s) * KK;
      for (int j = 0; j < KK; ++j) {
        const float d = md[base + j];
        const int id = mi[base + j];
        if (!nearer(d, id, wd, wi)) break;  // the list is sorted
        insert(bd, bi, KK, d, id, wd, wi);
      }
    }
    const size_t out = ((size_t)q * n_chunks + chunk_id) * KK;
#pragma unroll
    for (int j = 0; j < kQKMax; ++j)
      if (j < KK) { ws_d2[out + j] = bd[j]; ws_idx[out + j] = bi[j]; }
  }
}

// Bytes of dynamic shared memory launch A' needs.
inline size_t quant_sweep_smem(int D, int KK, int st, bool int8) {
  const int Dw = (D + 3) / 4;
  const int tile = int8 ? st * (Dw + 2) : st * (D + 1);
  const int lists = kQT * kSub * KK * 2;
  return (size_t)(kQT * (D + 2) + kQT * Dw + (tile > lists ? tile : lists)) *
         sizeof(float);
}

// Starts launch A' on `stream`; returns cudaGetLastError().
inline int launch_quant_chunk_topk(const float* xq, const void* xdbq,
                                   const float* q_scale, const float* y2q,
                                   int B, int N, int D, int KK, int slab,
                                   bool int8, int chunk, int st, int n_chunks,
                                   float* ws_d2, int* ws_idx,
                                   cudaStream_t stream) {
  const size_t smem = quant_sweep_smem(D, KK, st, int8);
  dim3 grid((B + kQT - 1) / kQT, n_chunks);
  auto kernel = int8 ? quant_chunk_topk_kernel<true>
                     : quant_chunk_topk_kernel<false>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, kBlock, smem, stream>>>(xq, xdbq, q_scale, y2q, B, N, D, KK,
                                          slab, chunk, st, n_chunks, ws_d2,
                                          ws_idx);
  return (int)cudaGetLastError();
}

// One query's quantized merge, with the whole block: the row's k_keep =
// KK survivors from its partial lists (merge_lists, in `smem`,
// merge_smem_floats(KK) floats), the margin guard written to
// guard_out[row], the exact re-score and re-rank to k, then the weights
// to nw and the neighbours' indices to ni (shared, kKMax each). Ends
// synced.
template <bool kInt8>
__device__ inline void merge_quant(
    const float* __restrict__ xq, const void* __restrict__ xdbq,
    const float* __restrict__ q_scale, const float* __restrict__ y2q,
    const float* __restrict__ ws_d2, const int* __restrict__ ws_idx,
    size_t row, int D, int k, int KK, int slab, int n_chunks, float* smem,
    float* nw, int* ni, int* guard_out) {
  __shared__ float sd[kQKMax], sx[kQKMax], sy2[kQKMax], serr[kQKMax];
  __shared__ int si[kQKMax];
  __shared__ float nd[kKMax], ny2[kKMax];
  __shared__ float qrow[kMaxD], erow[kMaxD];
  __shared__ float x2_s;
  const int tid = threadIdx.x;
  merge_lists<kQKMax>(ws_d2, ws_idx, row, KK, n_chunks, smem, sd, si);

  for (int d = tid; d < D; d += blockDim.x) qrow[d] = xq[row * D + d];
  __syncthreads();
  if (tid == 0) {
    x2_s = sq_norm(qrow, D);
    if (kInt8) {
      // the query's quantization error per coordinate, q - sq qi
      const float sq = query_scale(qrow, D);
      for (int d = 0; d < D; ++d)
        erow[d] = __fsub_rn(qrow[d], __fmul_rn(sq, quantize(qrow[d], sq)));
    }
  }
  __syncthreads();
  if (tid < KK) {
    // gather survivor tid's row, dequantize, re-score exactly
    const signed char* src8 = static_cast<const signed char*>(xdbq);
    const __nv_bfloat16* src16 = static_cast<const __nv_bfloat16*>(xdbq);
    const int id = si[tid];
    const size_t base = (size_t)id * D;
    const float scale = kInt8 ? q_scale[id / slab] : 1.0f;
    float cross = 0.0f, err = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float x =
          kInt8 ? __fmul_rn((float)src8[base + d], scale)
                : __bfloat162float(src16[base + d]);
      cross = __fadd_rn(cross, __fmul_rn(qrow[d], x));
      if (kInt8) err = __fadd_rn(err, __fmul_rn(erow[d], x));
    }
    const float y2 = y2q[id];
    sx[tid] = fmaxf(__fadd_rn(__fsub_rn(x2_s, 2.0f * cross), y2), 0.0f);
    sy2[tid] = y2;
    serr[tid] = kInt8 ? fabsf(2.0f * err) : 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    // the quantized order was ambiguous at the k-th place
    const float gap = __fsub_rn(sd[k], sd[k - 1]);
    guard_out[row] = gap <= __fadd_rn(serr[k - 1], serr[k]) ? 1 : 0;
  }
  if (tid < KK) {
    // re-rank: a survivor's place is the count of nearer survivors
    int place = 0;
    for (int j = 0; j < KK; ++j)
      place += nearer(sx[j], si[j], sx[tid], si[tid]);
    if (place < k) {
      nd[place] = sx[tid];
      ni[place] = si[tid];
      ny2[place] = sy2[tid];
    }
  }
  __syncthreads();
  idw_weights(x2_s, nd, ny2, k, nw);
}

}  // namespace knn
