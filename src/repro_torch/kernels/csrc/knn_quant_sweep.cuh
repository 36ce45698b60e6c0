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
//   Launch A', grid (query tiles of kQB = 32 x db chunks): a warp owns
//     kQW = 4 queries and scores every row of its block's chunk for
//     them, one row a lane. The pack's tiles stream through shared
//     memory in their storage type by cp.async into a two-stage ring,
//     so tile t+1 lands while tile t is scored:
//       int8: each query is quantized once per block (sq = max|q|/127,
//         qi = rint(q/sq) clipped to +-127), rows are padded to whole
//         32-bit words with zeros, and the cross term is an exact int32
//         dot by __dp4a (exact in f32 too: d * 127^2 < 2^24). Then
//         d2q = q2 - ((2 sq) scale[row / slab]) cross + y2_q[row],
//         each operation rounded on its own, clamped at 0. Each row's
//         slab scale is laid out per tile from the slab boundaries.
//       bf16: rows are widened to f32 exactly (a shift of each half
//         word) and the dot is summed coordinate by coordinate:
//         d2q = q2 - 2 cross + y2_q[row].
//     Selection: knn_select.cuh's warp lists (a query's running top-KK
//     spread over its warp's 32 lanes, keys -d2q; a pair is staged by
//     ballot only if it beats the KK-th, and a full stage or the chunk's
//     end is folded in by the in-warp bitonic network). On random data
//     about KK (1 + ln(chunk / KK)) pairs of a chunk pass. The warp
//     writes each query's partial list straight to the (B, n_chunks, KK)
//     workspace.
//   merge_quant, one block per query: knn_select.cuh's merge_lists (the
//     same filter and stage fold over the n_chunks x KK partial pairs,
//     the eight warps' lists merged) gives the KK survivors, then the
//     margin guard on the quantized k/(k+1) gap against the exact
//     error |2 (q - sq qi) . x~| of the two boundary survivors (0 in
//     bf16), the survivors' rows gathered by index, dequantized and
//     re-scored exactly, q2 - 2 (q . x~) + y2_q, re-ranked to k by
//     (d2, index) and weighted (knn_select.cuh's idw_weights) with y2
//     taken from y2_q.
//
// Why the result stays the plain version's bit for bit: the KK
// survivors are a set under (d2q asc, index asc), a total order over
// unique indices, which no selection algorithm, tiling or chunking can
// change; only the arithmetic of d2q keeps its order (the int32 dot,
// then __fmul_rn/__fsub_rn/__fadd_rn; in bf16 a __fmul_rn and a
// __fadd_rn a coordinate, never an FMA), and negation is exact.
//
// The plain version of all of this is kernels/common.py's quant helpers
// with core/predictors.knn_quant_scan; both repeat the same rounded
// operations in the same order. Limits: KK <= kListMax = 256 and a d
// whose tiles fit one block's shared memory (kernels/knn_topk.py's
// quant_sweep_geometry, which also picks the tile and the chunk).
//
// Bound on an H100: at the serving bucket the pack's bytes (1 or 2 bytes
// per coordinate plus 4 for y2), read once at 3.35 TB/s; at a large
// batch the dot (int8 or bf16 tensor-core peak) and the f32 epilogue.
// The dot runs on the integer (dp4a) and f32 pipes, not the tensor
// cores: an int8 tensor-core sweep is later work.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>

#include "knn_select.cuh"

namespace knn {

// a is nearer than b: a smaller d2, or an equal d2 and a lower index
__device__ __forceinline__ bool nearer(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

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

// -- launch A' ----------------------------------------------------------

// Words of a stored row: int8 4 coordinates a word, bf16 2.
__host__ __device__ inline int row_words(int D, bool int8) {
  return int8 ? (D + 3) / 4 : (D + 1) / 2;
}

// Bytes of dynamic shared memory launch A' needs: the queries' dot
// operand (int8: kQB*Dw words of qi; bf16: kQB*2*Dw floats), |q|^2 and
// 2 sq (kQB each), two tiles of st rows at the odd stride Dw | 1 (so a
// warp's 32 rows lie on 32 banks), their y2 and slab scales (2 st each),
// and a stage of L pairs for each of the block's kQB queries.
// quant_sweep_geometry in kernels/knn_topk.py repeats this sum.
__host__ __device__ inline size_t quant_sweep_smem(int D, int KK, int st,
                                                   bool int8) {
  const int Dw = row_words(D, int8);
  const int L = 32 * list_rl(KK);
  return ((size_t)kQB * Dw * (int8 ? 1 : 2) + 2 * kQB +
          2 * (size_t)st * (Dw | 1) + 4 * (size_t)st + 2 * (size_t)kQB * L) *
         4;
}

// Launch A'. st is a multiple of 32 and chunk a multiple of st.
template <bool kInt8, int RL>
__global__ void __launch_bounds__(kBlock, RL == 1 ? 4 : 1)
    quant_chunk_topk_kernel(const float* __restrict__ xq,
                            const void* __restrict__ xdbq,
                            const float* __restrict__ q_scale,
                            const float* __restrict__ y2q, int B, int N,
                            int D, int KK, int slab, int chunk, int st,
                            int n_chunks, float* ws_d2, int* ws_idx) {
  constexpr int L = 32 * RL;
  extern __shared__ __align__(16) float qsm[];
  const int Dw = row_words(D, kInt8), rs = Dw | 1;
  float* qv = qsm;  // [warp][word][query of the warp] (x2 halves in bf16)
  float* x2s = qv + kQB * Dw * (kInt8 ? 1 : 2);
  float* c2s = x2s + kQB;
  int* tiles = reinterpret_cast<int*>(c2s + kQB);
  float* y2s = reinterpret_cast<float*>(tiles + 2 * st * rs);
  float* scs = y2s + 2 * st;
  float* stk = scs + 2 * st;
  int* stx = reinterpret_cast<int*>(stk + kQB * L);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQB;
  const int chunk_id = blockIdx.y;
  const int r0 = chunk_id * chunk;
  const int r1 = min(N, r0 + chunk);

  // the queries, grouped by warp: query q0 + warp * kQW + qq
  if (kInt8) {
    if (tid < kQB) {
      const int q = q0 + tid;
      const float* qp = xq + (size_t)q * D;
      const float sq = q < B ? query_scale(qp, D) : 1.0f;
      x2s[tid] = q < B ? sq_norm(qp, D) : 0.0f;
      c2s[tid] = __fmul_rn(2.0f, sq);
      int* qw = reinterpret_cast<int*>(qv);
      const int g = tid / kQW, qq = tid % kQW;
      for (int w = 0; w < Dw; ++w) {
        unsigned word = 0;
        for (int b = 0; b < 4; ++b) {
          const int d = 4 * w + b;
          const int v = q < B && d < D ? (int)quantize(qp[d], sq) : 0;
          word |= (unsigned)(v & 0xff) << (8 * b);
        }
        qw[(g * Dw + w) * kQW + qq] = (int)word;
      }
    }
  } else {
    for (int i = tid; i < kQB * 2 * Dw; i += kBlock) {
      const int h = i & 1, qq = (i >> 1) % kQW, gw = (i >> 1) / kQW;
      const int q = q0 + (gw / Dw) * kQW + qq, d = 2 * (gw % Dw) + h;
      qv[i] = q < B && d < D ? xq[(size_t)q * D + d] : 0.0f;
    }
    if (tid < kQB)
      x2s[tid] = q0 + tid < B ? sq_norm(xq + (size_t)(q0 + tid) * D, D)
                              : 0.0f;
  }

  // one tile of rows [t0, t0 + rows) into ring slot `buf`
  const bool whole = kInt8 ? D % 4 == 0 : D % 2 == 0;  // rows are words
  const size_t row_bytes = kInt8 ? D : 2 * D;
  auto load = [&](int buf, int t0) {
    const int rows = min(st, r1 - t0);
    int* tw = tiles + buf * st * rs;
    const char* src =
        static_cast<const char*>(xdbq) + (size_t)t0 * row_bytes;
    if (whole) {
      const int* sw = reinterpret_cast<const int*>(src);
      if (rs == Dw && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int n16 = rows * Dw / 4;
        for (int i = tid; i < n16; i += kBlock)
          cp_async16(tw + 4 * i, sw + 4 * i);
        for (int i = 4 * n16 + tid; i < rows * Dw; i += kBlock)
          cp_async4(tw + i, sw + i);
      } else {
        for (int i = tid; i < rows * Dw; i += kBlock)
          cp_async4(tw + (i / Dw) * rs + i % Dw, sw + i);
      }
    } else {
      // rows that end inside a word: repacked with zeros, synchronously
      for (int i = tid; i < rows * Dw; i += kBlock) {
        const int r = i / Dw, w = i % Dw;
        unsigned word = 0;
        if (kInt8) {
          const unsigned char* s8 =
              reinterpret_cast<const unsigned char*>(src) + (size_t)r * D;
          for (int b = 0; b < 4; ++b)
            if (4 * w + b < D) word |= (unsigned)s8[4 * w + b] << (8 * b);
        } else {
          const unsigned short* s16 =
              reinterpret_cast<const unsigned short*>(src) + (size_t)r * D;
          for (int h = 0; h < 2; ++h)
            if (2 * w + h < D) word |= (unsigned)s16[2 * w + h] << (16 * h);
        }
        tw[r * rs + w] = (int)word;
      }
    }
    float* ty = y2s + buf * st;
    for (int r = tid; r < rows; r += kBlock) cp_async4(ty + r, y2q + t0 + r);
    if (kInt8) {
      // each row's slab scale, slab by slab over the tile
      float* tsc = scs + buf * st;
      const int s_lo = t0 / slab, s_hi = (t0 + rows - 1) / slab;
      for (int s = s_lo; s <= s_hi; ++s) {
        const float sc = q_scale[s];
        const int e = min(s * slab + slab - t0, rows);
        for (int r = max(s * slab - t0, 0) + tid; r < e; r += kBlock)
          tsc[r] = sc;
      }
    }
    cp_async_commit();
  };

  // each query's list, threshold and stage count; |q|^2 and 2 sq are
  // read from shared memory where used (broadcasts), which keeps the
  // sweep at 64 registers without spills
  float lk[kQW][RL];
  int lx[kQW][RL];
  float tk[kQW];
  int tx[kQW], cnt[kQW];
#pragma unroll
  for (int qq = 0; qq < kQW; ++qq) {
    list_init<RL>(lk[qq], lx[qq]);
    tk[qq] = -INFINITY;
    tx[qq] = INT_MAX;
    cnt[qq] = 0;
  }
  const int live = min(kQW, B - (q0 + warp * kQW));  // queries < B
  const float* my_x2 = x2s + warp * kQW;
  const float* my_c2 = c2s + warp * kQW;
  float* my_k = stk + warp * kQW * L;
  int* my_x = stx + warp * kQW * L;
  __syncthreads();  // the queries are set

  load(0, r0);
  for (int t0 = r0, buf = 0; t0 < r1; t0 += st, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile t0 is in; the other slot is consumed
    if (t0 + st < r1) load(buf ^ 1, t0 + st);
    const int rows = min(st, r1 - t0);
    const int* tw = tiles + buf * st * rs;
    const float* ty = y2s + buf * st;
    const float* tsc = scs + buf * st;
    for (int rb = 0; rb < rows; rb += 32) {
      const int r = rb + lane;
      const bool valid = r < rows;
      const int rr = valid ? r : 0;
      float d2[kQW];
      if (kInt8) {
        int acc[kQW];
#pragma unroll
        for (int qq = 0; qq < kQW; ++qq) acc[qq] = 0;
        const int* xrow = tw + rr * rs;
        const int4* qrow = reinterpret_cast<const int4*>(qv) + warp * Dw;
        for (int w = 0; w < Dw; ++w) {
          const int xw = xrow[w];
          const int4 qw = qrow[w];
          acc[0] = __dp4a(qw.x, xw, acc[0]);
          acc[1] = __dp4a(qw.y, xw, acc[1]);
          acc[2] = __dp4a(qw.z, xw, acc[2]);
          acc[3] = __dp4a(qw.w, xw, acc[3]);
        }
        const float sc = tsc[rr], y2 = ty[rr];
#pragma unroll
        for (int qq = 0; qq < kQW; ++qq) {
          const float coef = __fmul_rn(my_c2[qq], sc);
          d2[qq] = fmaxf(__fadd_rn(__fsub_rn(my_x2[qq], __fmul_rn(
                                                coef, (float)acc[qq])),
                                   y2),
                         0.0f);
        }
      } else {
        float acc[kQW];
#pragma unroll
        for (int qq = 0; qq < kQW; ++qq) acc[qq] = 0.0f;
        const unsigned* xrow = reinterpret_cast<const unsigned*>(tw) + rr * rs;
        const float4* qrow = reinterpret_cast<const float4*>(qv) + warp * Dw * 2;
        const int full = D / 2;
        for (int w = 0; w < full; ++w) {
          const unsigned xw = xrow[w];
          const float lo = __uint_as_float(xw << 16);
          const float hi = __uint_as_float(xw & 0xffff0000u);
          const float4 a = qrow[2 * w], b = qrow[2 * w + 1];
          acc[0] = __fadd_rn(__fadd_rn(acc[0], __fmul_rn(a.x, lo)),
                             __fmul_rn(a.y, hi));
          acc[1] = __fadd_rn(__fadd_rn(acc[1], __fmul_rn(a.z, lo)),
                             __fmul_rn(a.w, hi));
          acc[2] = __fadd_rn(__fadd_rn(acc[2], __fmul_rn(b.x, lo)),
                             __fmul_rn(b.y, hi));
          acc[3] = __fadd_rn(__fadd_rn(acc[3], __fmul_rn(b.z, lo)),
                             __fmul_rn(b.w, hi));
        }
        if (D & 1) {  // the last coordinate, alone in its word
          const float lo = __uint_as_float(xrow[full] << 16);
          const float4 a = qrow[2 * full], b = qrow[2 * full + 1];
          acc[0] = __fadd_rn(acc[0], __fmul_rn(a.x, lo));
          acc[1] = __fadd_rn(acc[1], __fmul_rn(a.z, lo));
          acc[2] = __fadd_rn(acc[2], __fmul_rn(b.x, lo));
          acc[3] = __fadd_rn(acc[3], __fmul_rn(b.z, lo));
        }
        const float y2 = ty[rr];
#pragma unroll
        for (int qq = 0; qq < kQW; ++qq)
          d2[qq] = fmaxf(
              __fadd_rn(__fsub_rn(my_x2[qq], 2.0f * acc[qq]), y2), 0.0f);
      }
      const int gid = t0 + r;
#pragma unroll
      for (int qq = 0; qq < kQW; ++qq) {
        const bool pass = valid && qq < live &&
                          rk::ahead(-d2[qq], gid, tk[qq], tx[qq]);
        offer<RL>(lk[qq], lx[qq], my_k + qq * L, my_x + qq * L, cnt[qq],
                  tk[qq], tx[qq], pass, -d2[qq], gid, lane, KK);
      }
    }
  }
#pragma unroll
  for (int qq = 0; qq < kQW; ++qq) {
    if (cnt[qq]) fold<RL>(lk[qq], lx[qq], my_k + qq * L, my_x + qq * L,
                          cnt[qq], lane);
    if (qq < live) {
      const size_t out =
          ((size_t)(q0 + warp * kQW + qq) * n_chunks + chunk_id) * KK;
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int i = lane * RL + r;
        if (i < KK) { ws_d2[out + i] = -lk[qq][r]; ws_idx[out + i] = lx[qq][r]; }
      }
    }
  }
}

template <bool kInt8>
inline auto quant_sweep_kernel(int rl) {
  return rl == 1   ? quant_chunk_topk_kernel<kInt8, 1>
         : rl == 2 ? quant_chunk_topk_kernel<kInt8, 2>
         : rl == 4 ? quant_chunk_topk_kernel<kInt8, 4>
                   : quant_chunk_topk_kernel<kInt8, 8>;
}

// Starts launch A' on `stream`; returns cudaGetLastError().
inline int launch_quant_chunk_topk(const float* xq, const void* xdbq,
                                   const float* q_scale, const float* y2q,
                                   int B, int N, int D, int KK, int slab,
                                   bool int8, int chunk, int st, int n_chunks,
                                   float* ws_d2, int* ws_idx,
                                   cudaStream_t stream) {
  const size_t smem = quant_sweep_smem(D, KK, st, int8);
  dim3 grid((B + kQB - 1) / kQB, n_chunks);
  const int rl = list_rl(KK);
  auto kernel = int8 ? quant_sweep_kernel<true>(rl)
                     : quant_sweep_kernel<false>(rl);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, kBlock, smem, stream>>>(xq, xdbq, q_scale, y2q, B, N, D, KK,
                                          slab, chunk, st, n_chunks, ws_d2,
                                          ws_idx);
  return (int)cudaGetLastError();
}

// -- launch B' / B: the merge --------------------------------------------

// Floats of shared memory merge_quant needs (its `work`): merge_lists'
// scratch (the warps' stages and lists), the survivors' d2q, exact d2, y2,
// error and index (KK each), the k winners' d2 and y2, the query row
// and its quantization error (D each) and |q|^2.
__host__ __device__ inline int quant_merge_floats(int D, int k, int KK) {
  return merge_floats(KK) + 5 * KK + 2 * k + 2 * D + 1;
}

// One query's quantized merge, with the whole block: the row's KK
// survivors (merge_lists), the margin guard written to guard_out[row],
// the exact re-score and re-rank to k, then the weights to nw and the
// neighbours' indices to ni (k each). work: quant_merge_floats(D, k, KK)
// floats of shared memory. Ends synced.
template <bool kInt8, int RL>
__device__ inline void merge_quant(
    const float* __restrict__ xq, const void* __restrict__ xdbq,
    const float* __restrict__ q_scale, const float* __restrict__ y2q,
    const float* __restrict__ ws_d2, const int* __restrict__ ws_idx,
    size_t row, int D, int k, int KK, int slab, int n_chunks, float* work,
    float* nw, int* ni, int* guard_out) {
  float* sd = work + merge_floats(32 * RL);
  float* sx = sd + KK;
  float* sy2 = sx + KK;
  float* serr = sy2 + KK;
  int* si = reinterpret_cast<int*>(serr + KK);
  float* nd = reinterpret_cast<float*>(si + KK);
  float* ny2 = nd + k;
  float* qrow = ny2 + k;
  float* erow = qrow + D;
  float* x2_s = erow + D;
  const int tid = threadIdx.x;
  merge_lists<RL>(ws_d2, ws_idx, row, KK, n_chunks, work, sd, si);
  for (int d = tid; d < D; d += blockDim.x) qrow[d] = xq[row * D + d];
  __syncthreads();
  if (tid == 0) {
    *x2_s = sq_norm(qrow, D);
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
    sx[tid] = fmaxf(__fadd_rn(__fsub_rn(*x2_s, 2.0f * cross), y2), 0.0f);
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
  idw_weights(*x2_s, nd, ny2, k, nw);
}

}  // namespace knn
