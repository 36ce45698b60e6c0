// Shared KNN device code of the port's f32 KNN kernels (knn_topk.cu,
// knn_lambda.cu, knn_rank_audited.cu): the database sweep (launch A),
// the per-query merge of its partial lists and the inverse-distance
// weighting. The kernels run this code verbatim, so on the same queries
// and db they select the same neighbours and their lambda-hat agree
// bitwise.
//
// Replaces the shared bodies of the TPU kernels in
// src/repro/kernels/knn_topk.py (_knn_kernel, _db_slab_merge,
// _idw_lambda_flush), whose grid swept the train db slab by slab on one
// core with a running top-k in VMEM. Blocks here run in parallel and in
// no order, so the sweep is split across blocks:
//
//   Launch A, grid (query tiles of kQB = 32 x db chunks): a warp owns
//     kQW = 4 queries and scores every row of its block's chunk for
//     them, one row a lane. The queries sit in shared memory as
//     [warp][coordinate][query of the warp], so one float4 load gives
//     the warp its four query values; the db's tiles (st rows, a
//     multiple of 32) stream through shared memory by cp.async into a
//     two-stage ring at the odd row stride dc | 1 (a warp's 32 rows on
//     32 banks), one barrier a stage, so stage s+1 lands while stage s
//     is scored. d2 = max(|q|^2 - 2 q.x + |x|^2, 0) in the expanded form
//     of knn_topk.py:170-173, the dot and |x|^2 summed coordinate by
//     coordinate with every product and addition rounded on its own
//     (__fmul_rn, __fadd_rn: no FMA; the order kernels/ref.py repeats),
//     |x|^2 by the lane that owns the row. A row wider than the shared
//     memory holds is scored in pieces of dc coordinates (then st = 32:
//     the lane keeps its row's four cross terms and |x|^2 in registers
//     from piece to piece), so d is bounded by the resident queries
//     only. Selection: knn_select.cuh's warp lists (a query's running
//     top-k spread over its warp's lanes, L = 32 RL >= k, keys -d2; a
//     pair is staged by ballot only if it beats the k-th, a full stage is
//     folded in by the in-warp bitonic network). The warp writes each
//     query's partial list to the (B, n_chunks, k) workspace. The db is
//     never padded: the ragged last chunk and tile are masked here, and
//     a batch that is not a multiple of kQB leaves warps idle.
//   merge_idw, one block per query: knn_select.cuh's merge_lists (the
//     same filter, stage and fold over the row's n_chunks x k pairs,
//     then the eight warps' lists merged), the k winners' |x|^2 read
//     again from the db, and _idw_lambda's weights with the exact-match
//     override (d2 <= 1e-6 (|q|^2 + |x|^2 + 1e-12), knn_select.cuh's
//     idw_weights); idw_lam then forms one column of lambda-hat from the
//     winners' lambda rows.
//
// Why the result stays the plain version's bit for bit: the k winners
// are a set under (d2 asc, index asc), a total order over unique
// indices, that no selection, tiling or chunking changes; only d2's own
// rounded operations must hold, which they do here in the plain
// version's order (the clamp at 0 included; an exact match, key -0.0,
// ties on the key and falls to the index).
//
// Limits: k <= kListMax = 256 (lists of 32, 64, 128, 256: RL = 1, 2,
// 4, 8) and the queries, their |q|^2 and stages and a ring of 32-row
// pieces of at least 32 coordinates within one block's shared memory
// (d <= 1629 at k <= 32). kernels/knn_topk.py's sweep_geometry picks
// st, dc and the chunk (about 4 blocks an SM) and repeats sweep_smem.
//
// Bound on an H100: at the serving bucket the db's bytes (N D 4) read
// once at 3.35 TB/s; at a large batch the distance's operations on the
// f32 pipe (a product and a sum a coordinate, never fused).
#pragma once

#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace knn {

// Bytes of dynamic shared memory launch A needs: the kQB queries (D
// each) and their |q|^2, a stage of L pairs for each query, and two
// ring slots of st rows at the odd stride dc | 1. sweep_geometry in
// kernels/knn_topk.py repeats this sum.
__host__ __device__ inline size_t sweep_smem(int D, int k, int st, int dc) {
  const int L = 32 * list_rl(k);
  return ((size_t)kQB * (D + 1 + 2 * L) + 2 * (size_t)st * (dc | 1)) * 4;
}

// Launch A. st is a multiple of 32 and chunk a multiple of st; dc < D
// (rows in pieces) needs st = 32.
template <int RL>
__global__ void __launch_bounds__(kBlock, RL == 1 ? 4 : 1)
    chunk_topk_kernel(const float* __restrict__ xq,
                      const float* __restrict__ xdb, int B, int N, int D,
                      int k, int chunk, int st, int dc, int n_chunks,
                      float* ws_d2, int* ws_idx) {
  constexpr int L = 32 * RL;
  extern __shared__ __align__(16) float smem[];
  const int rs = dc | 1;
  float* qv = smem;  // [warp][coordinate][query of the warp]
  float* x2s = qv + kQB * D;
  float* tiles = x2s + kQB;
  float* stk = tiles + 2 * st * rs;
  int* stx = reinterpret_cast<int*>(stk + kQB * L);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQB;
  const int chunk_id = blockIdx.y;
  const int r0 = chunk_id * chunk;
  const int r1 = min(N, r0 + chunk);

  // the queries, grouped by warp: query q0 + warp * kQW + qq
  for (int i = tid; i < kQB * D; i += kBlock) {
    const int qq = i % kQW, wc = i / kQW;
    const int q = q0 + (wc / D) * kQW + qq;
    qv[i] = q < B ? xq[(size_t)q * D + wc % D] : 0.0f;
  }
  if (tid < kQB)
    x2s[tid] = q0 + tid < B ? sq_norm(xq + (size_t)(q0 + tid) * D, D) : 0.0f;

  // stage s: rows [t0, t0 + rows) of tile s / np and coordinates
  // [c0, c0 + dcur) of piece s % np, into ring slot s & 1
  const int np = (D + dc - 1) / dc;
  const int n_stages = (r1 - r0 + st - 1) / st * np;
  auto load = [&](int s) {
    const int t = s / np, c0 = (s - t * np) * dc;
    const int t0 = r0 + t * st;
    const int rows = min(st, r1 - t0), dcur = min(dc, D - c0);
    float* tw = tiles + (s & 1) * st * rs;
    const float* src = xdb + (size_t)t0 * D + c0;
    // element (r, j) of the stage, kBlock elements apart
    const int dr = kBlock / dcur, dj = kBlock - dr * dcur;
    int r = tid / dcur, j = tid - r * dcur;
    while (r < rows) {
      cp_async4(tw + r * rs + j, src + (size_t)r * D + j);
      r += dr;
      j += dj;
      if (j >= dcur) { j -= dcur; ++r; }
    }
    cp_async_commit();
  };

  // each query's list, threshold and stage count; |q|^2 is read from
  // shared memory where used (a broadcast), which keeps registers low
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
  const float4* my_q = reinterpret_cast<const float4*>(qv) + warp * D;
  float* my_k = stk + warp * kQW * L;
  int* my_x = stx + warp * kQW * L;
  // a lane's row: the four cross terms and |x|^2, kept across pieces
  float acc[kQW], y2 = 0.0f;
#pragma unroll
  for (int qq = 0; qq < kQW; ++qq) acc[qq] = 0.0f;

  load(0);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s (and, at s = 0, the queries) is in; the
                      // other slot is consumed
    if (s + 1 < n_stages) load(s + 1);
    if (live <= 0) continue;  // a warp past the batch only loads
    const int t = s / np, p = s - t * np;
    const int t0 = r0 + t * st, c0 = p * dc;
    const int rows = min(st, r1 - t0), dcur = min(dc, D - c0);
    const float* tw = tiles + (s & 1) * st * rs;
    for (int rb = 0; rb < rows; rb += 32) {
      const int r = rb + lane;
      const bool valid = r < rows;
      const float* xrow = tw + (valid ? r : 0) * rs;
      const float4* qc = my_q + c0;
      if (p == 0) {
#pragma unroll
        for (int qq = 0; qq < kQW; ++qq) acc[qq] = 0.0f;
        y2 = 0.0f;
      }
      for (int c = 0; c < dcur; ++c) {
        const float x = xrow[c];
        const float4 q = qc[c];
        acc[0] = __fadd_rn(acc[0], __fmul_rn(q.x, x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(q.y, x));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(q.z, x));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(q.w, x));
        y2 = __fadd_rn(y2, __fmul_rn(x, x));
      }
      if (p != np - 1) continue;  // the row's next piece follows
      const int gid = t0 + r;
#pragma unroll
      for (int qq = 0; qq < kQW; ++qq) {
        const float d2 = fmaxf(
            __fadd_rn(__fsub_rn(my_x2[qq], 2.0f * acc[qq]), y2), 0.0f);
        const bool pass =
            valid && qq < live && rk::ahead(-d2, gid, tk[qq], tx[qq]);
        offer<RL>(lk[qq], lx[qq], my_k + qq * L, my_x + qq * L, cnt[qq],
                  tk[qq], tx[qq], pass, -d2, gid, lane, k);
      }
    }
  }
#pragma unroll
  for (int qq = 0; qq < kQW; ++qq) {
    if (cnt[qq]) fold<RL>(lk[qq], lx[qq], my_k + qq * L, my_x + qq * L,
                          cnt[qq], lane);
    if (qq < live) {
      const size_t out =
          ((size_t)(q0 + warp * kQW + qq) * n_chunks + chunk_id) * k;
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int i = lane * RL + r;
        if (i < k) { ws_d2[out + i] = -lk[qq][r]; ws_idx[out + i] = lx[qq][r]; }
      }
    }
  }
}

// Starts launch A on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry the kernel does not take.
inline int launch_chunk_topk(const float* xq, const float* xdb, int B,
                             int N, int D, int k, int chunk, int st, int dc,
                             int n_chunks, float* ws_d2, int* ws_idx,
                             cudaStream_t stream) {
  if (k < 1 || k > kListMax || st % 32 || dc < 1 || dc > D ||
      (dc < D && st != 32))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sweep_smem(D, k, st, dc);
  const int rl = list_rl(k);
  auto kernel = rl == 1   ? chunk_topk_kernel<1>
                : rl == 2 ? chunk_topk_kernel<2>
                : rl == 4 ? chunk_topk_kernel<4>
                          : chunk_topk_kernel<8>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  dim3 grid((B + kQB - 1) / kQB, n_chunks);
  kernel<<<grid, kBlock, smem, stream>>>(xq, xdb, B, N, D, k, chunk, st, dc,
                                         n_chunks, ws_d2, ws_idx);
  return (int)cudaGetLastError();
}

// One query's merge + weighting of the f32 sweep, with the whole block:
// the k nearest of the row's partial lists (merge_lists, its scratch in
// `smem`), their |x|^2 recomputed from xdb, then the weights to nw and
// the neighbours' indices to ni (shared, k each). Ends synced.
template <int RL>
__device__ inline void merge_idw(const float* __restrict__ xq,
                                 const float* __restrict__ xdb,
                                 const float* __restrict__ ws_d2,
                                 const int* __restrict__ ws_idx, size_t row,
                                 int D, int k, int n_chunks, float* smem,
                                 float* nw, int* ni) {
  __shared__ float nd[32 * RL], ny2[32 * RL];
  __shared__ float x2_s;
  const int tid = threadIdx.x;
  merge_lists<RL>(ws_d2, ws_idx, row, k, n_chunks, smem, nd, ni);
  if (tid < k) ny2[tid] = sq_norm(xdb + (size_t)ni[tid] * D, D);
  if (tid == blockDim.x - 1) x2_s = sq_norm(xq + row * D, D);
  __syncthreads();
  idw_weights(x2_s, nd, ny2, k, nw);
}

}  // namespace knn
