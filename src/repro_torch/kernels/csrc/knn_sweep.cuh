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
//   Launch A, grid (query tiles x db chunks): a block holds kQT queries
//     in shared memory and streams its chunk of db rows through shared
//     memory with coalesced loads. 8 threads per query each keep a
//     private top-k in registers of (d2 asc, global index asc), with
//     d2 = max(|q|^2 - 2 q.x + |x|^2, 0) in the expanded form of
//     knn_topk.py:170-173, |x|^2 computed per row, and the dot summed
//     coordinate by coordinate with every product and addition rounded
//     on its own (the order kernels/ref.py repeats). The 8 lists merge in
//     shared memory into one partial list per (query, chunk), written to
//     a (B, n_chunks, k) workspace. The db is never padded: the ragged
//     last chunk is masked here.
//   merge_idw, one block per query: merges the partial lists (ties to
//     the lowest global index, merge_lists), reads the k winners' |x|^2
//     and applies _idw_lambda's weights with the exact-match override
//     (d2 <= 1e-6 (|q|^2 + |x|^2 + 1e-12), idw_weights); idw_lam then
//     forms one column of lambda-hat from the winners' lambda rows.
//
// The register lists are templated on their length KM, and every kernel
// is instantiated for KM = 16, 32 and 64: a launch takes the smallest
// that holds k (kKMax = 64 is the most), so k <= 16 runs the code it
// always ran. The d limit is shared memory's: kernels/knn_topk.py's
// sweep_geometry picks the tile and refuses a d for which fewer than 8
// rows fit beside the query tile. idw_weights and idw_lam also serve
// the quantized kernels (knn_quant_sweep.cuh).
#pragma once

#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

namespace knn {

constexpr int kBlock = 256;  // threads per block of both launches
constexpr int kQT = 32;      // KNN_QTILE: queries per block of launch A
constexpr int kSub = 8;      // threads per query in launch A
constexpr int kKMax = 64;    // KNN_MAX_K: neighbours kept per query

// a is nearer than b: a smaller d2, or an equal d2 and a lower index
__device__ __forceinline__ bool nearer(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (d, id) into the sorted register list (bd, bi) of length k <= KM
// and refresh the list's last entry (wd, wi). Loops unroll over KM so
// the list stays in registers.
template <int KM>
__device__ __forceinline__ void insert(float (&bd)[KM], int (&bi)[KM], int k,
                                       float d, int id, float& wd, int& wi) {
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k && nearer(d, id, bd[j], bi[j])) {
      const float td = bd[j];
      const int ti = bi[j];
      bd[j] = d; bi[j] = id;
      d = td; id = ti;
    }
  }
#pragma unroll
  for (int j = 0; j < KM; ++j)
    if (j == k - 1) { wd = bd[j]; wi = bi[j]; }
}

template <int KM>
__device__ __forceinline__ void init_list(float (&bd)[KM], int (&bi)[KM],
                                          float& wd, int& wi) {
#pragma unroll
  for (int j = 0; j < KM; ++j) { bd[j] = INFINITY; bi[j] = INT_MAX; }
  wd = INFINITY;
  wi = INT_MAX;
}

__device__ __forceinline__ float sq_norm(const float* x, int D) {
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) acc = __fadd_rn(acc, __fmul_rn(x[d], x[d]));
  return acc;
}

// Launch A. Shared memory: qs (kQT*D), x2s (kQT), then a region holding
// either the db tile (st*D) and its |x|^2 (st) or, after the sweep, the
// kQT*kSub lists to merge (k floats and k ints each). k <= KM.
template <int KM>
__global__ void __launch_bounds__(kBlock) chunk_topk_kernel(
    const float* __restrict__ xq, const float* __restrict__ xdb, int B,
    int N, int D, int k, int chunk, int st, int n_chunks, float* ws_d2,
    int* ws_idx) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* x2s = qs + kQT * D;
  float* region = x2s + kQT;
  float* dbs = region;
  float* y2s = dbs + st * D;

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
  if (tid < kQT) x2s[tid] = sq_norm(qs + tid * D, D);

  float bd[KM];
  int bi[KM];
  float wd;
  int wi;
  init_list(bd, bi, wd, wi);

  for (int t0 = r0; t0 < r1; t0 += st) {
    const int rows = min(st, r1 - t0);
    __syncthreads();  // the previous tile is consumed
    const float* src = xdb + (size_t)t0 * D;
    for (int i = tid; i < rows * D; i += blockDim.x) dbs[i] = src[i];
    __syncthreads();
    for (int r = tid; r < rows; r += blockDim.x) y2s[r] = sq_norm(dbs + r * D, D);
    __syncthreads();
    if (q < B) {
      const float x2 = x2s[ql];
      const float* qv = qs + ql * D;
      for (int r = sub; r < rows; r += kSub) {
        const float* xv = dbs + r * D;
        float cross = 0.0f;
        for (int d = 0; d < D; ++d)
          cross = __fadd_rn(cross, __fmul_rn(qv[d], xv[d]));
        float d2 = __fadd_rn(__fsub_rn(x2, 2.0f * cross), y2s[r]);
        d2 = fmaxf(d2, 0.0f);
        const int gid = t0 + r;
        if (nearer(d2, gid, wd, wi)) insert(bd, bi, k, d2, gid, wd, wi);
      }
    }
  }
  __syncthreads();  // the db tile region becomes the merge region
  float* md = region;
  int* mi = reinterpret_cast<int*>(md + kQT * kSub * k);
  const int slot = (ql * kSub + sub) * k;
#pragma unroll
  for (int j = 0; j < KM; ++j)
    if (j < k) { md[slot + j] = bd[j]; mi[slot + j] = bi[j]; }
  __syncthreads();
  if (sub == 0 && q < B) {
    for (int s = 1; s < kSub; ++s) {
      const int base = (ql * kSub + s) * k;
      for (int j = 0; j < k; ++j) {
        const float d = md[base + j];
        const int id = mi[base + j];
        if (!nearer(d, id, wd, wi)) break;  // the list is sorted
        insert(bd, bi, k, d, id, wd, wi);
      }
    }
    const size_t out = ((size_t)q * n_chunks + chunk_id) * k;
#pragma unroll
    for (int j = 0; j < KM; ++j)
      if (j < k) { ws_d2[out + j] = bd[j]; ws_idx[out + j] = bi[j]; }
  }
}

// Raise a kernel's dynamic shared-memory limit to `bytes` when its
// static and dynamic shared memory together may pass the default 48 KB
// (the kernels' static arrays take at most a few KB); returns
// cudaGetLastError().
template <typename F>
inline int allow_smem(F* kernel, size_t bytes) {
  if (bytes > 40 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  return (int)cudaGetLastError();
}

// Starts launch A with lists of length KM on `stream`; returns
// cudaGetLastError(). Past 48 KB of tiles (d >= 128 at 256 rows, or
// k = 64's lists) the opt-in attribute allows up to 227 KB.
template <int KM>
inline int launch_chunk_topk_km(const float* xq, const float* xdb, int B,
                                int N, int D, int k, int chunk, int st,
                                int n_chunks, float* ws_d2, int* ws_idx,
                                cudaStream_t stream) {
  const int tile = st * (D + 1), lists = kQT * kSub * k * 2;
  const size_t smem =
      (size_t)(kQT * (D + 1) + (tile > lists ? tile : lists)) * sizeof(float);
  const int err = allow_smem(chunk_topk_kernel<KM>, smem);
  if (err) return err;
  dim3 grid((B + kQT - 1) / kQT, n_chunks);
  chunk_topk_kernel<KM><<<grid, kBlock, smem, stream>>>(
      xq, xdb, B, N, D, k, chunk, st, n_chunks, ws_d2, ws_idx);
  return (int)cudaGetLastError();
}

// The list length that holds k: 16, 32 or 64 (k <= kKMax).
inline int list_len(int k) { return k <= 16 ? 16 : k <= 32 ? 32 : 64; }

inline int launch_chunk_topk(const float* xq, const float* xdb, int B,
                             int N, int D, int k, int chunk, int st,
                             int n_chunks, float* ws_d2, int* ws_idx,
                             cudaStream_t stream) {
  switch (list_len(k)) {
    case 16:
      return launch_chunk_topk_km<16>(xq, xdb, B, N, D, k, chunk, st,
                                      n_chunks, ws_d2, ws_idx, stream);
    case 32:
      return launch_chunk_topk_km<32>(xq, xdb, B, N, D, k, chunk, st,
                                      n_chunks, ws_d2, ws_idx, stream);
    default:
      return launch_chunk_topk_km<64>(xq, xdb, B, N, D, k, chunk, st,
                                      n_chunks, ws_d2, ws_idx, stream);
  }
}

// Floats of dynamic shared memory merge_lists needs for lists of length
// k.
__host__ __device__ inline int merge_smem_floats(int k) {
  return kBlock * k * 2;
}

// Folds one query's n_chunks partial lists of length k <= KM (row `row`
// of the workspace) into its k nearest, with the whole block: each
// thread folds a strided share into its own register list, then a tree
// merge in `smem` (merge_smem_floats(k) floats). Writes the k winners,
// ascending by (d2, index), to od and oi (shared). Ends synced.
template <int KM>
__device__ inline void merge_lists(const float* __restrict__ ws_d2,
                                   const int* __restrict__ ws_idx,
                                   size_t row, int k, int n_chunks,
                                   float* smem, float* od, int* oi) {
  const int tid = threadIdx.x;
  float bd[KM];
  int bi[KM];
  float wd;
  int wi;
  init_list(bd, bi, wd, wi);
  const int total = n_chunks * k;
  const float* rd = ws_d2 + row * total;
  const int* ri = ws_idx + row * total;
  for (int e = tid; e < total; e += blockDim.x) {
    const float d = rd[e];
    const int id = ri[e];
    if (nearer(d, id, wd, wi)) insert(bd, bi, k, d, id, wd, wi);
  }
  float* ld = smem;
  int* li = reinterpret_cast<int*>(ld + blockDim.x * k);
#pragma unroll
  for (int j = 0; j < KM; ++j)
    if (j < k) { ld[tid * k + j] = bd[j]; li[tid * k + j] = bi[j]; }
  __syncthreads();
  // tree merge of sorted lists: list t takes list t + half
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (tid < half) {
      const float* ad = ld + tid * k;
      const int* ai = li + tid * k;
      const float* pd = ld + (tid + half) * k;
      const int* pi = li + (tid + half) * k;
      int p = 0, r = 0;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        if (j < k) {
          if (nearer(ad[p], ai[p], pd[r], pi[r])) {
            bd[j] = ad[p]; bi[j] = ai[p]; ++p;
          } else {
            bd[j] = pd[r]; bi[j] = pi[r]; ++r;
          }
        }
      }
    }
    __syncthreads();
    if (tid < half) {
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < k) { ld[tid * k + j] = bd[j]; li[tid * k + j] = bi[j]; }
    }
    __syncthreads();
  }
  if (tid < k) { od[tid] = ld[tid]; oi[tid] = li[tid]; }
  __syncthreads();
}

// Inverse-distance weights of the k neighbours nd (d2, ascending) with
// |x|^2 ny2 for a query with |q|^2 = x2 (predictors._idw_lambda, same
// order): thread 0 writes the k normalised weights to nw. Ends synced.
__device__ inline void idw_weights(float x2, const float* nd,
                                   const float* ny2, int k, float* nw) {
  if (threadIdx.x == 0) {
    bool any_exact = false;
    for (int j = 0; j < k; ++j) {
      const float scale2 = __fadd_rn(__fadd_rn(x2, ny2[j]), 1e-12f);
      any_exact |= nd[j] <= __fmul_rn(1e-6f, scale2);
    }
    float wsum = 0.0f;
    for (int j = 0; j < k; ++j) {
      float w;
      if (any_exact) {
        const float scale2 = __fadd_rn(__fadd_rn(x2, ny2[j]), 1e-12f);
        w = nd[j] <= __fmul_rn(1e-6f, scale2) ? 1.0f : 0.0f;
      } else {
        w = __fdiv_rn(1.0f, fmaxf(__fsqrt_rn(nd[j]), 1e-12f));
      }
      nw[j] = w;
      wsum = __fadd_rn(wsum, w);
    }
    for (int j = 0; j < k; ++j) nw[j] = __fdiv_rn(nw[j], wsum);
  }
  __syncthreads();
}

// One query's merge + weighting of the f32 sweep, with the whole block:
// the k nearest of the row's partial lists, their |x|^2 recomputed from
// xdb, then the weights to nw and the neighbours' indices to ni
// (shared, KM each). Ends synced.
template <int KM>
__device__ inline void merge_idw(const float* __restrict__ xq,
                                 const float* __restrict__ xdb,
                                 const float* __restrict__ ws_d2,
                                 const int* __restrict__ ws_idx, size_t row,
                                 int D, int k, int n_chunks, float* smem,
                                 float* nw, int* ni) {
  __shared__ float nd[KM], ny2[KM];
  __shared__ float x2_s;
  const int tid = threadIdx.x;
  merge_lists<KM>(ws_d2, ws_idx, row, k, n_chunks, smem, nd, ni);
  if (tid < k) ny2[tid] = sq_norm(xdb + (size_t)ni[tid] * D, D);
  if (tid == blockDim.x - 1) x2_s = sq_norm(xq + row * D, D);
  __syncthreads();
  idw_weights(x2_s, nd, ny2, k, nw);
}

// Column t < Kpred of lambda-hat: the weighted sum of the k winners'
// lambda rows (lamdb is (n_rows, Kpred)), neighbour by neighbour; a
// winner past the last row (a quantized pack's padding) prices 0.
__device__ __forceinline__ float idw_lam(const float* __restrict__ lamdb,
                                         const float* nw, const int* ni,
                                         int k, int Kpred, int t,
                                         int n_rows) {
  float lam = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float l = ni[j] < n_rows ? lamdb[(size_t)ni[j] * Kpred + t] : 0.0f;
    lam = j == 0 ? __fmul_rn(nw[0], l) : __fadd_rn(lam, __fmul_rn(nw[j], l));
  }
  return lam;
}

}  // namespace knn
