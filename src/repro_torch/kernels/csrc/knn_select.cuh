// The device code both KNN sweeps share (knn_sweep.cuh, the f32 db;
// knn_quant_sweep.cuh, the int8 and bf16 packs): the warp-list selection,
// the tile copies, |x|^2, the merge of a query's partial lists that all
// five KNN kernels run after their sweep, and the inverse-distance
// weighting (idw_weights, idw_lam) of the winners.
//
// A query's running top-KK is spread over one warp's 32 lanes: a list of
// L = 32 RL >= KK pairs (key, index), RL a lane, kept sorted best first
// under rank_audit.cuh's rk::ahead (key desc, index asc) with keys -d2,
// so the nearest row leads and ties go to the lower index. A lane
// compares its pair with the list's KK-th; the passing pairs are staged
// in shared memory by ballot (offer), and a full stage (L pairs) or the
// end of the input is sorted by an in-warp bitonic network and merged
// into the list in registers and __shfl_xor_sync (fold), which raises
// the threshold. The KK best pairs are a set under that total order over
// unique indices, so no filter, stage or chunking changes them.
//
// merge_lists, one block a query: each warp filters and folds a strided
// share of the query's n_chunks x KK partial pairs the same way, then
// warp 0 merges the eight warps' lists.
#pragma once

#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "rank_audit.cuh"

namespace knn {

constexpr int kBlock = 256;             // threads per block of every launch
constexpr int kWarps = kBlock / 32;
constexpr int kQW = 4;                  // queries a warp scores together
constexpr int kQB = kWarps * kQW;       // queries a sweep block holds
constexpr int kListMax = 256;           // KNN_MAX_K, KNN_QUANT_MAX_KEEP
static_assert(kListMax <= kBlock, "a thread a list pair in the merges");

// Pairs a lane holds of a list of KK: the list is L = 32 RL >= KK long.
__host__ __device__ inline int list_rl(int KK) {
  return KK <= 32 ? 1 : KK <= 64 ? 2 : KK <= 128 ? 4 : 8;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float sq_norm(const float* x, int D) {
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) acc = __fadd_rn(acc, __fmul_rn(x[d], x[d]));
  return acc;
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

// -- a warp's running top-KK -------------------------------------------
// L = 32 RL pairs (key, index), best first under rk::ahead (key desc,
// index asc), keys -d2; pair i = lane * RL + r lives in register r.

template <int RL>
__device__ __forceinline__ void list_init(float (&k)[RL], int (&x)[RL]) {
#pragma unroll
  for (int r = 0; r < RL; ++r) { k[r] = -INFINITY; x[r] = INT_MAX; }
}

// Sorts the warp's L pairs best first: a bitonic network whose strides
// of RL and more are lane exchanges, the rest register swaps.
template <int RL>
__device__ __forceinline__ void warp_sort(float (&k)[RL], int (&x)[RL],
                                          int lane) {
  constexpr int L = 32 * RL;
#pragma unroll
  for (int size = 2; size <= L; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride >= RL; stride >>= 1)
      rk::shfl_stage<RL>(k, x, lane, size, stride);
    rk::reg_stages<RL, RL / 2>(k, x, lane * RL, size);
  }
}

// The list (k, x) takes the best L of itself and the sorted (ok, ox):
// the better of pair i and the other's pair L-1-i (lane 31-lane's
// register RL-1-r) form a bitonic sequence of exactly those L, which a
// half-cleaner network sorts.
template <int RL>
__device__ __forceinline__ void warp_merge(float (&k)[RL], int (&x)[RL],
                                           const float (&ok)[RL],
                                           const int (&ox)[RL], int lane) {
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    const float b = __shfl_xor_sync(rk::kFull, ok[RL - 1 - r], 31);
    const int bi = __shfl_xor_sync(rk::kFull, ox[RL - 1 - r], 31);
    if (rk::ahead(b, bi, k[r], x[r])) { k[r] = b; x[r] = bi; }
  }
#pragma unroll
  for (int stride = 16 * RL; stride >= RL; stride >>= 1)
    rk::shfl_stage<RL>(k, x, lane, rk::kAllBest, stride);
  rk::reg_stages<RL, RL / 2>(k, x, lane * RL, rk::kAllBest);
}

// Folds the cnt <= L pairs staged in (sk, sx) into the list. Warp-wide.
template <int RL>
__device__ __forceinline__ void fold(float (&k)[RL], int (&x)[RL],
                                     const float* sk, const int* sx,
                                     int cnt, int lane) {
  __syncwarp();  // the staged pairs are written
  float nk[RL];
  int nx[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    const int i = lane * RL + r;
    nk[r] = i < cnt ? sk[i] : -INFINITY;
    nx[r] = i < cnt ? sx[i] : INT_MAX;
  }
  __syncwarp();  // read before the stage refills
  warp_sort<RL>(nk, nx, lane);
  warp_merge<RL>(k, x, nk, nx, lane);
}

// The list's pair at place p (p = KK-1: the threshold), on every lane.
template <int RL>
__device__ __forceinline__ void pair_at(const float (&k)[RL],
                                        const int (&x)[RL], int p,
                                        float& tk, int& tx) {
  float v = k[0];
  int vi = x[0];
#pragma unroll
  for (int r = 1; r < RL; ++r)
    if (r == p % RL) { v = k[r]; vi = x[r]; }
  tk = __shfl_sync(rk::kFull, v, p / RL);
  tx = __shfl_sync(rk::kFull, vi, p / RL);
}

// Stages each lane's pair (key, id) where `pass`, behind the cnt pairs
// already staged; a stage that would overflow is folded first, which
// refreshes the threshold (tk, tx) at place KK-1. Warp-wide.
template <int RL>
__device__ __forceinline__ void offer(float (&k)[RL], int (&x)[RL],
                                      float* sk, int* sx, int& cnt,
                                      float& tk, int& tx, bool pass,
                                      float key, int id, int lane, int KK) {
  const unsigned m = __ballot_sync(rk::kFull, pass);
  if (m == 0) return;
  const int n = __popc(m);
  if (cnt + n > 32 * RL) {
    fold<RL>(k, x, sk, sx, cnt, lane);
    pair_at<RL>(k, x, KK - 1, tk, tx);
    cnt = 0;
  }
  if (pass) {
    const int p = cnt + __popc(m & ((1u << lane) - 1u));
    sk[p] = key;
    sx[p] = id;
  }
  cnt += n;
}

// -- the merge of the partial lists --------------------------------------

// Floats of shared memory merge_lists needs (its `scratch`): the warps'
// stages and lists, 4 kWarps L.
__host__ __device__ inline int merge_floats(int KK) {
  return 4 * kWarps * 32 * list_rl(KK);
}

// The row's KK best pairs from its n_chunks partial lists of KK pairs
// (d2 ascending; row `row` of the (B, n_chunks, KK) workspace), with the
// whole block: each warp filters and folds a strided share of them
// (offer), warp 0 merges the eight warps' lists, and the KK best go
// ascending by (d2, index) to sd and si (shared). scratch:
// merge_floats(KK) floats. Ends synced.
template <int RL>
__device__ inline void merge_lists(const float* __restrict__ ws_d2,
                                   const int* __restrict__ ws_idx,
                                   size_t row, int KK, int n_chunks,
                                   float* scratch, float* sd, int* si) {
  constexpr int L = 32 * RL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* sk = scratch + warp * L;
  int* sx = reinterpret_cast<int*>(scratch + kWarps * L) + warp * L;
  float* lk = scratch + 2 * kWarps * L;
  int* lx = reinterpret_cast<int*>(lk + kWarps * L);
  float k[RL];
  int x[RL];
  list_init<RL>(k, x);
  float tk = -INFINITY;
  int tx = INT_MAX, cnt = 0;
  const int total = n_chunks * KK;
  const float* rd = ws_d2 + row * total;
  const int* ri = ws_idx + row * total;
  for (int base = warp * 32; base < total; base += kBlock) {
    const int e = base + lane;
    const bool valid = e < total;
    const float key = valid ? -rd[e] : -INFINITY;
    const int id = valid ? ri[e] : INT_MAX;
    offer<RL>(k, x, sk, sx, cnt, tk, tx, valid && rk::ahead(key, id, tk, tx),
              key, id, lane, KK);
  }
  if (cnt) fold<RL>(k, x, sk, sx, cnt, lane);
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    lk[warp * L + lane * RL + r] = k[r];
    lx[warp * L + lane * RL + r] = x[r];
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w) {
      rk::merge_top_warp<RL>(lk, lx, lk + w * L, lx + w * L, L);
      __syncwarp();
    }
    for (int i = lane; i < KK; i += 32) { sd[i] = -lk[i]; si[i] = lx[i]; }
  }
  __syncthreads();
}

// -- the weighting ---------------------------------------------------------

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
