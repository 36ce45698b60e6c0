// Shared rank + audit routine of the port's two CUDA kernels.
//
// Replaces the bodies of the TPU kernel fused_rank.rank_audited_pallas
// (src/repro/kernels/fused_rank.py: _merge_scored_tile, _audit_flush),
// which kept a running top-m2 in VMEM with u and a riding along as
// payload. Here one 256-thread block ranks one row:
//
//   * s = u + (1+eps) * sum_k lam_k a_k is formed in the Pallas kernel's
//     order, an unrolled axpy over k (s starts at u and adds
//     ((1+eps) * lam_k) * a_k), not the oracle's einsum, with every
//     product and addition rounded on its own (__fmul_rn/__fadd_rn: no
//     contraction into FMAs), so the plain PyTorch version in
//     kernels/ref.py gives the same bits.
//   * The row's m1 candidates stream through shared memory in tiles. The
//     first tile fills all P slots; every later tile fills the slots
//     after the running top-m2. A bitonic sort of the P (score, index)
//     pairs under the total order (score desc, index asc) leaves the
//     running top-m2 in the first m2 slots: ties go to the lowest index.
//   * At the flush u_sel and a_sel are gathered by index from device
//     memory, (K+1)*m2 reads per row: on this card that is cheaper than
//     carrying the TPU's payload through every merge. The audit sums run
//     slot by slot, as core.ranking.audit_selected does.
//
// Bound on an H100: the row's bytes, (K+1)*m1*4 read once (the gather
// re-reads (K+1)*m2 of them from L2). The sort is O(P log^2 P) compare-
// exchanges in shared memory and is what this simple design spends its
// time on; a warp-level select is later work.
#pragma once

#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

namespace rk {

constexpr int kBlock = 256;     // threads per ranked row
constexpr int kSortMax = 2048;  // SORT_MAX in kernels/common.py
constexpr int kMaxK = 32;       // MAX_KERNEL_K in kernels/common.py

// a ranks ahead of b: a higher score, or an equal score and a lower index
__device__ __forceinline__ bool ahead(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Sorts P (P a power of two) pairs in shared memory, best first.
__device__ inline void bitonic_sort(float* key, int* idx, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int l = i ^ stride;
        if (l > i) {
          const float si = key[i], sl = key[l];
          const int ii = idx[i], il = idx[l];
          const bool best_first = (i & size) == 0;
          const bool swap = best_first ? ahead(sl, il, si, ii)
                                       : ahead(si, ii, sl, il);
          if (swap) {
            key[i] = sl; key[l] = si;
            idx[i] = il; idx[l] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Ranks and audits one row with the whole block. coef (shared, K
// entries) holds (1+eps) * lam_k; key/idx are P-entry shared buffers.
// u: (m1,), a: (K, m1), b: (K,), gamma: (m2,) of this row. Requires
// 1 <= m2 <= m1, m2 < P <= kSortMax, K <= kMaxK. The caller has synced
// after writing coef.
__device__ inline void rank_audit_row(
    const float* __restrict__ u, const float* __restrict__ a,
    const float* coef, const float* __restrict__ b,
    const float* __restrict__ gamma, int m1, int K, int m2, int P,
    float tol, float* key, int* idx, float* vals, int* out_idx,
    float* util, float* expo, int* comp) {
  __shared__ float expo_s[kMaxK];
  for (int start = 0, tile = 0; start < m1; ++tile) {
    const int off = tile == 0 ? 0 : m2;
    const int width = P - off;
    for (int i = threadIdx.x; i < width; i += blockDim.x) {
      const int j = start + i;
      float s = -INFINITY;
      int id = INT_MAX;
      if (j < m1) {
        s = u[j];
        for (int k = 0; k < K; ++k)
          s = __fadd_rn(s, __fmul_rn(coef[k], a[(size_t)k * m1 + j]));
        id = j;
      }
      key[off + i] = s;
      idx[off + i] = id;
    }
    __syncthreads();
    bitonic_sort(key, idx, P);
    start += width;
  }
  for (int j = threadIdx.x; j < m2; j += blockDim.x) {
    vals[j] = key[j];
    out_idx[j] = idx[j];
  }
  const int t = threadIdx.x;
  if (t < K) {
    const float* ak = a + (size_t)t * m1;
    float e = 0.0f;
    for (int j = 0; j < m2; ++j)
      e = __fadd_rn(e, __fmul_rn(ak[idx[j]], gamma[j]));
    expo_s[t] = e;
    expo[t] = e;
  } else if (t == K) {
    float ut = 0.0f;
    for (int j = 0; j < m2; ++j)
      ut = __fadd_rn(ut, __fmul_rn(u[idx[j]], gamma[j]));
    *util = ut;
  }
  __syncthreads();
  if (t == 0) {
    int ok = 1;
    for (int k = 0; k < K; ++k)
      ok &= expo_s[k] >= __fsub_rn(b[k], tol) ? 1 : 0;
    *comp = ok;
  }
}

}  // namespace rk
