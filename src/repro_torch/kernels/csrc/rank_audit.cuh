// Shared rank + audit routine of the port's CUDA rank kernels
// (fused_rank.cu, rank_audited.cu, linear_rank_audited.cu and the second
// launch of knn_rank_audited.cu and knn_rank_audited_quant.cu).
//
// Replaces the bodies of the TPU kernel fused_rank.rank_audited_pallas
// (src/repro/kernels/fused_rank.py: _merge_scored_tile, _audit_flush),
// which kept a running top-m2 in VMEM with u and a riding along as
// payload, and of fused_rank_pallas (_fused_rank_kernel), the same top-m2
// without the payload. Here a row's m1 candidates are split into `split`
// contiguous slices, one 256-thread block each (rank_row), and the
// audited kernels then audit the row (audit_row):
//
//   * s = u + (1+eps) * sum_k lam_k a_k is formed in registers in the
//     Pallas kernel's order, an unrolled axpy over k (s starts at u and
//     adds ((1+eps) * lam_k) * a_k), not the oracle's einsum, with every
//     product and addition rounded on its own (__fmul_rn/__fadd_rn: no
//     contraction into FMAs), so the plain PyTorch version in
//     kernels/ref.py gives the same bits.
//   * Filter before sorting. A block keeps its running top-L (L = m2
//     rounded up to a power of two) sorted in shared memory under the
//     total order (score desc, index asc) and scores its slice in tiles
//     of kTile candidates. A candidate is kept only if it ranks ahead of
//     the running m2-th pair; warp ballots and per-warp counts compact
//     the kept ones into a staging buffer. After the first tile (one
//     candidate a thread), when kFlush pairs are staged, and at the end
//     of the slice, the staged pairs are sorted and the best L merged
//     into the top-L (a bitonic merge of 2L pairs, not a re-sort), which
//     raises the threshold; flushing early keeps each sort small. On random scores about
//     m2 (1 + ln(m1 / m2)) candidates are ever staged; if the scores
//     rise with the index every candidate is, and the routine is slower
//     but no less right.
//   * Sorts and merges run in registers: a thread holds R pairs; the
//     compare-exchange stages whose stride is below 32 R stay in the
//     warp (registers and __shfl_xor_sync), and only the wider strides
//     go through shared memory with a barrier (6 of a sort's 55 stages
//     at 1024 pairs).
//   * A batch smaller than the card splits each row over up to 8 blocks
//     (MAX_SPLIT in kernels/fused_rank.py) that form one thread-block
//     cluster (launch_rows). Every
//     block forms the same coef from the same inputs, ranks its slice,
//     and the cluster's rank 0 merges the others' top-L lists over
//     distributed shared memory, writes the row's top-m2 and audits it.
//     One launch per call, whatever the split.
//   * The audit gathers the winners' u and a into the then free staging
//     buffer with the whole block, then sums slot by slot in rank order,
//     as core.ranking.audit_selected does.
//
// Why the result is bitwise the plain version's: the top-m2 is a set
// under a total order that tiling, filtering and splitting do not change
// (indices are unique), the scores are the same rounded operations, and
// the audit sums in the same order.
//
// Bound on an H100: the bytes of u and a, (K+1)*m1*4 a row, read once
// (the audit re-reads (K+1)*m2 of them from L2). The time goes to
// streaming u and a (4 candidates a thread, the loads of four constraint
// rows issued together); the sorts touch only the few staged pairs.
#pragma once

#include <climits>
#include <cmath>
#include <cstddef>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace rk {

namespace cg = cooperative_groups;

constexpr int kBlock = 256;             // threads per block
constexpr int kWarps = kBlock / 32;
constexpr int kE = 4;                   // candidates a thread scores a tile
constexpr int kTile = kBlock * kE;      // candidates a block scores a tile
constexpr int kFlush = kBlock;          // staged pairs that force a flush
constexpr int kStage = 2048;            // RANK_STAGE in kernels/fused_rank.py
static_assert(kFlush + kTile <= kStage, "a tile fits beside the staged");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAllBest = 1 << 30;       // a merge's direction: best first

// a ranks ahead of b: a higher score, or an equal score and a lower index
__device__ __forceinline__ bool ahead(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// L: the running list's length, m2 rounded up to a power of two.
__host__ __device__ inline int top_width(int m2) {
  int L = 1;
  while (L < m2) L <<= 1;
  return L;
}

// Dynamic shared memory of a rank block: coef[K], the top-L (scores,
// indices), the staging buffer (scores, indices) and two sets of per-warp
// counts. rank_smem_bytes in kernels/fused_rank.py repeats this sum.
__host__ __device__ inline size_t smem_bytes(int K, int m2) {
  return (size_t)(K + 2 * top_width(m2) + 2 * kStage + 2 * kWarps) * 4;
}

struct Smem {
  float* coef;   // (1+eps) * lambda_k, K entries
  float* top_s;  // running top-L, best first
  int* top_i;
  float* stg_s;  // staged pairs; stg_s and stg_i are 2 kStage contiguous words
  int* stg_i;
  int* wcnt;     // kept count of each warp, two sets by tile parity
};

__device__ inline Smem carve(float* base, int K, int m2) {
  const int L = top_width(m2);
  Smem s;
  s.coef = base;
  s.top_s = base + K;
  s.top_i = reinterpret_cast<int*>(s.top_s + L);
  s.stg_s = reinterpret_cast<float*>(s.top_i + L);
  s.stg_i = reinterpret_cast<int*>(s.stg_s + kStage);
  s.wcnt = s.stg_i + kStage;
  return s;
}

// One compare-exchange slot: this slot holds (k, x), its partner (ok, ox);
// the slot keeps the better pair if want_better, else the worse.
__device__ __forceinline__ void keep(float& k, int& x, float ok, int ox,
                                     bool want_better) {
  if (ahead(k, x, ok, ox) != want_better) { k = ok; x = ox; }
}

// The stages of stride S, S/2, ..., 1 (each below `size`) between pairs
// one thread holds: pair i = base + r lives in register r.
template <int R, int S>
__device__ __forceinline__ void reg_stages(float (&k)[R], int (&x)[R],
                                           int base, int size) {
  if constexpr (S > 0) {
    if (S < size) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((r & S) == 0) {
          const int l = r | S;
          const bool best_first = ((base + r) & size) == 0;
          const bool swap = best_first ? ahead(k[l], x[l], k[r], x[r])
                                       : ahead(k[r], x[r], k[l], x[l]);
          if (swap) {
            const float tk = k[r]; k[r] = k[l]; k[l] = tk;
            const int tx = x[r]; x[r] = x[l]; x[l] = tx;
          }
        }
      }
    }
    reg_stages<R, S / 2>(k, x, base, size);
  }
}

// One stage of stride R <= stride < 32 R: the partner of pair t*R + r is
// the same register of lane t ^ (stride / R).
template <int R>
__device__ __forceinline__ void shfl_stage(float (&k)[R], int (&x)[R], int t,
                                           int size, int stride) {
  const int m = stride / R;
  const bool lower = (t & m) == 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float ok = __shfl_xor_sync(kFull, k[r], m);
    const int ox = __shfl_xor_sync(kFull, x[r], m);
    keep(k[r], x[r], ok, ox, lower == (((t * R + r) & size) == 0));
  }
}

// One stage of stride >= 32 R, across warps through shared memory.
template <int R>
__device__ inline void smem_stage(float (&k)[R], int (&x)[R], float* ss,
                                  int* si, int t, int size, int stride) {
#pragma unroll
  for (int r = 0; r < R; ++r) { ss[t * R + r] = k[r]; si[t * R + r] = x[r]; }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = t * R + r, l = i ^ stride;
    keep(k[r], x[r], ss[l], si[l], ((i & stride) == 0) == ((i & size) == 0));
  }
  __syncthreads();
}

// Sorts the first `count` (<= kBlock * R) pairs of (ss, si) with the whole
// block, best first (a bitonic sort of kBlock * R pairs, the rest padded
// with (-inf, INT_MAX)), and writes the best L back to the first L
// slots. Ends synced.
template <int R>
__device__ void sort_staged(float* ss, int* si, int count, int L) {
  const int t = threadIdx.x;
  float k[R];
  int x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = t * R + r;
    k[r] = i < count ? ss[i] : -INFINITY;
    x[r] = i < count ? si[i] : INT_MAX;
  }
  __syncthreads();
  constexpr int N = kBlock * R;
  for (int size = 2; size <= N; size <<= 1) {
    int stride = size >> 1;
    for (; stride >= 32 * R; stride >>= 1)
      smem_stage<R>(k, x, ss, si, t, size, stride);
    for (; stride >= R; stride >>= 1) shfl_stage<R>(k, x, t, size, stride);
    reg_stages<R, R / 2>(k, x, t * R, size);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = t * R + r;
    if (i < L) { ss[i] = k[r]; si[i] = x[r]; }
  }
  __syncthreads();
}

__device__ inline void sort_staged_any(float* ss, int* si, int count, int L) {
  if (count <= kBlock) sort_staged<1>(ss, si, count, L);
  else if (count <= 2 * kBlock) sort_staged<2>(ss, si, count, L);
  else if (count <= 4 * kBlock) sort_staged<4>(ss, si, count, L);
  else sort_staged<8>(ss, si, count, L);
}

// One warp: the top-L (ts, ti), best first, takes the best L of itself
// and cand (cs, ci), L pairs best first. The better of ts[i] and
// cs[L-1-i] form a bitonic sequence holding exactly those L, which a
// half-cleaner network sorts. cand may lie in another block's shared
// memory (a cluster rank's). Pair i = lane * RL + r; L <= 32 RL.
template <int RL>
__device__ void merge_top_warp(float* ts, int* ti, const float* cs,
                               const int* ci, int L) {
  const int lane = threadIdx.x & 31;
  float k[RL];
  int x[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    const int i = lane * RL + r;
    k[r] = -INFINITY;
    x[r] = INT_MAX;
    if (i < L) {
      const float a = ts[i], b = cs[L - 1 - i];
      const int ai = ti[i], bi = ci[L - 1 - i];
      const bool take_b = ahead(b, bi, a, ai);
      k[r] = take_b ? b : a;
      x[r] = take_b ? bi : ai;
    }
  }
  for (int stride = L >> 1; stride >= RL; stride >>= 1)
    shfl_stage<RL>(k, x, lane, kAllBest, stride);
  reg_stages<RL, RL / 2>(k, x, lane * RL, kAllBest);
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    const int i = lane * RL + r;
    if (i < L) { ts[i] = k[r]; ti[i] = x[r]; }
  }
}

// Called by one whole warp. L is a power of two <= 128.
__device__ inline void merge_top(float* ts, int* ti, const float* cs,
                                 const int* ci, int L) {
  if (L <= 32) merge_top_warp<1>(ts, ti, cs, ci, L);
  else if (L == 64) merge_top_warp<2>(ts, ti, cs, ci, L);
  else merge_top_warp<4>(ts, ti, cs, ci, L);
}

// Folds the `count` staged pairs into the top-L: sort them, keep their
// best L, merge. All threads, count uniform. Ends synced.
__device__ inline void flush(const Smem& s, int count, int L) {
  __syncthreads();  // the staged pairs are written
  sort_staged_any(s.stg_s, s.stg_i, count, L);
  if (threadIdx.x < 32) merge_top(s.top_s, s.top_i, s.stg_s, s.stg_i, L);
  __syncthreads();
}

// Ranks one row with the `split` blocks of a cluster (split = 1: this
// block alone): this block takes slice cluster rank of the m1 candidates.
// s.coef holds (1+eps) * lam_k, written by the caller before the call
// (rank_row's first barrier publishes it). u: (m1,), a: (K, m1) of this
// row. Requires 1 <= m2 <= m1, m2 <= 128. Returns true in the block that
// holds the row's result (the cluster's rank 0) after it wrote the top-m2
// to vals and out_idx and left their indices in s.top_i[0, m2); the
// other blocks return false and may exit. Ends synced.
__device__ inline bool rank_row(const float* __restrict__ u,
                                const float* __restrict__ a, const Smem& s,
                                int m1, int K, int m2, int split, float* vals,
                                int* out_idx) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int L = top_width(m2);
  const int part = split > 1 ? (int)cg::this_cluster().block_rank() : 0;
  for (int i = t; i < L; i += kBlock) {
    s.top_s[i] = -INFINITY;
    s.top_i[i] = INT_MAX;
  }
  __syncthreads();
  const int per = (m1 + split - 1) / split;
  const int lo = min(m1, part * per), hi = min(m1, lo + per);
  const unsigned below = (1u << lane) - 1u;
  int staged = 0, parity = 0;
  // the first tile scores one candidate a thread and is flushed at once,
  // so the threshold is set from kBlock candidates before the rest come
  for (int base = lo, end = lo; base < hi; base = end, parity ^= 1) {
    const bool first = base == lo;
    end = min(hi, base + (first ? kBlock : kTile));
    const float thr_s = s.top_s[m2 - 1];
    const int thr_i = s.top_i[m2 - 1];
    float sc[kE];
    int j[kE];
    bool ok[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      j[e] = base + e * kBlock + t;
      ok[e] = j[e] < end;
      sc[e] = ok[e] ? u[j[e]] : 0.0f;
    }
    int k = 0;
    for (; k + 4 <= K; k += 4) {  // four rows' loads in flight together
      float v[4][kE];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < kE; ++e)
          v[q][e] = ok[e] ? a[(size_t)(k + q) * m1 + j[e]] : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float c = s.coef[k + q];
#pragma unroll
        for (int e = 0; e < kE; ++e)
          sc[e] = __fadd_rn(sc[e], __fmul_rn(c, v[q][e]));
      }
    }
    for (; k < K; ++k) {
      const float c = s.coef[k];
#pragma unroll
      for (int e = 0; e < kE; ++e)
        if (ok[e]) sc[e] = __fadd_rn(sc[e], __fmul_rn(c, a[(size_t)k * m1 + j[e]]));
    }
    unsigned m[kE];
    int kept = 0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      ok[e] = ok[e] && ahead(sc[e], j[e], thr_s, thr_i);
      m[e] = __ballot_sync(kFull, ok[e]);
      kept += __popc(m[e]);
    }
    // a warp's count goes to this tile's set; the other set may still be
    // read by a slower warp for the previous tile
    int* wc = s.wcnt + parity * kWarps;
    if (lane == 0) wc[warp] = kept;
    __syncthreads();
    int pos = staged, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wc[w];
      pos += w < warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (ok[e]) {
        const int p = pos + __popc(m[e] & below);
        s.stg_s[p] = sc[e];
        s.stg_i[p] = j[e];
      }
      pos += __popc(m[e]);
    }
    staged += total;  // uniform over the block
    if (first || staged >= kFlush) {
      flush(s, staged, L);
      staged = 0;
    }
  }
  if (staged) flush(s, staged, L);
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every slice's top-L is final
    if (part == 0 && t < 32) {
      for (int r = 1; r < split; ++r) {
        merge_top(s.top_s, s.top_i, cluster.map_shared_rank(s.top_s, r),
                  cluster.map_shared_rank(s.top_i, r), L);
        __syncwarp();
      }
    }
    cluster.sync();  // no block exits while rank 0 reads its list
    if (part != 0) return false;
  }
  for (int i = t; i < m2; i += kBlock) {
    vals[i] = s.top_s[i];
    out_idx[i] = s.top_i[i];
  }
  return true;
}

// The audit epilogue of a ranked row: u, a, b and gamma of this row and
// the block's shared memory after rank_row (s.top_i[0, m2) the winners'
// indices; the staging buffer and s.top_s are free and take the gathered
// values and gamma). The whole block gathers the winners' values of as
// many constraint rows as fit (u as row K), then one thread a row sums
// slot by slot: exposure_t for t < K, the utility for t = K. compliant
// is the AND over the K rows of exposure_t >= b_t - tol. Ends synced.
__device__ inline void audit_row(const float* __restrict__ u,
                                 const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 const float* __restrict__ gamma, int m1,
                                 int K, int m2, float tol, const Smem& s,
                                 float* util, float* expo, int* comp) {
  const int t = threadIdx.x;
  const int* sel = s.top_i;
  float* buf = s.stg_s;              // 2 kStage words
  float* gam = s.top_s;              // L >= m2 words
  const int rows = 2 * kStage / m2;  // >= 32: m2 <= 128
  int ok = 1;
  for (int r0 = 0; r0 <= K; r0 += rows) {
    const int nr = min(rows, K + 1 - r0);
    __syncthreads();  // the previous rows' sums (or rank_row's reads) are done
    if (r0 == 0)
      for (int jj = t; jj < m2; jj += kBlock) gam[jj] = gamma[jj];
    for (int e = t; e < nr * m2; e += kBlock) {
      const int r = r0 + e / m2;
      const float* src = r < K ? a + (size_t)r * m1 : u;
      buf[e] = src[sel[e % m2]];
    }
    __syncthreads();
    for (int q = t; q < nr; q += kBlock) {
      const float* v = buf + q * m2;
      float acc = 0.0f;
      for (int jj = 0; jj < m2; ++jj)
        acc = __fadd_rn(acc, __fmul_rn(v[jj], gam[jj]));
      const int r = r0 + q;
      if (r < K) {
        expo[r] = acc;
        ok &= acc >= __fsub_rn(b[r], tol) ? 1 : 0;
      } else {
        *util = acc;
      }
    }
  }
  ok = __syncthreads_and(ok);
  if (t == 0) *comp = ok;
}

// Ranks and audits one row: rank_row, then audit_row in the block that
// holds the result. b: (K,), gamma: (m2,) of this row; the rest as
// rank_row.
__device__ inline void rank_audit_row(
    const float* __restrict__ u, const float* __restrict__ a, const Smem& s,
    const float* __restrict__ b, const float* __restrict__ gamma, int m1,
    int K, int m2, int split, float tol, float* vals, int* out_idx,
    float* util, float* expo, int* comp) {
  if (rank_row(u, a, s, m1, K, m2, split, vals, out_idx))
    audit_row(u, a, b, gamma, m1, K, m2, tol, s, util, expo, comp);
}

// Launches `kernel` over n rows, each over `split` blocks of kBlock
// threads that form one cluster (grid x = n * split: the row is
// blockIdx.x / split), with `smem` bytes of dynamic shared memory,
// raising the kernel's limit past the default first. Returns the first
// nonzero CUDA error, or 0.
template <typename... Params, typename... Args>
inline int launch_rows(void (*kernel)(Params...), int n, int split,
                       size_t smem, cudaStream_t stream, Args... args) {
  if (smem > 40 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * (unsigned)split, 1, 1);
  cfg.blockDim = dim3(kBlock, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace rk
