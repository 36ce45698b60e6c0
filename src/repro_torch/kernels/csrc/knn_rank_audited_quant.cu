// knn_rank_audited_quant: the whole KNN online stage over the quantized
// db (predict lambda-hat, rank, audit, margin guard) in two launches.
//
// Replaces the TPU kernel src/repro/kernels/knn_topk.py::
// knn_rank_audited_quant_pallas (pallas_call at line 731), whose grid
// swept the int8 or bf16 packed db slab by slab with a running
// top-(k+8), re-scored the survivors exactly at the lambda-hat flush and
// then ran the f32 kernel's rank+audit sweep. Here:
//
//   Launch A': knn_quant_sweep.cuh's chunked sweep over the pack,
//     partial top-(k+8) lists per (query, chunk) into a workspace.
//   Launch B, one block per query, or a cluster of `split` blocks when
//     the batch is smaller than the card: knn_quant_sweep.cuh's
//     merge_quant (merge, guard, exact re-score, re-rank, weights) in
//     every block of the row, lambda-hat kept in shared memory (columns
//     beyond the predictor's width are 0), then rank_audit.cuh's routine
//     on the row.
//
// knn_lambda_quant.cu runs the same two pieces of knn_quant_sweep.cuh,
// so the two kernels' lambda-hat agree bitwise; with a lossless pack
// (dequantized rows equal to the f32 db) the outputs equal
// knn_rank_audited's. Bound on an H100: at the serving bucket the
// pack's bytes and the rank inputs read once at 3.35 TB/s (see
// knn_quant_sweep.cuh).
#include "knn_quant_sweep.cuh"
#include "rank_audit.cuh"

static_assert(knn::kBlock == rk::kBlock, "one block size for both stages");

// Launch B. Shared memory: nw and ni (k each), then merge_quant's work,
// reused by the rank routine's coef, top-L and staging buffer.
template <bool kInt8, int RL>
__global__ void __launch_bounds__(rk::kBlock) knn_rank_audited_quant_kernel(
    const float* __restrict__ xq, const void* __restrict__ xdbq,
    const float* __restrict__ q_scale, const float* __restrict__ y2q,
    const float* __restrict__ lamdb, const float* __restrict__ ws_d2,
    const int* __restrict__ ws_idx, const float* __restrict__ u,
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ gamma, int n_train, int D, int k, int KK,
    int Kpred, int slab, int n_chunks, int m1, int K, int m2, int split,
    float c, float tol, float* vals, int* idx, float* util, float* expo,
    int* comp, float* lam_out, int* guard_out) {
  extern __shared__ float smem[];
  float* nw = smem;
  int* ni = reinterpret_cast<int*>(smem + k);
  float* work = smem + 2 * k;
  const size_t row = blockIdx.x / split;
  const bool first = blockIdx.x % split == 0;

  // every block of a split row writes the same guard
  knn::merge_quant<kInt8, RL>(xq, xdbq, q_scale, y2q, ws_d2, ws_idx, row, D,
                              k, KK, slab, n_chunks, work, nw, ni,
                              guard_out);
  const rk::Smem s = rk::carve(work, K, m2);
  for (int t = threadIdx.x; t < K; t += blockDim.x) {
    // bucket-padded constraint rows beyond the predictor's width get 0
    const float lam =
        t < Kpred ? knn::idw_lam(lamdb, nw, ni, k, Kpred, t, n_train)
                  : 0.0f;
    if (first) lam_out[row * K + t] = lam;
    s.coef[t] = __fmul_rn(c, lam);
  }
  rk::rank_audit_row(u + row * m1, a + row * K * m1, s, b + row * K,
                     gamma + row * m2, m1, K, m2, split, tol,
                     vals + row * m2, idx + row * m2, util + row,
                     expo + row * K, comp + row);
}

template <bool kInt8>
static auto rank_kernel(int rl) {
  return rl == 1   ? knn_rank_audited_quant_kernel<kInt8, 1>
         : rl == 2 ? knn_rank_audited_quant_kernel<kInt8, 2>
         : rl == 4 ? knn_rank_audited_quant_kernel<kInt8, 4>
                   : knn_rank_audited_quant_kernel<kInt8, 8>;
}

// Launches A' then B on `stream`; `int8` picks the storage (1 int8,
// 0 bf16). Returns the first nonzero cudaError_t, or 0.
extern "C" int knn_rank_audited_quant_launch(
    const void* xq, const void* xdbq, const void* q_scale, const void* y2q,
    const void* lamdb, const void* u, const void* a, const void* b,
    const void* gamma, void* ws_d2, void* ws_idx, void* vals, void* idx,
    void* util, void* expo, void* comp, void* lam_out, void* guard_out, int B,
    int N, int n_train, int D, int k, int KK, int Kpred, int slab, int int8,
    int m1, int K, int m2, int split, int chunk, int st, int n_chunks,
    float c, float tol, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = knn::launch_quant_chunk_topk(
      (const float*)xq, xdbq, (const float*)q_scale, (const float*)y2q, B, N,
      D, KK, slab, int8 != 0, chunk, st, n_chunks, (float*)ws_d2,
      (int*)ws_idx, s);
  if (err) return err;
  const size_t merge =
      (size_t)knn::quant_merge_floats(D, k, KK) * sizeof(float);
  const size_t rank = rk::smem_bytes(K, m2);
  const int rl = knn::list_rl(KK);
  auto kernel = int8 ? rank_kernel<true>(rl) : rank_kernel<false>(rl);
  return rk::launch_rows(
      kernel, B, split, 2 * k * sizeof(float) + (merge > rank ? merge : rank),
      s, (const float*)xq, xdbq, (const float*)q_scale, (const float*)y2q,
      (const float*)lamdb, (const float*)ws_d2, (const int*)ws_idx,
      (const float*)u, (const float*)a, (const float*)b,
      (const float*)gamma, n_train, D, k, KK, Kpred, slab, n_chunks, m1, K,
      m2, split, c, tol, (float*)vals, (int*)idx, (float*)util, (float*)expo,
      (int*)comp, (float*)lam_out, (int*)guard_out);
}
