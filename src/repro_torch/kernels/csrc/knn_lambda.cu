// knn_lambda: the KNN predictor's lambda-hat (B, K_pred) in two launches.
//
// Replaces the TPU kernel src/repro/kernels/knn_topk.py::
// knn_lambda_pallas (pallas_call at line 253): a db sweep with a running
// top-k carrying each neighbour's lambda row and |x|^2, then the
// inverse-distance weighting at the last slab, writing only lambda-hat.
// It serves ops.knn_lambda and the knn_chain route (knn_lambda, then
// rank_audited), the parity partner of the fused knn_rank_audited.
//
//   Launch A: knn_sweep.cuh's chunked db sweep, unchanged.
//   Launch B', one block per query: knn_sweep.cuh's merge + weighting,
//     the very routine knn_rank_audited's launch B runs, then thread t <
//     K_pred writes column t of lambda-hat.
//
// So this kernel's lambda-hat and knn_rank_audited's `lam` output come
// from the same code and agree bitwise on the same queries and db.
//
// Bound on an H100: at the serving bucket (B = 32) the db's bytes,
// N * D * 4 read once at 3.35 TB/s; at a large batch the distance FLOPs,
// B * N * (2D + 3), at the fp32 rate. Launch A holds the query tile and
// the db tile in shared memory (see knn_sweep.cuh); launch B' reads only
// the (B, n_chunks, k) workspace and the k winners' rows.
#include "knn_sweep.cuh"

// Launch B'. Shared memory: the lists of the tree merge.
__global__ void __launch_bounds__(knn::kBlock) knn_lambda_kernel(
    const float* __restrict__ xq, const float* __restrict__ xdb,
    const float* __restrict__ lamdb, const float* __restrict__ ws_d2,
    const int* __restrict__ ws_idx, int N, int D, int k, int Kpred,
    int n_chunks, float* lam_out) {
  extern __shared__ float smem[];
  __shared__ float nw[knn::kKMax];
  __shared__ int ni[knn::kKMax];
  const size_t row = blockIdx.x;
  knn::merge_idw(xq, xdb, ws_d2, ws_idx, row, D, k, n_chunks, smem, nw, ni);
  for (int t = threadIdx.x; t < Kpred; t += blockDim.x)
    lam_out[row * Kpred + t] = knn::idw_lam(lamdb, nw, ni, k, Kpred, t, N);
}

// Launches A then B' on `stream`. Returns the first nonzero
// cudaGetLastError(), or 0.
extern "C" int knn_lambda_launch(const void* xq, const void* xdb,
                                 const void* lamdb, void* ws_d2,
                                 void* ws_idx, void* lam_out, int B, int N,
                                 int D, int k, int Kpred, int chunk, int st,
                                 int n_chunks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = knn::launch_chunk_topk((const float*)xq, (const float*)xdb, B, N,
                                   D, k, chunk, st, n_chunks, (float*)ws_d2,
                                   (int*)ws_idx, s);
  if (err) return err;
  const size_t smem = (size_t)knn::merge_smem_floats(k) * sizeof(float);
  knn_lambda_kernel<<<B, knn::kBlock, smem, s>>>(
      (const float*)xq, (const float*)xdb, (const float*)lamdb,
      (const float*)ws_d2, (const int*)ws_idx, N, D, k, Kpred, n_chunks,
      (float*)lam_out);
  return (int)cudaGetLastError();
}
