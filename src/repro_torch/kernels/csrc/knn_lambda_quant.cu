// knn_lambda_quant: the quantized KNN predictor's lambda-hat (B, K_pred)
// and margin guard (B,) in two launches.
//
// Replaces the TPU kernel src/repro/kernels/knn_topk.py::
// knn_lambda_quant_pallas (pallas_call at line 426): the sweep over the
// int8 or bf16 packed db with a running top-(k+8), then at the last
// slab the exact f32 re-score of the survivors, the re-rank to k, the
// margin guard and the inverse-distance weighting, writing lambda-hat
// and the guard. It serves ops.knn_lambda(quant=...) and the knn_chain
// route of a quantized predictor (knn_lambda_quant, then rank_audited),
// the parity partner of the fused knn_rank_audited_quant.
//
//   Launch A': knn_quant_sweep.cuh's chunked sweep over the pack.
//   Launch B', one block per query: knn_quant_sweep.cuh's merge_quant,
//     the very routine knn_rank_audited_quant's launch B runs, then
//     thread t < K_pred writes column t of lambda-hat.
//
// So this kernel's lambda-hat and knn_rank_audited_quant's `lam` output
// come from the same code and agree bitwise on the same queries and
// pack. Bound on an H100: at the serving bucket the pack's bytes read
// once at 3.35 TB/s; at a large batch the dot at the int8 or bf16 peak
// plus the f32 epilogue (see knn_quant_sweep.cuh).
#include "knn_quant_sweep.cuh"

// Launch B'. Shared memory: nw and ni (k each), then merge_quant's
// work.
template <bool kInt8, int RL>
__global__ void __launch_bounds__(knn::kBlock) knn_lambda_quant_kernel(
    const float* __restrict__ xq, const void* __restrict__ xdbq,
    const float* __restrict__ q_scale, const float* __restrict__ y2q,
    const float* __restrict__ lamdb, const float* __restrict__ ws_d2,
    const int* __restrict__ ws_idx, int n_train, int D, int k, int KK,
    int Kpred, int slab, int n_chunks, float* lam_out, int* guard_out) {
  extern __shared__ float smem[];
  float* nw = smem;
  int* ni = reinterpret_cast<int*>(smem + k);
  const size_t row = blockIdx.x;
  knn::merge_quant<kInt8, RL>(xq, xdbq, q_scale, y2q, ws_d2, ws_idx, row, D,
                              k, KK, slab, n_chunks, smem + 2 * k, nw, ni,
                              guard_out);
  for (int t = threadIdx.x; t < Kpred; t += blockDim.x)
    lam_out[row * Kpred + t] =
        knn::idw_lam(lamdb, nw, ni, k, Kpred, t, n_train);
}

template <bool kInt8>
static auto merge_kernel(int rl) {
  return rl == 1   ? knn_lambda_quant_kernel<kInt8, 1>
         : rl == 2 ? knn_lambda_quant_kernel<kInt8, 2>
         : rl == 4 ? knn_lambda_quant_kernel<kInt8, 4>
                   : knn_lambda_quant_kernel<kInt8, 8>;
}

// Launches A' then B' on `stream`; `int8` picks the storage (1 int8,
// 0 bf16). Returns the first nonzero cudaGetLastError(), or 0.
extern "C" int knn_lambda_quant_launch(
    const void* xq, const void* xdbq, const void* q_scale, const void* y2q,
    const void* lamdb, void* ws_d2, void* ws_idx, void* lam_out,
    void* guard_out, int B, int N, int n_train, int D, int k, int KK,
    int Kpred, int slab, int int8, int chunk, int st, int n_chunks,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = knn::launch_quant_chunk_topk(
      (const float*)xq, xdbq, (const float*)q_scale, (const float*)y2q, B, N,
      D, KK, slab, int8 != 0, chunk, st, n_chunks, (float*)ws_d2,
      (int*)ws_idx, s);
  if (err) return err;
  const size_t smem =
      (size_t)(2 * k + knn::quant_merge_floats(D, k, KK)) * sizeof(float);
  const int rl = knn::list_rl(KK);
  auto kernel = int8 ? merge_kernel<true>(rl) : merge_kernel<false>(rl);
  err = knn::allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<B, knn::kBlock, smem, s>>>(
      (const float*)xq, xdbq, (const float*)q_scale, (const float*)y2q,
      (const float*)lamdb, (const float*)ws_d2, (const int*)ws_idx, n_train,
      D, k, KK, Kpred, slab, n_chunks, (float*)lam_out, (int*)guard_out);
  return (int)cudaGetLastError();
}
