// knn_topk: the k nearest db rows of each query under squared L2, as
// (d2 ascending, idx), ties to the lower index, in two launches.
//
// Replaces the TPU kernel src/repro/kernels/knn_topk.py::knn_topk_pallas
// (pallas_call at line 129), a db sweep slab by slab on one core with a
// running top-k of -d2 in VMEM scratch. Here:
//
//   Launch A: knn_sweep.cuh's chunked db sweep: partial top-k lists per
//     (query, chunk) into a workspace.
//   Launch B, one block per query: knn_select.cuh's merge_lists writes
//     the k winners' (d2, idx).
//
// So the top-k takes two launches where the TPU took one. The selection
// is, by construction, the one knn_lambda and knn_rank_audited weight.
//
// Bound on an H100: at the serving bucket (B = 32) the db's bytes,
// N * D * 4 read once at 3.35 TB/s; at a large batch the distance FLOPs,
// B * N * (2D + 3), at the fp32 rate. See knn_sweep.cuh for the sweep's
// design; launch B reads only the (B, n_chunks, k) workspace.
#include "knn_sweep.cuh"

// Launch B with lists of L = 32 RL >= k. Shared memory: merge_lists'
// scratch.
template <int RL>
__global__ void __launch_bounds__(knn::kBlock) knn_topk_merge_kernel(
    const float* __restrict__ ws_d2, const int* __restrict__ ws_idx, int k,
    int n_chunks, float* d2_out, int* idx_out) {
  extern __shared__ float smem[];
  __shared__ float od[32 * RL];
  __shared__ int oi[32 * RL];
  const size_t row = blockIdx.x;
  knn::merge_lists<RL>(ws_d2, ws_idx, row, k, n_chunks, smem, od, oi);
  if (threadIdx.x < k) {
    d2_out[row * k + threadIdx.x] = od[threadIdx.x];
    idx_out[row * k + threadIdx.x] = oi[threadIdx.x];
  }
}

// Launches A then B on `stream`. Returns the first nonzero
// cudaGetLastError(), or 0.
extern "C" int knn_topk_launch(const void* xq, const void* xdb,
                               void* ws_d2, void* ws_idx, void* d2_out,
                               void* idx_out, int B, int N, int D, int k,
                               int chunk, int st, int dc, int n_chunks,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = knn::launch_chunk_topk(
      (const float*)xq, (const float*)xdb, B, N, D, k, chunk, st, dc,
      n_chunks, (float*)ws_d2, (int*)ws_idx, s);
  if (err) return err;
  const int rl = knn::list_rl(k);
  auto kernel = rl == 1   ? knn_topk_merge_kernel<1>
                : rl == 2 ? knn_topk_merge_kernel<2>
                : rl == 4 ? knn_topk_merge_kernel<4>
                          : knn_topk_merge_kernel<8>;
  const size_t smem = (size_t)knn::merge_floats(k) * sizeof(float);
  err = knn::allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<B, knn::kBlock, smem, s>>>((const float*)ws_d2,
                                      (const int*)ws_idx, k, n_chunks,
                                      (float*)d2_out, (int*)idx_out);
  return (int)cudaGetLastError();
}
