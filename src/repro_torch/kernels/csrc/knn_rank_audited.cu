// knn_rank_audited: the whole KNN online stage (predict lambda-hat,
// rank, audit) in two launches.
//
// Replaces the TPU kernel src/repro/kernels/knn_topk.py::
// knn_rank_audited_pallas (pallas_call at line 574), whose grid swept the
// train db slab by slab on one core, kept a running top-k with each
// neighbour's lambda row and |x|^2 as payload, weighted at the last slab
// and then ran the rank+audit sweep. Here:
//
//   Launch A: knn_sweep.cuh's chunked db sweep, partial top-k lists per
//     (query, chunk) into a workspace.
//   Launch B, one block per query, or a cluster of `split` blocks when
//     the batch is smaller than the card: knn_sweep.cuh's merge +
//     weighting in every block of the row (the same inputs, so the same
//     bits), lambda-hat kept in shared memory (columns beyond the
//     predictor's width are 0), then rank_audit.cuh's routine on the row.
//
// So the KNN route takes two launches per micro-batch where the TPU took
// one; fusing them is later work. knn_lambda.cu runs the same two pieces
// of knn_sweep.cuh, so the two kernels' lambda-hat agree bitwise.
//
// Bound on an H100: at the serving bucket (B = 32) the db's bytes,
// N * D * 4 read once at 3.35 TB/s; at a large batch the distance
// FLOPs, B * N * (2D + 3), at the fp32 rate. The sweep keeps both the
// query tile and a ring of db tiles in shared memory, so each db byte is
// read from device memory once per query tile, and query tiles of one
// chunk run next to each other (grid x is the query tile) so a chunk is
// reused from L2.
#include "knn_sweep.cuh"
#include "rank_audit.cuh"

static_assert(knn::kBlock == rk::kBlock, "one block size for both stages");

// Launch B. Shared memory: first merge_lists' scratch, then, reused,
// the rank routine's coef, top-L and staging buffer. Lists of
// L = 32 RL >= k.
template <int RL>
__global__ void __launch_bounds__(rk::kBlock) knn_rank_audited_kernel(
    const float* __restrict__ xq, const float* __restrict__ xdb,
    const float* __restrict__ lamdb, const float* __restrict__ ws_d2,
    const int* __restrict__ ws_idx, const float* __restrict__ u,
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ gamma, int N, int D, int k, int Kpred,
    int n_chunks, int m1, int K, int m2, int split, float c, float tol,
    float* vals, int* idx, float* util, float* expo, int* comp,
    float* lam_out) {
  extern __shared__ float smem[];
  __shared__ float nw[32 * RL];
  __shared__ int ni[32 * RL];
  const size_t row = blockIdx.x / split;
  const bool first = blockIdx.x % split == 0;

  knn::merge_idw<RL>(xq, xdb, ws_d2, ws_idx, row, D, k, n_chunks, smem, nw,
                     ni);
  const rk::Smem s = rk::carve(smem, K, m2);
  for (int t = threadIdx.x; t < K; t += blockDim.x) {
    // bucket-padded constraint rows beyond the predictor's width get 0
    const float lam =
        t < Kpred ? knn::idw_lam(lamdb, nw, ni, k, Kpred, t, N) : 0.0f;
    if (first) lam_out[row * K + t] = lam;
    s.coef[t] = __fmul_rn(c, lam);
  }
  rk::rank_audit_row(u + row * m1, a + row * K * m1, s, b + row * K,
                     gamma + row * m2, m1, K, m2, split, tol,
                     vals + row * m2, idx + row * m2, util + row,
                     expo + row * K, comp + row);
}

// Launches A then B on `stream`. Returns the first nonzero
// cudaError_t, or 0.
extern "C" int knn_rank_audited_launch(
    const void* xq, const void* xdb, const void* lamdb, const void* u,
    const void* a, const void* b, const void* gamma, void* ws_d2,
    void* ws_idx, void* vals, void* idx, void* util, void* expo, void* comp,
    void* lam_out, int B, int N, int D, int k, int Kpred, int m1, int K,
    int m2, int split, int chunk, int st, int dc, int n_chunks, float c,
    float tol, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = knn::launch_chunk_topk(
      (const float*)xq, (const float*)xdb, B, N, D, k, chunk, st, dc,
      n_chunks, (float*)ws_d2, (int*)ws_idx, s);
  if (err) return err;
  const size_t lists = (size_t)knn::merge_floats(k) * sizeof(float);
  const size_t rank = rk::smem_bytes(K, m2);
  const int rl = knn::list_rl(k);
  auto kernel = rl == 1   ? knn_rank_audited_kernel<1>
                : rl == 2 ? knn_rank_audited_kernel<2>
                : rl == 4 ? knn_rank_audited_kernel<4>
                          : knn_rank_audited_kernel<8>;
  return rk::launch_rows(
      kernel, B, split, lists > rank ? lists : rank, s,
      (const float*)xq, (const float*)xdb, (const float*)lamdb,
      (const float*)ws_d2, (const int*)ws_idx, (const float*)u,
      (const float*)a, (const float*)b, (const float*)gamma, N, D, k, Kpred,
      n_chunks, m1, K, m2, split, c, tol, (float*)vals, (int*)idx,
      (float*)util, (float*)expo, (int*)comp, (float*)lam_out);
}
