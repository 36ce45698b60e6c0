// rank_audited: the lambda-given online stage, one launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_rank.py::
// rank_audited_pallas (pallas_call at line 261). The TPU grid walked
// (batch tiles x m1 tiles) in order on one core with the running top-m2
// in VMEM scratch; here each row is independent, so a row belongs to one
// block, or to a cluster of `split` blocks when the batch is smaller than
// the card, which filters its candidates against the running m2-th score
// and sorts only the few that pass (rank_audit.cuh). Bound on an H100:
// the bytes of u and a, read once, at 3.35 TB/s; the time goes to
// streaming them (see rank_audit.cuh).
#include "rank_audit.cuh"

__global__ void __launch_bounds__(rk::kBlock) rank_audited_kernel(
    const float* __restrict__ u, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ lam,
    const float* __restrict__ gamma, int m1, int K, int m2, int split,
    float c, float tol, float* vals, int* idx, float* util, float* expo,
    int* comp) {
  extern __shared__ float smem[];
  const rk::Smem s = rk::carve(smem, K, m2);
  const size_t row = blockIdx.x / split;
  for (int t = threadIdx.x; t < K; t += blockDim.x)
    s.coef[t] = __fmul_rn(c, lam[row * K + t]);
  rk::rank_audit_row(u + row * m1, a + row * K * m1, s, b + row * K,
                     gamma + row * m2, m1, K, m2, split, tol,
                     vals + row * m2, idx + row * m2, util + row,
                     expo + row * K, comp + row);
}

// Returns the first nonzero cudaError_t of the launch, or 0.
extern "C" int rank_audited_launch(
    const void* u, const void* a, const void* b, const void* lam,
    const void* gamma, void* vals, void* idx, void* util, void* expo,
    void* comp, int n, int m1, int K, int m2, int split, float c, float tol,
    void* stream) {
  return rk::launch_rows(
      rank_audited_kernel, n, split, rk::smem_bytes(K, m2),
      (cudaStream_t)stream, (const float*)u, (const float*)a,
      (const float*)b, (const float*)lam, (const float*)gamma, m1, K, m2,
      split, c, tol, (float*)vals, (int*)idx, (float*)util, (float*)expo,
      (int*)comp);
}
