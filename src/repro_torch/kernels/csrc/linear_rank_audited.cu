// linear_rank_audited: the online stage of the affine lambda predictors
// (the linear and the mean family), one launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_rank.py::
// linear_rank_audited_pallas (pallas_call at line 384), which computed
// lambda-hat = X W^T + c for a batch tile into VMEM in its prologue and
// then ran the rank+audit sweep. Here each row is independent and
// belongs to one block, or to a cluster of `split` blocks:
//
//   * Prologue, in every block of the row: thread t (strided over K)
//     computes lambda-hat_t = sum_d x_d W[t, d] coordinate by coordinate
//     with every product and addition rounded on its own
//     (__fmul_rn/__fadd_rn, no FMA contraction), then + c_t, then
//     max(., 0) when `relu` is set (linear: on; mean, which is W = 0 and
//     c = mean_lam: off, so a negative mean stays negative).
//     kernels/ref.py's affine_lambda_ref repeats this order, so the two
//     agree bitwise, and so do the blocks of a split row. X and W are
//     read from device memory; d may be any width >= 1.
//   * lambda-hat is written out as `lam` (by the row's first block) and
//     kept in shared memory as coef = (1+eps) * lambda-hat, then
//     rank_audit.cuh's routine ranks and audits the row.
//
// Bound on an H100: the bytes of u and a, (K+1) * m1 * 4 per row, read
// once at 3.35 TB/s; the prologue adds (d + K*d + K) * 4 bytes and
// 2 * K * d FLOPs per row, small beside them. The time goes to streaming
// u and a (rank_audit.cuh).
#include "rank_audit.cuh"

__global__ void __launch_bounds__(rk::kBlock) linear_rank_audited_kernel(
    const float* __restrict__ u, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ X,
    const float* __restrict__ W, const float* __restrict__ cvec,
    const float* __restrict__ gamma, int d, int m1, int K, int m2,
    int split, float c, float tol, int relu, float* vals, int* idx,
    float* util, float* expo, int* comp, float* lam_out) {
  extern __shared__ float smem[];
  const rk::Smem s = rk::carve(smem, K, m2);
  const size_t row = blockIdx.x / split;
  const bool first = blockIdx.x % split == 0;
  const float* x = X + row * d;
  for (int t = threadIdx.x; t < K; t += blockDim.x) {
    const float* w = W + (size_t)t * d;
    float lam = __fmul_rn(x[0], w[0]);
    for (int j = 1; j < d; ++j) lam = __fadd_rn(lam, __fmul_rn(x[j], w[j]));
    lam = __fadd_rn(lam, cvec[t]);
    if (relu) lam = fmaxf(lam, 0.0f);
    if (first) lam_out[row * K + t] = lam;
    s.coef[t] = __fmul_rn(c, lam);
  }
  rk::rank_audit_row(u + row * m1, a + row * K * m1, s, b + row * K,
                     gamma + row * m2, m1, K, m2, split, tol,
                     vals + row * m2, idx + row * m2, util + row,
                     expo + row * K, comp + row);
}

// Returns the first nonzero cudaError_t of the launch, or 0.
extern "C" int linear_rank_audited_launch(
    const void* u, const void* a, const void* b, const void* X,
    const void* W, const void* cvec, const void* gamma, void* vals,
    void* idx, void* util, void* expo, void* comp, void* lam_out, int n,
    int d, int m1, int K, int m2, int split, int relu, float c, float tol,
    void* stream) {
  return rk::launch_rows(
      linear_rank_audited_kernel, n, split, rk::smem_bytes(K, m2),
      (cudaStream_t)stream, (const float*)u, (const float*)a,
      (const float*)b, (const float*)X, (const float*)W,
      (const float*)cvec, (const float*)gamma, d, m1, K, m2, split, c, tol,
      relu, (float*)vals, (int*)idx, (float*)util, (float*)expo, (int*)comp,
      (float*)lam_out);
}
