// linear_rank_audited: the online stage of the affine lambda predictors
// (the linear and the mean family), one block per row.
//
// Replaces the TPU kernel src/repro/kernels/fused_rank.py::
// linear_rank_audited_pallas (pallas_call at line 384), which computed
// lambda-hat = X W^T + c for a batch tile into VMEM in its prologue and
// then ran the rank+audit sweep. Here each row is independent, so a
// block owns a row:
//
//   * Prologue: thread t < K computes lambda-hat_t = sum_d x_d W[t, d]
//     coordinate by coordinate with every product and addition rounded
//     on its own (__fmul_rn/__fadd_rn, no FMA contraction), then + c_t,
//     then max(., 0) when `relu` is set (linear: on; mean, which is
//     W = 0 and c = mean_lam: off, so a negative mean stays negative).
//     kernels/ref.py's affine_lambda_ref repeats this order, so the two
//     agree bitwise. X and W are read from device memory; d may be any
//     width >= 1 (a few hundred at most in practice).
//   * lambda-hat is written out as `lam` and kept in shared memory as
//     coef = (1+eps) * lambda-hat, then rank_audit.cuh's routine ranks
//     and audits the row, unchanged.
//
// Bound on an H100: the bytes of u and a, (K+1) * m1 * 4 per row, read
// once at 3.35 TB/s; the prologue adds (d + K*d + K) * 4 bytes and
// 2 * K * d FLOPs per row, small beside them. Where this simple design
// spends its time is the rank routine's bitonic sort (rank_audit.cuh).
#include "rank_audit.cuh"

__global__ void __launch_bounds__(rk::kBlock) linear_rank_audited_kernel(
    const float* __restrict__ u, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ X,
    const float* __restrict__ W, const float* __restrict__ cvec,
    const float* __restrict__ gamma, int d, int m1, int K, int m2, int P,
    float c, float tol, int relu, float* vals, int* idx, float* util,
    float* expo, int* comp, float* lam_out) {
  extern __shared__ float smem[];
  __shared__ float coef[rk::kMaxK];
  const int t = threadIdx.x;
  const size_t row = blockIdx.x;
  if (t < K) {
    const float* x = X + row * d;
    const float* w = W + (size_t)t * d;
    float lam = __fmul_rn(x[0], w[0]);
    for (int j = 1; j < d; ++j) lam = __fadd_rn(lam, __fmul_rn(x[j], w[j]));
    lam = __fadd_rn(lam, cvec[t]);
    if (relu) lam = fmaxf(lam, 0.0f);
    lam_out[row * K + t] = lam;
    coef[t] = __fmul_rn(c, lam);
  }
  __syncthreads();
  rk::rank_audit_row(u + row * m1, a + row * K * m1, coef, b + row * K,
                     gamma + row * m2, m1, K, m2, P, tol, smem,
                     reinterpret_cast<int*>(smem + P), vals + row * m2,
                     idx + row * m2, util + row, expo + row * K, comp + row);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int linear_rank_audited_launch(
    const void* u, const void* a, const void* b, const void* X,
    const void* W, const void* cvec, const void* gamma, void* vals,
    void* idx, void* util, void* expo, void* comp, void* lam_out, int n,
    int d, int m1, int K, int m2, int P, int relu, float c, float tol,
    void* stream) {
  const size_t smem = (size_t)P * (sizeof(float) + sizeof(int));
  linear_rank_audited_kernel<<<n, rk::kBlock, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)a, (const float*)b, (const float*)X,
      (const float*)W, (const float*)cvec, (const float*)gamma, d, m1, K, m2,
      P, c, tol, relu, (float*)vals, (int*)idx, (float*)util, (float*)expo,
      (int*)comp, (float*)lam_out);
  return (int)cudaGetLastError();
}
