// rank_audited: the lambda-given online stage, one block per row.
//
// Replaces the TPU kernel src/repro/kernels/fused_rank.py::
// rank_audited_pallas (pallas_call at line 261). The TPU grid walked
// (batch tiles x m1 tiles) in order on one core with the running top-m2
// in VMEM scratch; here each row is independent, so a block owns a row
// and walks its m1 tiles itself (rank_audit.cuh). Bound on an H100: the
// bytes of u and a, read once, at 3.35 TB/s; see rank_audit.cuh for
// where this simple design spends its time.
#include "rank_audit.cuh"

__global__ void __launch_bounds__(rk::kBlock) rank_audited_kernel(
    const float* __restrict__ u, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ lam,
    const float* __restrict__ gamma, int m1, int K, int m2, int P,
    float c, float tol, float* vals, int* idx, float* util, float* expo,
    int* comp) {
  extern __shared__ float smem[];
  __shared__ float coef[rk::kMaxK];
  const size_t row = blockIdx.x;
  if (threadIdx.x < K) coef[threadIdx.x] = __fmul_rn(c, lam[row * K + threadIdx.x]);
  __syncthreads();
  rk::rank_audit_row(u + row * m1, a + row * K * m1, coef, b + row * K,
                     gamma + row * m2, m1, K, m2, P, tol, smem,
                     reinterpret_cast<int*>(smem + P), vals + row * m2,
                     idx + row * m2, util + row, expo + row * K, comp + row);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rank_audited_launch(
    const void* u, const void* a, const void* b, const void* lam,
    const void* gamma, void* vals, void* idx, void* util, void* expo,
    void* comp, int n, int m1, int K, int m2, int P, float c, float tol,
    void* stream) {
  const size_t smem = (size_t)P * (sizeof(float) + sizeof(int));
  rank_audited_kernel<<<n, rk::kBlock, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)a, (const float*)b, (const float*)lam,
      (const float*)gamma, m1, K, m2, P, c, tol, (float*)vals, (int*)idx,
      (float*)util, (float*)expo, (int*)comp);
  return (int)cudaGetLastError();
}
