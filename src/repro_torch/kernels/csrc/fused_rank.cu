// fused_rank: the adjusted-score top-m2 (vals, idx), one block per row,
// without the audit.
//
// Replaces the TPU kernel src/repro/kernels/fused_rank.py::
// fused_rank_pallas (pallas_call at line 128), whose grid walked (batch
// tiles x m1 tiles) in order on one core with the running top-m2 in VMEM
// scratch. Here each row is independent, so a block owns a row and walks
// its m1 tiles itself with rank_audit.cuh's rank_row, the very routine
// the audited kernels run: on the same inputs its (vals, idx) are
// rank_audited's bitwise.
//
// Bound on an H100: the bytes of u and a, (K+1)*m1*4 a row, read once at
// 3.35 TB/s. At a long row (m1 = 100,000) a block re-sorts its 2048-pair
// buffer once for every 2048 - m2 new candidates, and a batch of 64 rows
// fills only 64 of the 132 SMs; splitting a row across blocks is later
// work.
#include "rank_audit.cuh"

__global__ void __launch_bounds__(rk::kBlock) fused_rank_kernel(
    const float* __restrict__ u, const float* __restrict__ a,
    const float* __restrict__ lam, int m1, int K, int m2, int P, float c,
    float* vals, int* idx) {
  extern __shared__ float smem[];
  __shared__ float coef[rk::kMaxK];
  const size_t row = blockIdx.x;
  if (threadIdx.x < K)
    coef[threadIdx.x] = __fmul_rn(c, lam[row * K + threadIdx.x]);
  __syncthreads();
  rk::rank_row(u + row * m1, a + row * K * m1, coef, m1, K, m2, P, smem,
               reinterpret_cast<int*>(smem + P), vals + row * m2,
               idx + row * m2);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_rank_launch(const void* u, const void* a,
                                 const void* lam, void* vals, void* idx,
                                 int n, int m1, int K, int m2, int P,
                                 float c, void* stream) {
  const size_t smem = (size_t)P * (sizeof(float) + sizeof(int));
  fused_rank_kernel<<<n, rk::kBlock, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)a, (const float*)lam, m1, K, m2, P, c,
      (float*)vals, (int*)idx);
  return (int)cudaGetLastError();
}
