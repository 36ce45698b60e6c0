// fused_rank: the adjusted-score top-m2 (vals, idx) without the audit,
// one launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_rank.py::
// fused_rank_pallas (pallas_call at line 128), whose grid walked (batch
// tiles x m1 tiles) in order on one core with the running top-m2 in VMEM
// scratch. Here each row is independent: rank_audit.cuh's rank_row, the
// very routine the audited kernels run, ranks it on one block or on a
// cluster of `split` blocks, so on the same inputs its (vals, idx) are
// rank_audited's bitwise.
//
// Bound on an H100: the bytes of u and a, (K+1)*m1*4 a row, read once at
// 3.35 TB/s. At a long row (m1 = 100,000) the filter stages a few hundred
// of the row's candidates, so the time is the stream of u and a; a batch
// of 64 rows splits each row over 8 blocks to fill the 132 SMs.
#include "rank_audit.cuh"

__global__ void __launch_bounds__(rk::kBlock) fused_rank_kernel(
    const float* __restrict__ u, const float* __restrict__ a,
    const float* __restrict__ lam, int m1, int K, int m2, int split,
    float c, float* vals, int* idx) {
  extern __shared__ float smem[];
  const rk::Smem s = rk::carve(smem, K, m2);
  const size_t row = blockIdx.x / split;
  for (int t = threadIdx.x; t < K; t += blockDim.x)
    s.coef[t] = __fmul_rn(c, lam[row * K + t]);
  rk::rank_row(u + row * m1, a + row * K * m1, s, m1, K, m2, split,
               vals + row * m2, idx + row * m2);
}

// Returns the first nonzero cudaError_t of the launch, or 0.
extern "C" int fused_rank_launch(const void* u, const void* a,
                                 const void* lam, void* vals, void* idx,
                                 int n, int m1, int K, int m2, int split,
                                 float c, void* stream) {
  return rk::launch_rows(fused_rank_kernel, n, split, rk::smem_bytes(K, m2),
                         (cudaStream_t)stream, (const float*)u,
                         (const float*)a, (const float*)lam, m1, K, m2,
                         split, c, (float*)vals, (int*)idx);
}
