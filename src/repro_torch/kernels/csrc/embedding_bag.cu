// embedding_bag: a sum-mode EmbeddingBag, out[i] = sum_j w[i,j] *
// table[idx[i,j]], with idx < 0 marking a padded slot and an index past
// the table reading its last row (the JAX oracle's clamped gather).
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::
// embedding_bag_pallas (pallas_call at line 76), which DMA'd one table
// row per (bag, slot) from HBM into a VMEM accumulator tile.
//
// Bound on an H100: bytes. Each distinct row a valid slot names read
// once, plus the indices, the weights and the output, at 3.35 TB/s; a
// row named twice is read twice unless L2 serves the repeat, and a row
// costs whole 32-byte sectors. What holds a gather back is latency: a
// row's load waits on its index's. So the design keeps many independent
// row loads in flight, in wide vectors, on every lane. (Rows in random
// order from a table far larger than L2 still cost DRAM pages: on an
// H100, one-slot bags of 40-byte rows over a 1.56 GB table move their
// sectors at about 60% of the memory rate, PERF.md.)
//
//   * A lane reads its part of a row in vectors of VB bytes (16, 8, 4 or
//     2: the widest that divides the row's bytes and the pointers'
//     alignment, kernels/embedding_bag.py::bag_geometry), read-only
//     (ld.global.nc). A row takes `lanes` lanes, at most 32; a wider row
//     is cut into column passes, each pass a warp of its own.
//   * Where a row takes fewer than 32 lanes, the warp's lanes form
//     `groups` lane groups, each serving its own bag, so the lanes of a
//     narrow row do not idle. A warp serves `rounds` rounds of `groups`
//     consecutive bags, so a short bag's indices come in one contiguous
//     load for the warp and its sums leave in one contiguous store.
//   * A group reads its (bag, slot) pairs' indices and weights `lanes` at
//     a time, one pair a lane, the next batch's issued before this
//     batch's rows; __shfl_sync hands each pair to the group's lanes, and
//     a chunk of kChunk rows is loaded before any is added. The sums
//     leave by evict-first stores.
//   * Sums are f32, slot by slot: acc = acc + row * w, the product and
//     the sum each rounded on its own (no FMA), a padded slot adding
//     nothing, a bf16 row widened exactly and the sum rounded to bf16
//     once, at the end: the order kernels/ref.py repeats, so the two
//     agree bit for bit. The TPU kernel and the oracle add 0 * table[0]
//     at a padded slot, which differs only where table[0] holds an inf
//     or a NaN.
//   * weights may be null: every weight is then 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bag {

constexpr int kWarps = 4;   // warps a block
constexpr int kChunk = 8;   // rows a lane loads before adding them

// VB bytes of a row as 32-bit words (a 2-byte vector in the low half)
template <int VB>
struct Vec {
  unsigned w[VB >= 4 ? VB / 4 : 1];
};

template <int VB>
__device__ __forceinline__ Vec<VB> load_nc(const char* p) {
  Vec<VB> v;
  if constexpr (VB == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = x.x;
    v.w[1] = x.y;
    v.w[2] = x.z;
    v.w[3] = x.w;
  } else if constexpr (VB == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v.w[0] = x.x;
    v.w[1] = x.y;
  } else if constexpr (VB == 4) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    v.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return v;
}

// column k of a vector, widened exactly to f32 (a bf16 is the high half
// of the f32 with the same value)
template <typename T, int VB>
__device__ __forceinline__ float column(const Vec<VB>& v, int k) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(v.w[k]);
  } else {
    const unsigned x = v.w[k >> 1];
    return __uint_as_float((k & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

template <typename T>
__device__ __forceinline__ unsigned bits(float x) {
  if constexpr (sizeof(T) == 4)
    return __float_as_uint(x);
  else
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));  // nearest even
}

// the E = VB / sizeof(T) sums, each rounded once to T, as one vector
template <typename T, int VB, int E>
__device__ __forceinline__ void store(char* p, const float (&acc)[E]) {
  Vec<VB> v;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < E; ++k) v.w[k] = bits<T>(acc[k]);
  } else if constexpr (E == 1) {
    v.w[0] = bits<T>(acc[0]);
  } else {
#pragma unroll
    for (int k = 0; k < E / 2; ++k)
      v.w[k] = bits<T>(acc[2 * k]) | (bits<T>(acc[2 * k + 1]) << 16);
  }
  // evict-first (st.global.cs): the kernel never reads its output, and
  // L2 keeps table rows that later bags name again
  if constexpr (VB == 16)
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]));
  else if constexpr (VB == 8)
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(v.w[0], v.w[1]));
  else if constexpr (VB == 4)
    __stcs(reinterpret_cast<unsigned*>(p), v.w[0]);
  else
    __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)v.w[0]);
}

// A warp serves groups x rounds consecutive bags from bag `first`, in
// column pass w % passes: at round r its lane group g takes bag
// first + r * groups + g, so a round's groups hold consecutive bags (one
// contiguous load of their indices where bags are short, one contiguous
// store of their sums).
template <typename T, int VB>
__global__ void __launch_bounds__(32 * kWarps) embedding_bag_kernel(
    const char* __restrict__ table, const int* __restrict__ indices,
    const float* __restrict__ weights, char* __restrict__ out, int n_bags,
    int bag, int D, int last, int lanes, int groups, int rounds,
    int passes) {
  constexpr int E = VB / (int)sizeof(T);  // columns a vector holds
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long first = w / passes * groups * rounds;
  if (first >= n_bags) return;                    // the whole warp
  const int g = lane / lanes;
  const int gl = lane - g * lanes;                // the lane's place
  const size_t row_bytes = (size_t)D * sizeof(T);
  const int v = (int)(w % passes) * lanes + gl;  // the lane's vector
  // the group's bags: rounds 0 .. n_mine - 1
  const long long left = min((long long)groups * rounds, n_bags - first);
  const int n_mine = g < groups && g < left
                         ? (int)((left - g + groups - 1) / groups) : 0;
  const bool col = n_mine > 0 && (size_t)v * VB < row_bytes;
  const size_t col_off = (size_t)v * VB;
  const long long mine = first + g;               // bag of round 0
  float acc[E];
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] = 0.0f;
  if (bag == 0) {  // empty bags: zeros
    if (col)
      for (int r = 0; r < n_mine; ++r)
        store<T, VB, E>(out + (mine + (long long)r * groups) * row_bytes +
                            col_off, acc);
    return;
  }
  // the group's pairs q = r * bag + j, [0, n_pairs); `span`, a full
  // group's, bounds the loop alike for every lane of the warp
  const int n_pairs = n_mine * bag;
  const int span = rounds * bag;
  auto pair = [&](int q) {  // index-array offset of the group's pair q
    const int r = q / bag;
    return (mine + (long long)r * groups) * bag + (q - r * bag);
  };
  int nxt_r = -1;
  float nxt_w = 1.0f;
  if (gl < n_pairs) {
    const long long o = pair(gl);
    nxt_r = __ldg(indices + o);
    if (weights) nxt_w = __ldg(weights + o);
  }
  int slot = 0;
  long long b = mine;
  for (int q0 = 0; q0 < span; q0 += lanes) {
    const int my_r = min(nxt_r, last);  // past the table: its last row
    const float my_w = nxt_w;
    if (q0 + lanes + gl < n_pairs) {  // the next batch, issued now
      const long long o = pair(q0 + lanes + gl);
      nxt_r = __ldg(indices + o);
      if (weights) nxt_w = __ldg(weights + o);
    }
    const int n_here = min(lanes, span - q0);
    for (int s0 = 0; s0 < n_here; s0 += kChunk) {
      Vec<VB> rv[kChunk];
      int rr[kChunk];
      float ww[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int src = g * lanes + s0 + u;  // wraps past 31: unused
        rr[u] = __shfl_sync(0xffffffffu, my_r, src & 31);
        ww[u] = __shfl_sync(0xffffffffu, my_w, src & 31);
        if (col && s0 + u < n_here && q0 + s0 + u < n_pairs && rr[u] >= 0)
          rv[u] = load_nc<VB>(table + (size_t)rr[u] * row_bytes + col_off);
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (s0 + u >= n_here || q0 + s0 + u >= n_pairs) break;
        if (col && rr[u] >= 0) {
#pragma unroll
          for (int k = 0; k < E; ++k)
            acc[k] = __fadd_rn(acc[k],
                               __fmul_rn(column<T, VB>(rv[u], k), ww[u]));
        }
        if (++slot == bag) {  // the bag is complete
          if (col) store<T, VB, E>(out + b * row_bytes + col_off, acc);
#pragma unroll
          for (int k = 0; k < E; ++k) acc[k] = 0.0f;
          slot = 0;
          b += groups;
        }
      }
    }
  }
}

template <typename T, int VB>
void run(const void* table, const void* indices, const void* weights,
         void* out, int n_bags, int bag, int D, int last, int lanes,
         int groups, int rounds, int passes, unsigned blocks,
         cudaStream_t s) {
  embedding_bag_kernel<T, VB><<<blocks, 32 * kWarps, 0, s>>>(
      (const char*)table, (const int*)indices, (const float*)weights,
      (char*)out, n_bags, bag, D, last, lanes, groups, rounds, passes);
}

}  // namespace bag

// bf16 != 0 selects the bf16 table (and output); vec, lanes, groups,
// rounds and passes are kernels/embedding_bag.py::bag_geometry's plan;
// last = V - 1. Returns cudaGetLastError() after the launch (0 on
// success), or an error for a plan the kernel has no variant of.
extern "C" int embedding_bag_launch(const void* table, const void* indices,
                                    const void* weights, void* out,
                                    int n_bags, int bag, int D, int last,
                                    int bf16, int vec, int lanes, int groups,
                                    int rounds, int passes, void* stream) {
  if (n_bags <= 0 || D <= 0) return 0;
  if (lanes < 1 || lanes > 32 || groups < 1 || groups * lanes > 32 ||
      rounds < 1 || passes < 1)
    return (int)cudaErrorInvalidValue;
  const long long per_warp = (long long)groups * rounds;
  const long long warps = (n_bags + per_warp - 1) / per_warp * passes;
  const long long blocks = (warps + bag::kWarps - 1) / bag::kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = (unsigned)blocks;
#define BAG_RUN(T, VB)                                                    \
  bag::run<T, VB>(table, indices, weights, out, n_bags, bag, D, last,     \
                  lanes, groups, rounds, passes, nb, s)
  if (bf16) {
    switch (vec) {
      case 16: BAG_RUN(__nv_bfloat16, 16); break;
      case 8: BAG_RUN(__nv_bfloat16, 8); break;
      case 4: BAG_RUN(__nv_bfloat16, 4); break;
      case 2: BAG_RUN(__nv_bfloat16, 2); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (vec) {
      case 16: BAG_RUN(float, 16); break;
      case 8: BAG_RUN(float, 8); break;
      case 4: BAG_RUN(float, 4); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef BAG_RUN
  return (int)cudaGetLastError();
}
