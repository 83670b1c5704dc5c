// Register-tiled fp32 dot-product tile shared by sim_best_edge.cu and
// assign_stats.cu: one block computes the (BM, BN) tile A[row0:] . B[col0:]^T
// of two row-major (rows, d) matrices, d-chunk by d-chunk through shared
// memory, with every thread holding a (TM, TN) sub-tile in registers.
//
// Every output element is ONE fp32 register updated by fmaf over k = 0..d-1
// in order (no split-k, no TF32, no tensor cores). So a block's result does
// not depend on the tiling, two runs give identical bits, and because
// fmaf(a, b, c) == fmaf(b, a, c), the (i, j) and (j, i) entries of xs . xs^T
// are bit-identical: the Borůvka search sees a symmetric similarity.
#pragma once

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;  // threads per tile block
constexpr int kBK = 16;        // d columns staged per shared-memory step
constexpr float kNeg = -FLT_MAX;

// The (TM, TN) values of thread (ty, tx) sit in groups of four: rows
// ty*4 + (i % 4) + (i / 4) * (BM / TM) * 4, and the same for columns. A warp's
// float4 reads of one shared-memory row then cover consecutive addresses.
template <int BM, int TM>
__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i / 4) * (BM / TM) * 4 + ty * 4 + (i % 4);
}

template <int BM, int BN, int TM, int TN>
struct TileShape {
  static_assert(TM % 4 == 0 && TN % 4 == 0, "sub-tiles come in float4 groups");
  static_assert((BM / TM) * (BN / TN) == kThreads, "one sub-tile per thread");
  static_assert((BN / TN) <= 32 && 32 % (BN / TN) == 0,
                "a tile row's threads share one warp");
  static constexpr int kTx = BN / TN;  // threads along a tile row
};

// Stage rows [row0, row0 + BM) x columns [k0, k0 + kBK) of a (m, d) matrix
// transposed into S[kk][r]; entries past m or d are zero, and a zero adds
// nothing to the fmaf chain.
template <int BM>
__device__ __forceinline__ void stage(const float* __restrict__ a, int m, int d,
                                      int row0, int k0, float (*s)[BM + 4]) {
#pragma unroll
  for (int e = threadIdx.x; e < BM * kBK; e += kThreads) {
    const int r = e / kBK, kk = e % kBK;
    const int gr = row0 + r, gk = k0 + kk;
    s[kk][r] = (gr < m && gk < d) ? a[(size_t)gr * d + gk] : 0.f;
  }
}

// acc[i][j] = A[row i] . B[col j] for the calling thread's sub-tile. With
// ROWSQ, threads 0..BM-1 also return the squared norm of row row0 + tid
// (summed by fmaf over k in order) in `rowsq`.
template <int BM, int BN, int TM, int TN, bool ROWSQ>
__device__ __forceinline__ void tile_dot(
    const float* __restrict__ a, int m, const float* __restrict__ b, int n,
    int d, int row0, int col0, float (*as)[BM + 4], float (*bs)[BN + 4],
    float (&acc)[TM][TN], float& rowsq) {
  using Shape = TileShape<BM, BN, TM, TN>;
  const int tx = threadIdx.x % Shape::kTx, ty = threadIdx.x / Shape::kTx;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    stage<BM>(a, m, d, row0, k0, as);
    stage<BN>(b, n, d, col0, k0, bs);
    __syncthreads();
    if (ROWSQ && threadIdx.x < BM) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float v = as[kk][threadIdx.x];
        rowsq = fmaf(v, v, rowsq);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &as[kk][tile_row<BM, TM>(ty, 4 * g)]);
        av[4 * g] = v.x; av[4 * g + 1] = v.y; av[4 * g + 2] = v.z; av[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &bs[kk][tile_row<BN, TN>(tx, 4 * g)]);
        bv[4 * g] = v.x; bv[4 * g + 1] = v.y; bv[4 * g + 2] = v.z; bv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// (value desc, column asc) winner of two candidates; column -1 (no
// candidate) never wins a tie.
__device__ __forceinline__ bool beats(float v, int j, float bv, int bj) {
  return v > bv || (v == bv && (unsigned)j < (unsigned)bj);
}

// Reduce a per-thread (best value, best column) over the kTx threads of one
// tile row; every one of them ends with the row's winner.
template <int kTx>
__device__ __forceinline__ void row_argmax(float& best, int& bj) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (beats(ov, oj, best, bj)) {
      best = ov;
      bj = oj;
    }
  }
}

}  // namespace repro

#define REPRO_CHECK_LAUNCH()                   \
  do {                                         \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)
