// Nearest-center register tile shared by assign_stats.cu and assign_argmax.cu.
//
// One block takes 128 rows of x and walks every center in tiles of 64 with
// tile_dot.cuh (8 x 4 results per thread): within a tile the row maximum
// goes to the lowest center (beats, row_argmax), and across tiles a strict
// '>' keeps the earlier tile's center on a tie. So idx is the argmax over
// centers of x . c with ties to the lowest index, and best_sim its value,
// each similarity one fmaf chain over d in order.
//
// With ROWSQ the block also writes each row's squared norm (the same fmaf
// chain, summed while the first center tile stages the row).
#pragma once

#include "tile_dot.cuh"

namespace repro {

constexpr int kAssignBM = 128, kAssignBN = 64, kAssignTM = 8, kAssignTN = 4;

template <bool ROWSQ>
__global__ void __launch_bounds__(kThreads, 2)
    assign_tile(const float* __restrict__ x, const float* __restrict__ centers,
                int n, int k, int d, int* __restrict__ idx,
                float* __restrict__ best_sim, float* __restrict__ rowsq) {
  constexpr int BM = kAssignBM, BN = kAssignBN, TM = kAssignTM, TN = kAssignTN;
  __shared__ __align__(16) float as[kBK][BM + 4];
  __shared__ __align__(16) float bs[kBK][BN + 4];
  constexpr int kTx = TileShape<BM, BN, TM, TN>::kTx;
  const int row0 = blockIdx.x * BM;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;

  float best[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = kNeg;
    bidx[i] = -1;
  }
  float rsq = 0.f;
  for (int col0 = 0; col0 < k; col0 += BN) {
    float acc[TM][TN];
    if (ROWSQ && col0 == 0)
      tile_dot<BM, BN, TM, TN, true>(x, n, centers, k, d, row0, col0, as, bs, acc, rsq);
    else
      tile_dot<BM, BN, TM, TN, false>(x, n, centers, k, d, row0, col0, as, bs, acc, rsq);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tb = kNeg;
      int tj = -1;
#pragma unroll
      for (int j = 0; j < TN; ++j) {  // centers ascend with j
        const int col = col0 + tile_row<BN, TN>(tx, j);
        if (col < k && beats(acc[i][j], col, tb, tj)) {
          tb = acc[i][j];
          tj = col;
        }
      }
      row_argmax<kTx>(tb, tj);
      if (tb > best[i]) {  // strict: earlier center tiles win ties
        best[i] = tb;
        bidx[i] = tj;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + tile_row<BM, TM>(ty, i);
      if (row < n) {
        idx[row] = bidx[i];
        best_sim[row] = best[i];
      }
    }
  }
  if (ROWSQ && threadIdx.x < BM && row0 + threadIdx.x < n)
    rowsq[row0 + threadIdx.x] = rsq;
}

// Launch on `st`; n == 0 launches nothing.
template <bool ROWSQ>
inline int launch_assign_tile(const float* x, const float* centers, int n,
                              int k, int d, int* idx, float* best_sim,
                              float* rowsq, cudaStream_t st) {
  if (n == 0) return 0;
  assign_tile<ROWSQ><<<(n + kAssignBM - 1) / kAssignBM, kThreads, 0, st>>>(
      x, centers, n, k, d, idx, best_sim, rowsq);
  return (int)cudaGetLastError();
}

}  // namespace repro
