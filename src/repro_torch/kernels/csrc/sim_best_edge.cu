// sim_best_edge: one Borůvka round of Buckshot's phase-1 single-link HAC.
//
// Replaces the TPU kernel src/repro/kernels/sim_best_edge.py
// (sim_best_edge_pallas, body _kernel): for every row of xs_rows (r, d), the
// most similar column of xs_all (c, d) in ANOTHER component, without ever
// writing the (r, c) similarity matrix to memory. A column is kept iff
// lr != lc && lr >= 0 && lc >= 0 && col < c; the row maximum goes to the
// lowest column on ties; a row with no candidate gets (-1, -FLT_MAX).
//
// What bounds it on an H100: arithmetic. The work is r*c*d fused
// multiply-adds (2*r*c*d flops) on r*d + c*d floats; at the main path's
// s = 3,536, d = 2,048 the sample is 29 MB, stays in the 50 MB L2, and each
// loaded float feeds ~s flops, so the fp32 FMA rate (no TF32: the result must
// match the plain fp32 product) is the ceiling.
//
// What the design does about it: a 128 x 128 output tile per block,
// 8 x 8 results per thread held in registers (64 FMAs for every 16 floats
// read from shared memory), d staged 16 columns at a time. The TPU kernel
// swept all column tiles inside one grid row; here the column tiles are
// spread over blocks so that s = 3,536 fills the card (28 x 28 blocks), each
// block writes one (best value, best column) per row, and a second launch
// folds those partials per row in column-tile order with a strict '>', which
// keeps the (max, then lowest column) rule. No atomics: two runs give
// identical bits.

#include "tile_dot.cuh"

namespace {

using namespace repro;

constexpr int BM = 128, BN = 128, TM = 8, TN = 8;

__global__ void __launch_bounds__(kThreads, 2)
    sim_best_edge_tile(const float* __restrict__ xr, const float* __restrict__ xc,
                       const int* __restrict__ lr, const int* __restrict__ lc,
                       int r, int c, int d, float* __restrict__ part_s,
                       int* __restrict__ part_j) {
  __shared__ __align__(16) float as[kBK][BM + 4];
  __shared__ __align__(16) float bs[kBK][BN + 4];
  constexpr int kTx = TileShape<BM, BN, TM, TN>::kTx;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;

  float acc[TM][TN];
  float unused = 0.f;
  tile_dot<BM, BN, TM, TN, false>(xr, r, xc, c, d, row0, col0, as, bs, acc, unused);

  int col[TN], lcol[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    col[j] = col0 + tile_row<BN, TN>(tx, j);
    lcol[j] = col[j] < c ? lc[col[j]] : -1;  // tile-pad columns match nothing
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + tile_row<BM, TM>(ty, i);
    const int lrow = row < r ? lr[row] : -1;
    float best = kNeg;
    int bj = -1;
#pragma unroll
    for (int j = 0; j < TN; ++j) {  // columns ascend with j
      const bool keep = lrow >= 0 && lcol[j] >= 0 && lrow != lcol[j];
      if (keep && beats(acc[i][j], col[j], best, bj)) {
        best = acc[i][j];
        bj = col[j];
      }
    }
    row_argmax<kTx>(best, bj);
    if (tx == 0 && row < r) {
      part_s[(size_t)blockIdx.x * r + row] = best;
      part_j[(size_t)blockIdx.x * r + row] = bj;
    }
  }
}

__global__ void sim_best_edge_merge(const float* __restrict__ part_s,
                                    const int* __restrict__ part_j, int r,
                                    int tiles, int* __restrict__ best_j,
                                    float* __restrict__ best_s) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= r) return;
  float best = kNeg;
  int bj = -1;
  for (int t = 0; t < tiles; ++t) {  // ascending column tiles, strict '>'
    const float v = part_s[(size_t)t * r + row];
    if (v > best) {
      best = v;
      bj = part_j[(size_t)t * r + row];
    }
  }
  best_s[row] = best;
  best_j[row] = bj;
}

}  // namespace

extern "C" int sim_best_edge_col_tile() { return BN; }

// Scratch: part_s, part_j hold ceil(c / BN) * r entries each.
extern "C" int sim_best_edge(const float* xr, const float* xc, const int* lr,
                             const int* lc, int r, int c, int d, float* part_s,
                             int* part_j, int* best_j, float* best_s,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r == 0) return (int)cudaGetLastError();
  const int tiles = (c + BN - 1) / BN;
  if (tiles > 0) {
    const dim3 grid(tiles, (r + BM - 1) / BM);
    sim_best_edge_tile<<<grid, kThreads, 0, st>>>(xr, xc, lr, lc, r, c, d,
                                                  part_s, part_j);
    REPRO_CHECK_LAUNCH();
  }
  sim_best_edge_merge<<<(r + 255) / 256, 256, 0, st>>>(part_s, part_j, r, tiles,
                                                       best_j, best_s);
  REPRO_CHECK_LAUNCH();
  return 0;
}
