// Deterministic per-label fold shared by label_stats.cu and assign_stats.cu.
//
// Pass 1 (stats_fold): the grid is (d tiles of 128 columns, label tiles of 64
// labels, row chunks). A block walks its row chunk in row order; thread t owns
// column c0 + t of a (64, 128) shared-memory accumulator and adds w * x into
// the row of the row's label. Rows with a label outside [0, k), outside the
// block's label tile, or with weight 0 are skipped. Thread 0 of each d tile 0
// block also folds the per-label scalars: weight totals and, for assign_stats,
// the weighted squared norms and the lowest member similarity (w > 0 rows).
// Each block writes its partials for its own row chunk.
//
// Pass 2 (stats_reduce): one thread per output element adds the row-chunk
// partials in chunk order.
//
// No fp32 atomics anywhere: every sum is taken in a fixed order, so two runs
// give identical bits (checkpoint resume relies on this).
#pragma once

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace repro {

constexpr int kStatsBD = 128;  // columns per block == threads per block
constexpr int kStatsKT = 64;   // labels per block
constexpr int kStatsUnroll = 8;  // rows whose loads are issued together
constexpr float kBig = FLT_MAX;

// Row chunks: enough blocks for ~8 per SM, at least 256 rows per chunk.
inline int stats_chunks(int n, int k, int d) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = ((k + kStatsKT - 1) / kStatsKT) * ((d + kStatsBD - 1) / kStatsBD);
  const int want = (8 * sms + tiles - 1) / tiles;
  const int most = (n + 255) / 256;
  const int chunks = want < most ? want : most;
  return chunks > 1 ? chunks : 1;
}

// part: (chunks, k, d) sums; part_k: (chunks, 3, k) weight totals, weighted
// squared norms and lowest member similarity.
template <bool EXTRA>
__global__ void __launch_bounds__(kStatsBD)
    stats_fold(const float* __restrict__ x, const int* __restrict__ idx,
               const float* __restrict__ w, const float* __restrict__ rowsq,
               const float* __restrict__ sim, int n, int d, int k,
               int rows_per_chunk, float* __restrict__ part,
               float* __restrict__ part_k) {
  extern __shared__ float sm[];
  float* acc = sm;                          // (kStatsKT, kStatsBD)
  float* cnt = sm + kStatsKT * kStatsBD;    // (kStatsKT,)
  float* sq = cnt + kStatsKT;
  float* mn = sq + kStatsKT;
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * kStatsBD, k0 = blockIdx.y * kStatsKT;
  const int chunk = blockIdx.z;
  const int kt = min(kStatsKT, k - k0);
  const int col = c0 + t;
  const bool has_col = col < d;
  const bool scalars = blockIdx.x == 0 && t == 0;

  for (int l = 0; l < kt; ++l) acc[l * kStatsBD + t] = 0.f;
  if (t < kt) {
    cnt[t] = 0.f;
    sq[t] = 0.f;
    mn[t] = kBig;
  }
  __syncthreads();

  const int r0 = min(n, chunk * rows_per_chunk);
  const int r1 = min(n, r0 + rows_per_chunk);
  for (int base = r0; base < r1; base += kStatsUnroll) {
    int lab[kStatsUnroll];
    float wv[kStatsUnroll], xv[kStatsUnroll];
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u) {
      const int row = base + u;
      lab[u] = -1;
      wv[u] = 0.f;
      if (row < r1) {
        lab[u] = idx[row] - k0;
        wv[u] = w[row];
      }
      const bool use = lab[u] >= 0 && lab[u] < kt && wv[u] != 0.f;
      xv[u] = (use && has_col) ? x[(size_t)row * d + col] : 0.f;
      if (!use) lab[u] = -1;
    }
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u) {  // rows in order
      const int l = lab[u];
      if (l < 0) continue;
      if (has_col)
        acc[l * kStatsBD + t] =
            __fadd_rn(acc[l * kStatsBD + t], __fmul_rn(wv[u], xv[u]));
      if (scalars) {
        cnt[l] = __fadd_rn(cnt[l], wv[u]);
        if (EXTRA) {
          sq[l] = __fadd_rn(sq[l], __fmul_rn(wv[u], rowsq[base + u]));
          if (wv[u] > 0.f) mn[l] = fminf(mn[l], sim[base + u]);
        }
      }
    }
  }
  __syncthreads();

  if (has_col)
    for (int l = 0; l < kt; ++l)
      part[((size_t)chunk * k + k0 + l) * d + col] = acc[l * kStatsBD + t];
  if (blockIdx.x == 0 && t < kt) {
    float* pk = part_k + (size_t)chunk * 3 * k;
    pk[k0 + t] = cnt[t];
    pk[k + k0 + t] = sq[t];
    pk[2 * k + k0 + t] = mn[t];
  }
}

__global__ void stats_reduce(const float* __restrict__ part,
                             const float* __restrict__ part_k, int chunks,
                             int k, int d, float* __restrict__ sums,
                             float* __restrict__ counts,
                             float* __restrict__ min_sim,
                             float* __restrict__ sumsq) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t kd = (size_t)k * d;
  if (e < kd) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s = __fadd_rn(s, part[c * kd + e]);
    sums[e] = s;
  }
  if (e < (size_t)k) {
    float cn = 0.f, sq = 0.f, mn = kBig;
    for (int c = 0; c < chunks; ++c) {
      const float* pk = part_k + (size_t)c * 3 * k;
      cn = __fadd_rn(cn, pk[e]);
      sq = __fadd_rn(sq, pk[k + e]);
      mn = fminf(mn, pk[2 * k + e]);
    }
    counts[e] = cn;
    if (sumsq != nullptr) sumsq[e] = sq;
    if (min_sim != nullptr) min_sim[e] = cn > 0.f ? mn : kBig;
  }
}

// Both passes on `st`; min_sim and sumsq (with rowsq and sim) only for EXTRA.
template <bool EXTRA>
inline int launch_stats(const float* x, const int* idx, const float* w,
                        const float* rowsq, const float* sim, int n, int d,
                        int k, int chunks, float* part, float* part_k,
                        float* sums, float* counts, float* min_sim,
                        float* sumsq, cudaStream_t st) {
  const int rows_per_chunk = (n + chunks - 1) / chunks;
  const dim3 grid((d + kStatsBD - 1) / kStatsBD, (k + kStatsKT - 1) / kStatsKT,
                  chunks);
  const size_t smem = (size_t)(kStatsKT * kStatsBD + 3 * kStatsKT) * sizeof(float);
  stats_fold<EXTRA><<<grid, kStatsBD, smem, st>>>(x, idx, w, rowsq, sim, n, d,
                                                   k, rows_per_chunk, part, part_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t kd = (size_t)k * d;
  const size_t total = kd > (size_t)k ? kd : (size_t)k;
  stats_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, part_k, chunks, k, d, sums, counts, min_sim, sumsq);
  return (int)cudaGetLastError();
}

}  // namespace repro
