// Deterministic per-label fold shared by label_stats.cu, assign_stats.cu and
// assign_stats_bounded.cu.
//
// Pass 1 (stats_fold): the grid is (column tiles of 32, label tiles, row
// chunks). A block keeps the accumulators of all the labels of its label
// tile for its 32 columns in shared memory (kt x 32 floats: 100 KB at
// k = 800, so one label tile up to ~1,180 labels), and x passes through
// once, whatever k: one producer warp fills a ring of 128-row stages with
// the copy engine (TMA, one 2-D box a stage, an mbarrier per stage), or,
// where x has no 16-byte row stride or base, with coalesced 4-byte
// asynchronous copies into the same ring; the same warp copies each stage's
// labels, weights (and, for assign_stats, squared norms and similarities)
// beside it, so no consumer waits on a load from device memory.
// Two sorter warps (one the ring's even slots, the other its odd ones) list
// each label class's rows of a stage in row order (one match per 32 rows). W consumer warps (16 when a
// block has its SM to itself, else 8) each own the labels l with
// l % W == warp, lane c owning
// column c, and take their list four rows at a time: their loads go out
// together, the adds follow in row order, and a row whose label an earlier
// row of the four had takes that row's running sum from a register, so a
// run of one label costs no shared-memory round trip; the sums go back in
// row order (the adds, and so the bits, are those of one row after another;
// W changes who adds, not the order). One more column of blocks folds the
// per-label scalars the same way, with (1, rowsq, sim) in place of a row of
// x: weight totals and, for assign_stats, the weighted squared norms and
// the lowest member similarity (w > 0 rows). Rows with a label outside
// [0, k) or weight 0 are skipped; a null w reads as weight 1.
// Each block writes its partials for its own row chunk.
//
// Pass 2 (stats_reduce): one thread per output element adds the row-chunk
// partials in chunk order.
//
// No fp32 atomics anywhere: every sum is taken in a fixed order, so two runs
// give identical bits (checkpoint resume relies on this). The plan (label
// tiles, stages, chunks) depends on (n, k, d) and the card only, so the
// fused, two-pass and bounded routes fold in the same order.
#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace repro {

constexpr int kStatsCols = 32;    // columns per block: one a lane
constexpr int kStatsRows = 128;   // rows per stage: one copy-engine box
constexpr int kStatsMaxWarps = 16;  // consumer warps (label classes), most
constexpr int kStatsTile = kStatsRows * kStatsCols * 4;  // x rows of a stage
constexpr int kStatsMeta = 4 * kStatsRows * 4;  // label, w, rowsq, sim
constexpr int kStatsLists = kStatsMaxWarps * kStatsRows * 4 + 128;  // + their lengths; keeps stages 128-byte aligned
constexpr int kStatsStage = kStatsTile + kStatsMeta + kStatsLists;
constexpr int kStatsMaxStages = 4;
constexpr int kStatsMaxSmem = 232448;  // 227 KB, a block's most on an H100
constexpr int kStatsSlack = 384;       // base alignment and the barriers
constexpr int kStatsPerLabel = kStatsCols * 4;  // a row of sums
constexpr float kBig = FLT_MAX;

struct StatsPlan {
  int kt;       // labels per label tile
  int tiles;    // label tiles
  int stages;   // ring depth
  int smem;     // dynamic shared memory of a block, bytes
  int per_sm;   // blocks an SM holds
  int warps;    // consumer warps a block
};

// Label tiles only past what shared memory holds beside three stages; the
// ring takes what is left, up to four stages. A block that has an SM to
// itself gets 16 consumer warps to hide latency, else 8.
inline StatsPlan stats_plan(int k) {
  const int most =
      (kStatsMaxSmem - kStatsSlack - kStatsPerLabel - 3 * kStatsStage) / kStatsPerLabel;
  StatsPlan p;
  p.tiles = (k + most - 1) / most;
  p.kt = (k + p.tiles - 1) / p.tiles;
  const int fixed = kStatsSlack + (p.kt + 1) * kStatsPerLabel;  // + a spare row
  p.stages = (kStatsMaxSmem - fixed) / kStatsStage;
  if (p.stages > kStatsMaxStages) p.stages = kStatsMaxStages;
  p.smem = fixed + p.stages * kStatsStage;
  p.per_sm = 233472 / (p.smem + 1024);  // 228 KB an SM, 1 KB reserved a block
  p.warps = p.per_sm > 1 ? 8 : kStatsMaxWarps;
  const int by_threads = 2048 / ((p.warps + 3) * 32);
  if (by_threads < p.per_sm) p.per_sm = by_threads;
  if (p.per_sm < 1) p.per_sm = 1;
  return p;
}

// Row chunks: one wave of blocks over the card, at least 256 rows a chunk.
// The chunk count sets the order of the sums' last adds, so it depends on
// (n, k, d) and the card only.
inline int stats_chunks(int n, int k, int d) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const StatsPlan p = stats_plan(k);
  const int tiles = p.tiles * ((d + kStatsCols - 1) / kStatsCols + 1);  // + the scalars
  const int want = sms * p.per_sm / tiles;
  const int most = (n + 255) / 256;
  const int chunks = want < most ? want : most;
  return chunks > 1 ? chunks : 1;
}

// A consumer warp's rows of one stage: `list` (row | label << 8, a multiple
// of four long) four rows at a time, their loads issued together, then the
// adds in row order, a row whose label an earlier one of the four had taking
// that row's sum from a register; the sums go back in row order. SCAL: the
// scalars' block, whose columns are (1, rowsq, sim), the third a minimum
// over rows with w > 0. HAS_W: w given (else every weight is 1).
template <bool EXTRA, bool SCAL, bool HAS_W>
__device__ __forceinline__ void fold_list(const int* list, int len, const float* st,
                                          const float* mw, float* acc, int lane) {
  for (int g0 = 0; g0 < len; g0 += 4) {
    int lu[4];
    float wu[4], xu[4], cur[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = list[g0 + u];
      const int r = e & 255;
      lu[u] = e >> 8;
      wu[u] = HAS_W ? mw[r] : 1.f;
      if (SCAL)
        xu[u] = lane == 0 ? 1.f
                : !EXTRA  ? 0.f
                : lane == 1 ? mw[kStatsRows + r] : mw[2 * kStatsRows + r];
      else
        xu[u] = st[r * kStatsCols + lane];
      cur[u] = acc[lu[u] * kStatsCols + lane];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float base = cur[u];
#pragma unroll
      for (int v = 0; v < u; ++v)
        if (lu[v] == lu[u]) base = cur[v];
      if (SCAL && lane == 2)
        cur[u] = wu[u] > 0.f ? fminf(base, xu[u]) : base;
      else
        cur[u] = HAS_W ? __fadd_rn(base, __fmul_rn(wu[u], xu[u])) : __fadd_rn(base, xu[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[lu[u] * kStatsCols + lane] = cur[u];
  }
}

// part: (chunks, k, d) sums; part_k: (chunks, 3, k) weight totals, weighted
// squared norms and lowest member similarity. Blocks with blockIdx.x below
// the column tiles fold x; the last column of blocks folds the per-label
// scalars as three columns of their own: (1, rowsq, sim) in place of x, the
// third kept as a minimum over rows with w > 0. The block is W consumer
// warps (W = blockDim.x / 32 - 3, a power of two), two sorter warps (even
// and odd slots of the ring) and a producer warp.
template <bool EXTRA>
__global__ void __launch_bounds__((kStatsMaxWarps + 3) * 32)
    stats_fold(const __grid_constant__ CUtensorMap xmap, int tma,
               const float* __restrict__ x, const int* __restrict__ idx,
               const float* __restrict__ w, const float* __restrict__ rowsq,
               const float* __restrict__ sim, int n, int d, int k, int kt,
               int stages, int rows_per_chunk, float* __restrict__ part,
               float* __restrict__ part_k) {
  extern __shared__ unsigned char raw[];
  // aligned by an offset from raw, not through an integer, so the compiler
  // keeps every access below a shared-memory one (LDS/STS, not generic)
  unsigned char* ring = raw + ((128u - (smem_addr(raw) & 127u)) & 127u);
  float* acc = reinterpret_cast<float*>(ring + stages * kStatsStage);  // (kt + 1, 32)
  uint64_t* full = reinterpret_cast<uint64_t*>(acc + (kt + 1) * kStatsCols);
  uint64_t* sorted = full + stages;
  uint64_t* empty = sorted + stages;

  const int nw = blockDim.x / 32 - 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool scalars = blockIdx.x == gridDim.x - 1;
  const int c0 = blockIdx.x * kStatsCols, k0 = blockIdx.y * kt;
  const int chunk = blockIdx.z;
  const int ktile = min(kt, k - k0);
  const int r0 = min(n, chunk * rows_per_chunk);
  const int r1 = min(n, r0 + rows_per_chunk);
  const int nst = (r1 - r0 + kStatsRows - 1) / kStatsRows;

  for (int i = threadIdx.x; i < (ktile + 1) * kStatsCols; i += blockDim.x)
    acc[i] = scalars && i % kStatsCols == 2 ? kBig : 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);    // the producer warp's lanes
      mbar_init(&sorted[s], 32);  // the sorter warp's lanes
      mbar_init(&empty[s], nw + 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // a stage: x rows (kStatsRows, 32), then label, w, rowsq, sim of each row,
  // then each class's list of (row | label << 8) and the lists' lengths
  auto stage = [&](int s) { return ring + s * kStatsStage; };

  if (warp == nw + 2) {  // producer
    for (int j = 0; j < nst; ++j) {
#ifdef REPRO_FOLD_DELAY_STAGES
      // Debug build (the sorter-race test only): each odd stage's copies go
      // out after the next stage's, and after a pause, so a later stage's
      // copies land first. Rings have at least three stages, so stage j + 1
      // waits only on stages before j.
      const int i = j % 2 == 1 && j + 1 < nst ? j + 1 : j % 2 == 0 && j > 0 ? j - 1 : j;
      if (i < j)
        for (int t = 0; t < 20; ++t) __nanosleep(1000);
#else
      const int i = j;
#endif
      const int s = i % stages;
      mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
      float* dst = reinterpret_cast<float*>(stage(s));
      int* mlab = reinterpret_cast<int*>(stage(s) + kStatsTile);
      float* mw = reinterpret_cast<float*>(mlab + kStatsRows);
      const int row0 = r0 + i * kStatsRows;
      if (tma && !scalars) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], kStatsTile);
          tma_load_2d(dst, &xmap, c0, row0, &full[s]);
        }
      } else if (!scalars) {  // 4-byte asynchronous copies, zeros outside x
        const int col = c0 + lane;
        for (int r = 0; r < kStatsRows; ++r) {
          const int rr = row0 + r;
          const bool in = rr < r1 && col < d;
          cp_async4(dst + r * kStatsCols + lane, x + (in ? (size_t)rr * d + col : 0), in ? 4 : 0);
        }
      }
#pragma unroll
      for (int b = 0; b < kStatsRows; b += 32) {
        const int row = row0 + b + lane;
        const int at = min(row, n - 1);  // a valid address; nothing is read past r1
        const int bytes = row < r1 ? 4 : 0;
        cp_async4(mlab + b + lane, idx + at, bytes);
        if (w != nullptr) cp_async4(mw + b + lane, w + at, bytes);
        if (EXTRA && scalars) {
          cp_async4(mw + kStatsRows + b + lane, rowsq + at, bytes);
          cp_async4(mw + 2 * kStatsRows + b + lane, sim + at, bytes);
        }
      }
      cp_async_arrive(&full[s]);
    }
  } else if (warp >= nw) {  // sorters: each class's rows of a stage, in row order
    // A sorter owns slots of the ring, not stages: it waits on every phase of
    // each slot it owns, in order. (Owning alternate stages would, with an odd
    // ring, see only every other phase of a slot, and a parity wait on a phase
    // two ahead returns at once.)
    const unsigned below = (1u << lane) - 1;
    for (int i = 0; i < nst; ++i) {
      const int s = i % stages;
      if ((s & 1) != warp - nw) continue;
      mbar_wait(&full[s], (i / stages) & 1);
      const int* mlab = reinterpret_cast<const int*>(stage(s) + kStatsTile);
      const float* mw = reinterpret_cast<const float*>(mlab + kStatsRows);
      int* lists = reinterpret_cast<int*>(stage(s) + kStatsTile + kStatsMeta);
      int* lens = lists + kStatsMaxWarps * kStatsRows;
      if (lane < nw) lens[lane] = 0;
      __syncwarp();
#pragma unroll
      for (int b = 0; b < kStatsRows; b += 32) {
        const int r = b + lane;
        const int lab = r0 + i * kStatsRows + r < r1 ? mlab[r] - k0 : -1;
        const float wv = w != nullptr ? mw[r] : 1.f;
        const bool own = lab >= 0 && lab < ktile && wv != 0.f;
        const int cls = own ? (lab & (nw - 1)) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, cls);
        const int at = own ? lens[cls] + __popc(peers & below) : 0;
        __syncwarp();
        if (own) {
          lists[cls * kStatsRows + at] = r | (lab << 8);
          if ((peers & below) == 0) lens[cls] += __popc(peers);  // the class's first lane
        }
        __syncwarp();
      }
      // pad each list to a multiple of four with rows of the spare label
      if (lane < nw) {
        int len = lens[lane];
        while (len % 4) lists[lane * kStatsRows + len++] = ktile << 8;
        lens[lane] = len;
      }
      __syncwarp();
      mbar_arrive(&sorted[s]);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  } else {  // consumers: warp owns labels l with l % W == warp
    for (int i = 0; i < nst; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      mbar_wait(&sorted[s], (i / stages) & 1);
      const float* st = reinterpret_cast<const float*>(stage(s));
      const float* mw = reinterpret_cast<const float*>(stage(s) + kStatsTile) + kStatsRows;
      const int* lists = reinterpret_cast<const int*>(stage(s) + kStatsTile + kStatsMeta);
      const int* list = lists + warp * kStatsRows;            // this class's rows
      const int len = lists[kStatsMaxWarps * kStatsRows + warp];  // a multiple of four
      if (scalars)  // mw holds w, rowsq and sim
        w != nullptr ? fold_list<EXTRA, true, true>(list, len, st, mw, acc, lane)
                     : fold_list<EXTRA, true, false>(list, len, st, mw, acc, lane);
      else
        w != nullptr ? fold_list<EXTRA, false, true>(list, len, st, mw, acc, lane)
                     : fold_list<EXTRA, false, false>(list, len, st, mw, acc, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  __syncthreads();

  if (scalars) {
    float* pk = part_k + (size_t)chunk * 3 * k;
    for (int l = threadIdx.x; l < ktile; l += blockDim.x) {
      pk[k0 + l] = acc[l * kStatsCols];
      pk[k + k0 + l] = acc[l * kStatsCols + 1];
      pk[2 * k + k0 + l] = acc[l * kStatsCols + 2];
    }
    return;
  }
  for (int i = threadIdx.x; i < ktile * kStatsCols; i += blockDim.x) {
    const int l = i / kStatsCols, col = c0 + i % kStatsCols;
    if (col < d) part[((size_t)chunk * k + k0 + l) * d + col] = acc[i];
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
// x goes through the copy engine when its rows are 16-byte multiples from a
// 16-byte-aligned base and it spans at least one box; otherwise the
// producer warp loads it.
static unsigned fold_smem_set[2] = {0, 0};  // per library: devices whose limit is raised

template <bool EXTRA>
inline int launch_stats(const float* x, const int* idx, const float* w,
                        const float* rowsq, const float* sim, int n, int d,
                        int k, int chunks, float* part, float* part_k,
                        float* sums, float* counts, float* min_sim,
                        float* sumsq, cudaStream_t st) {
  const StatsPlan p = stats_plan(k);
  int err = allow_smem(stats_fold<EXTRA>, kStatsMaxSmem, fold_smem_set[EXTRA]);
  if (err != 0) return err;
  int rows_per_chunk = (n + chunks - 1) / chunks;
  rows_per_chunk = (rows_per_chunk + kStatsRows - 1) / kStatsRows * kStatsRows;
  CUtensorMap map{};
  const int tma = n >= kStatsRows && d >= kStatsCols && d % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
    const cuuint32_t box[2] = {kStatsCols, kStatsRows};
    err = make_tensor_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, dims,
                          strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
  }
  // the column tiles, then one column of blocks for the scalars
  const dim3 grid((d + kStatsCols - 1) / kStatsCols + 1, p.tiles, chunks);
  stats_fold<EXTRA><<<grid, (p.warps + 3) * 32, p.smem, st>>>(
      map, tma, x, idx, w, rowsq, sim, n, d, k, p.kt, p.stages, rows_per_chunk,
      part, part_k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t kd = (size_t)k * d;
  const size_t total = kd > (size_t)k ? kd : (size_t)k;
  stats_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, part_k, chunks, k, d, sums, counts, min_sim, sumsq);
  return (int)cudaGetLastError();
}

}  // namespace repro
