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
//
// bf16 x (label_stats and assign_stats take bf16 document rows) has a
// route of its own, with the same order of adds: stats_classes (from
// 65,536 rows) deals the labels to the consumer warps by their share of a
// sample of rows (a large cluster does not load one warp with its class's
// other labels too); stats_sort lists, once for every column tile, each
// warp's rows of each 256-row stage of each row chunk, sorted by label (the
// sorter warps' work, which the f32 route repeats in every block, and a
// large cluster's rows in runs of one label); stats_fold_bf16 streams
// 256-row stages (a 16 KB bf16 tile, the bytes of an f32 stage) with the
// lists beside them and no sorter warps, up to eight stages deep;
// stats_reduce as above. Each element is converted to f32 exactly as a
// consumer reads it, each label's rows of a chunk are added in row order,
// and the chunks are the f32 plan's (stats_chunks; a chunk border inside a
// stage cuts its list), so a bf16 fold has the bits of the f32 fold of
// x.float(). Where the copy engine cannot take bf16 rows (a row stride or
// base off 16 bytes: odd d, say) the producer loads them with plain 2-byte
// loads and stores.
#pragma once

#include <cfloat>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace repro {

constexpr int kStatsCols = 32;    // columns per block: one a lane
constexpr int kStatsRows = 128;   // rows per stage: one copy-engine box
constexpr int kStatsMaxWarps = 16;  // consumer warps (label classes), most
constexpr int kStatsTile = kStatsRows * kStatsCols * 4;  // x rows of a stage (bf16: half)
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
// over rows with w > 0. HAS_W: w given (else every weight is 1). st: the
// stage's x tile.
__device__ __forceinline__ float stats_x(const float* st, int i) { return st[i]; }
__device__ __forceinline__ float stats_x(const __nv_bfloat16* st, int i) {
  return __bfloat162float(st[i]);
}

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
        xu[u] = stats_x(st, r * kStatsCols + lane);
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
      } else if (!scalars) {  // one element a lane (4-byte asynchronous copies), zeros outside x
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

// ------------------------------------------------------------ bf16 route

constexpr int kB16Rows = 256;  // rows per stage: 16 KB of bf16 x, an f32 stage's bytes
constexpr int kB16ListHead = 20;  // a list slot: class c's entries start at [c], [W] the end,
constexpr int kB16ListSlot = kB16ListHead + kB16Rows + 3 * kStatsMaxWarps;  // then the entries
constexpr int kB16Tile = kB16Rows * kStatsCols * 2;
constexpr int kB16Lists = (kB16ListSlot * 4 + 127) / 128 * 128;
constexpr int kB16Meta = 3 * kB16Rows * 4;  // w, rowsq, sim
constexpr int kB16Stage = kB16Tile + kB16Lists + kB16Meta;
constexpr int kB16MaxStages = 8;
static_assert(kB16ListSlot * 4 % 16 == 0 && kB16ListHead % 4 == 0, "16-byte list slots");

// Label tiles only past what shared memory holds beside three stages. Four
// stages where that leaves an SM room for two blocks (8 consumer warps
// each), else one block an SM with as many stages as fit (up to eight) and
// 16 consumer warps.
inline StatsPlan stats_plan_bf16(int k) {
  const int most =
      (kStatsMaxSmem - kStatsSlack - kStatsPerLabel - 3 * kB16Stage) / kStatsPerLabel;
  StatsPlan p;
  p.tiles = (k + most - 1) / most;
  p.kt = (k + p.tiles - 1) / p.tiles;
  const int fixed = kStatsSlack + (p.kt + 1) * kStatsPerLabel;  // + a spare row
  const int fit = (kStatsMaxSmem - fixed) / kB16Stage;
  p.stages = fit < 4 ? fit : 4;
  p.per_sm = 233472 / (fixed + p.stages * kB16Stage + 1024);
  if (p.per_sm < 2) {
    p.per_sm = 1;
    p.stages = fit < kB16MaxStages ? fit : kB16MaxStages;
  }
  p.smem = fixed + p.stages * kB16Stage;
  p.warps = p.per_sm > 1 ? 8 : kStatsMaxWarps;
  return p;
}

// Stages of a row chunk, and the ints of the lists of every (label tile,
// chunk, stage) and of the labels' classes: they follow the partials in the
// fold's scratch (stats_lists_at).
inline int stats_b16_stages(int rows_per_chunk) {
  return (rows_per_chunk + kB16Rows - 1) / kB16Rows;
}

inline int stats_rows_per_chunk(int n, int chunks) {
  const int r = (n + chunks - 1) / chunks;
  return (r + kStatsRows - 1) / kStatsRows * kStatsRows;
}

inline int stats_list_ints(int n, int k, int chunks) {
  return stats_plan_bf16(k).tiles * chunks * stats_b16_stages(stats_rows_per_chunk(n, chunks)) *
             kB16ListSlot +
         k;  // then each label's class
}

inline int* stats_lists_at(float* part, int chunks, int k, int d) {
  return reinterpret_cast<int*>(part + ((size_t)chunks * k * (d + 3) + 31) / 32 * 32);
}

// Which consumer warp (class) folds each label: one block a label tile
// counts the rows each label takes among kClassSample rows spread evenly
// over x (w != 0), as the lengths of the runs of the sorted sample, sorts
// the labels seen by that count, falling (ties: the lower label first),
// and deals them in rounds of W, the largest of a round to the class with
// the fewest sampled rows so far (ties: the lower class); a label the
// sample missed goes to class l % W. So no warp's list runs much longer
// than the others' when a few clusters are large. Who adds a label never
// changes the order of its adds. No atomics: every count is a run.
constexpr int kClassSample = 1024;  // one a thread
// Below this many rows the deal (one block, about 20 us on an H100) costs
// more than it saves, and each label's class is l % W.
constexpr int kClassMinRows = 65536;

// Bitonic sort of v[0 .. kClassSample) by the block, one element a thread,
// rising (FALL: falling).
template <typename V, bool FALL>
__device__ __forceinline__ void block_sort(V* v) {
  const int i = threadIdx.x;
  for (int size = 2; size <= kClassSample; size <<= 1)
    for (int half = size >> 1; half > 0; half >>= 1) {
      const int j = i ^ half;
      if (j > i) {
        const V a = v[i], b = v[j];
        if (((i & size) == 0) == FALL ? a < b : a > b) {
          v[i] = b;
          v[j] = a;
        }
      }
      __syncthreads();
    }
}

__global__ void __launch_bounds__(kClassSample)
    stats_classes(const int* __restrict__ idx, const float* __restrict__ w, int n, int k,
                  int kt, int nw, int* __restrict__ classes) {
  __shared__ int sample[kClassSample];  // sampled labels within the tile, others last
  __shared__ unsigned long long key[kClassSample];  // a run's start: count << 32 | 0xffff - label
  const int i = threadIdx.x, lane = i & 31;
  const int k0 = blockIdx.x * kt, ktile = min(kt, k - k0);
  for (int l = i; l < ktile; l += kClassSample) classes[k0 + l] = l & (nw - 1);
  const int row = (int)((long long)i * n / kClassSample);
  const int lab = row < n && (w == nullptr || w[row] != 0.f) ? idx[row] - k0 : -1;
  sample[i] = lab >= 0 && lab < ktile ? lab : INT_MAX;
  __syncthreads();
  block_sort<int, false>(sample);
  const int v = sample[i];
  int past = i + 1;  // a run's start finds its end
  if (v != INT_MAX && (i == 0 || sample[i - 1] != v))
    while (past < kClassSample && sample[past] == v) ++past;
  key[i] = v != INT_MAX && (i == 0 || sample[i - 1] != v)
               ? (unsigned long long)(past - i) << 32 | (0xffffull - v)
               : 0ull;  // not a run's start: last in falling order
  __syncthreads();
  block_sort<unsigned long long, true>(key);
  if (i >= 32) return;
  unsigned load = 0;  // lane c < W: the sampled rows of class c so far
  for (int base = 0; base < kClassSample && key[base] != 0ull; base += nw) {
    int rank = 0;  // this class's place in rising order of load
    for (int c = 0; c < nw; ++c) {
      const unsigned other = __shfl_sync(0xffffffffu, load, c);
      rank += other < load || (other == load && c < lane);
    }
    const unsigned long long e = lane < nw && base + rank < kClassSample ? key[base + rank] : 0ull;
    if (e != 0ull) {  // the fewest rows take the round's largest
      classes[k0 + (int)(0xffff - (e & 0xffff))] = lane;
      load += (unsigned)(e >> 32);
    }
  }
}

// One warp a (chunk stage, label tile): each class's rows (the labels
// stats_classes gave it, or l % W where classes is null; w != 0, before the
// chunk's end) of the stage as row | label << 8 (label within the tile),
// sorted by label with each label's rows in row order (only the order
// within a label counts), padded to a multiple of four with rows of the
// spare label, written to the stage's slot. A group of four rows of one
// label (a run: a large cluster's rows) is marked by the sign bit of its
// first entry.
__global__ void __launch_bounds__(32)
    stats_sort(const int* __restrict__ idx, const float* __restrict__ w,
               const int* __restrict__ classes, int n, int k, int kt, int nw,
               int rows_per_chunk, int spc, int* __restrict__ lists) {
  __shared__ int cls_rows[kStatsMaxWarps][kB16Rows];
  __shared__ int sorted[kB16ListSlot - kB16ListHead];
  __shared__ int lens[kStatsMaxWarps];
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1;
  const int chunk = blockIdx.x / spc, s = blockIdx.x % spc;
  const int k0 = blockIdx.y * kt, ktile = min(kt, k - k0);
  const int r0 = min(n, chunk * rows_per_chunk);
  const int r1 = min(n, r0 + rows_per_chunk);
  const int row0 = r0 + s * kB16Rows;
  if (lane < nw) lens[lane] = 0;
  __syncwarp();
  for (int b = 0; b < kB16Rows; b += 32) {  // each class's rows in row order
    const int r = b + lane, row = row0 + r;
    int lab = -1;
    float wv = 1.f;
    if (row < r1) {
      lab = idx[row] - k0;
      if (w != nullptr) wv = w[row];
    }
    const bool own = lab >= 0 && lab < ktile && wv != 0.f;
    const int cls = !own ? -1 : classes != nullptr ? classes[k0 + lab] : lab & (nw - 1);
    const unsigned peers = __match_any_sync(0xffffffffu, cls);
    const int at = own ? lens[cls] + __popc(peers & below) : 0;
    __syncwarp();
    if (own) {
      cls_rows[cls][at] = r | (lab << 8);
      if ((peers & below) == 0) lens[cls] += __popc(peers);  // the class's first lane
    }
    __syncwarp();
  }
  const int len = lane < nw ? lens[lane] : 0;
  const int padded = (len + 3) & ~3;
  int end = padded;  // inclusive prefix over the classes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, end, o);
    if (lane >= o) end += t;
  }
  for (int c = 0; c < nw; ++c) {  // a row's place: the rows of lower labels, and its own
    const int start = __shfl_sync(0xffffffffu, end - padded, c);  // label's earlier rows
    const int lc = __shfl_sync(0xffffffffu, len, c);
    const int pc = __shfl_sync(0xffffffffu, padded, c);
    for (int i = lane; i < lc; i += 32) {
      const int e = cls_rows[c][i], lab = e >> 8;
      int rank = 0;
      for (int j = 0; j < lc; ++j) {
        const int f = cls_rows[c][j] >> 8;
        rank += f < lab || (f == lab && j < i);
      }
      sorted[start + rank] = e;
    }
    for (int i = lc + lane; i < pc; i += 32) sorted[start + i] = ktile << 8;
  }
  __syncwarp();
  int* slot = lists + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kB16ListSlot;
  if (lane < nw) slot[lane] = end - padded;
  const int total = __shfl_sync(0xffffffffu, end, nw - 1);
  if (lane == 0) slot[nw] = total;
  for (int i = lane; i < total; i += 32) {
    int e = sorted[i];
    if (i % 4 == 0 && (sorted[i + 1] >> 8) == (e >> 8) && (sorted[i + 2] >> 8) == (e >> 8) &&
        (sorted[i + 3] >> 8) == (e >> 8))
      e |= 1 << 31;
    slot[kB16ListHead + i] = e;
  }
}

// A consumer warp's rows of a bf16 stage (stats_sort's list: one LDS a
// group of four): a marked group of four rows of one label adds them to
// one running sum, loaded and stored once; in any other group a row whose
// label the row before it had (the list is sorted by label) takes that
// row's sum. The adds are those of fold_list.
template <bool EXTRA, bool SCAL, bool HAS_W>
__device__ __forceinline__ void fold_sorted(const int* list, int len, const __nv_bfloat16* st,
                                            const float* mw, float* acc, int lane) {
  for (int g0 = 0; g0 < len; g0 += 4) {
    const int4 e4 = *reinterpret_cast<const int4*>(list + g0);
    const int e[4] = {e4.x, e4.y, e4.z, e4.w};
    float wu[4], xu[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = e[u] & 255;
      wu[u] = HAS_W ? mw[r] : 1.f;
      if (SCAL)
        xu[u] = lane == 0 ? 1.f
                : !EXTRA  ? 0.f
                : lane == 1 ? mw[kB16Rows + r] : mw[2 * kB16Rows + r];
      else
        xu[u] = stats_x(st, r * kStatsCols + lane);
    }
    auto add = [&](float base, int u) {
      if (SCAL && lane == 2) return wu[u] > 0.f ? fminf(base, xu[u]) : base;
      return HAS_W ? __fadd_rn(base, __fmul_rn(wu[u], xu[u])) : __fadd_rn(base, xu[u]);
    };
    if (e4.x < 0) {  // a run
      float* a = acc + ((e4.x >> 8) & 0x7fffff) * kStatsCols + lane;
      float cur = *a;
#pragma unroll
      for (int u = 0; u < 4; ++u) cur = add(cur, u);
      *a = cur;
      continue;
    }
    int lu[4];
    float cur[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      lu[u] = e[u] >> 8;
      cur[u] = acc[lu[u] * kStatsCols + lane];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      cur[u] = add(u > 0 && lu[u] == lu[u - 1] ? cur[u - 1] : cur[u], u);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[lu[u] * kStatsCols + lane] = cur[u];
  }
}

// stats_fold on bf16 x with stats_sort's lists: the grid and outputs of
// stats_fold; W consumer warps (W = blockDim.x / 32 - 1) and a producer
// warp, which copies each stage's x tile (256 rows), its lists and the
// rows' w (and, for the scalars' block, rowsq and sim).
template <bool EXTRA>
__global__ void __launch_bounds__((kStatsMaxWarps + 1) * 32)
    stats_fold_bf16(const __grid_constant__ CUtensorMap xmap, int tma,
                    const __nv_bfloat16* __restrict__ x, const int* __restrict__ lists,
                    const float* __restrict__ w, const float* __restrict__ rowsq,
                    const float* __restrict__ sim, int n, int d, int k, int kt, int stages,
                    int rows_per_chunk, int spc, float* __restrict__ part,
                    float* __restrict__ part_k) {
  extern __shared__ unsigned char raw[];
  unsigned char* ring = raw + ((128u - (smem_addr(raw) & 127u)) & 127u);
  float* acc = reinterpret_cast<float*>(ring + stages * kB16Stage);  // (kt + 1, 32)
  uint64_t* full = reinterpret_cast<uint64_t*>(acc + (kt + 1) * kStatsCols);
  uint64_t* empty = full + stages;

  const int nw = blockDim.x / 32 - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool scalars = blockIdx.x == gridDim.x - 1;
  const int c0 = blockIdx.x * kStatsCols, k0 = blockIdx.y * kt;
  const int chunk = blockIdx.z;
  const int ktile = min(kt, k - k0);
  const int r0 = min(n, chunk * rows_per_chunk);
  const int r1 = min(n, r0 + rows_per_chunk);
  const int nst = (r1 - r0 + kB16Rows - 1) / kB16Rows;
  const int* slots = lists + ((size_t)blockIdx.y * gridDim.z * spc + (size_t)chunk * spc) *
                                 kB16ListSlot;

  for (int i = threadIdx.x; i < (ktile + 1) * kStatsCols; i += blockDim.x)
    acc[i] = scalars && i % kStatsCols == 2 ? kBig : 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], nw);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // a stage: x rows (kB16Rows, 32) bf16, the lists, then w, rowsq, sim of each row
  auto stage = [&](int s) { return ring + s * kB16Stage; };

  if (warp == nw) {  // producer
    for (int j = 0; j < nst; ++j) {
#ifdef REPRO_FOLD_DELAY_STAGES
      // Debug build (the sorter-race test only): as in stats_fold, each odd
      // stage's copies go out after the next stage's, after a pause.
      const int i = j % 2 == 1 && j + 1 < nst ? j + 1 : j % 2 == 0 && j > 0 ? j - 1 : j;
      if (i < j)
        for (int t = 0; t < 20; ++t) __nanosleep(1000);
#else
      const int i = j;
#endif
      const int s = i % stages;
      mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(stage(s));
      int* slot = reinterpret_cast<int*>(stage(s) + kB16Tile);
      float* mw = reinterpret_cast<float*>(stage(s) + kB16Tile + kB16Lists);
      const int row0 = r0 + i * kB16Rows;
      const bool box = tma && !scalars;
      if (lane == 0) {
        mbar_expect_tx(&full[s], kB16ListSlot * 4 + (box ? kB16Tile : 0));
        if (box) tma_load_2d(dst, &xmap, c0, row0, &full[s]);
        bulk_load(slot, slots + (size_t)i * kB16ListSlot, kB16ListSlot * 4, &full[s]);
      }
      if (!tma && !scalars) {  // one element a lane, plain 2-byte loads; zeros outside x
        const int col = c0 + lane;
        for (int r = 0; r < kB16Rows; ++r) {
          const int rr = row0 + r;
          reinterpret_cast<unsigned short*>(dst)[r * kStatsCols + lane] =
              rr < r1 && col < d
                  ? reinterpret_cast<const unsigned short*>(x)[(size_t)rr * d + col]
                  : 0;
        }
      }
#pragma unroll
      for (int b = 0; b < kB16Rows; b += 32) {
        const int row = row0 + b + lane;
        const int at = min(row, n - 1);  // a valid address; nothing is read past r1
        const int bytes = row < r1 ? 4 : 0;
        if (w != nullptr) cp_async4(mw + b + lane, w + at, bytes);
        if (EXTRA && scalars) {
          cp_async4(mw + kB16Rows + b + lane, rowsq + at, bytes);
          cp_async4(mw + 2 * kB16Rows + b + lane, sim + at, bytes);
        }
      }
      producer_arrive(&full[s], !tma && !scalars);
    }
  } else {  // consumers: warp owns labels l with l % W == warp
    for (int i = 0; i < nst; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(stage(s));
      const int* slot = reinterpret_cast<const int*>(stage(s) + kB16Tile);
      const float* mw = reinterpret_cast<const float*>(stage(s) + kB16Tile + kB16Lists);
      const int* list = slot + kB16ListHead + slot[warp];
      const int len = slot[warp + 1] - slot[warp];  // a multiple of four
      if (scalars)  // mw holds w, rowsq and sim
        w != nullptr ? fold_sorted<EXTRA, true, true>(list, len, st, mw, acc, lane)
                     : fold_sorted<EXTRA, true, false>(list, len, st, mw, acc, lane);
      else
        w != nullptr ? fold_sorted<EXTRA, false, true>(list, len, st, mw, acc, lane)
                     : fold_sorted<EXTRA, false, false>(list, len, st, mw, acc, lane);
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

// Both passes on `st`; min_sim and sumsq (with rowsq and sim) only for EXTRA.
// x (f32 or bf16) goes through the copy engine when its rows are 16-byte
// multiples from a 16-byte-aligned base and it spans at least one box;
// otherwise the producer warp loads it. bf16 x takes its own route
// (stats_classes, stats_sort, stats_fold_bf16), its lists in the scratch after part_k
// (stats_lists_at; stats_list_ints ints).
// per library, per kernel [EXTRA][bf16]: devices whose limit is raised
static unsigned fold_smem_set[2][2] = {};

template <bool EXTRA, typename T>
inline int launch_stats(const T* x, const int* idx, const float* w,
                        const float* rowsq, const float* sim, int n, int d,
                        int k, int chunks, float* part, float* part_k,
                        float* sums, float* counts, float* min_sim,
                        float* sumsq, cudaStream_t st) {
  constexpr bool kF32 = sizeof(T) == 4;
  const StatsPlan p = kF32 ? stats_plan(k) : stats_plan_bf16(k);
  int err = kF32 ? allow_smem(stats_fold<EXTRA>, kStatsMaxSmem, fold_smem_set[EXTRA][0])
                 : allow_smem(stats_fold_bf16<EXTRA>, kStatsMaxSmem, fold_smem_set[EXTRA][1]);
  if (err != 0) return err;
  const int rows_per_chunk = stats_rows_per_chunk(n, chunks);
  const int box_rows = kF32 ? kStatsRows : kB16Rows;
  CUtensorMap map{};
  const int tma = n >= box_rows && d >= kStatsCols && d % (16 / (int)sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(T)};
    const cuuint32_t box[2] = {kStatsCols, (cuuint32_t)box_rows};
    err = make_tensor_map(&map,
                          kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          2, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
  }
  // the column tiles, then one column of blocks for the scalars
  const dim3 grid((d + kStatsCols - 1) / kStatsCols + 1, p.tiles, chunks);
  if constexpr (kF32) {
    stats_fold<EXTRA><<<grid, (p.warps + 3) * 32, p.smem, st>>>(
        map, tma, x, idx, w, rowsq, sim, n, d, k, p.kt, p.stages, rows_per_chunk,
        part, part_k);
  } else {
    const int spc = stats_b16_stages(rows_per_chunk);
    int* lists = stats_lists_at(part, chunks, k, d);
    if (spc > 0) {
      int* classes = nullptr;
      if (n >= kClassMinRows) {
        classes = lists + (size_t)p.tiles * chunks * spc * kB16ListSlot;
        stats_classes<<<p.tiles, kClassSample, 0, st>>>(idx, w, n, k, p.kt, p.warps, classes);
      }
      stats_sort<<<dim3(chunks * spc, p.tiles), 32, 0, st>>>(idx, w, classes, n, k, p.kt, p.warps,
                                                              rows_per_chunk, spc, lists);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    stats_fold_bf16<EXTRA><<<grid, (p.warps + 1) * 32, p.smem, st>>>(
        map, tma, x, lists, w, rowsq, sim, n, d, k, p.kt, p.stages, rows_per_chunk, spc, part,
        part_k);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t kd = (size_t)k * d;
  const size_t total = kd > (size_t)k ? kd : (size_t)k;
  stats_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, part_k, chunks, k, d, sums, counts, min_sim, sumsq);
  return (int)cudaGetLastError();
}

}  // namespace repro
