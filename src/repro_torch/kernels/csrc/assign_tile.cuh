// Nearest-center tile shared by assign_stats.cu and assign_argmax.cu, on the
// pipelined product tile of assign_pipe.cuh.
//
// The grid runs over (row tile of 128, center tile of 128), the center tiles
// of one row tile adjacent in launch order: the blocks of a row tile run
// side by side and read its rows of x from device memory about once, the
// others from L2. A block is one producer warp and 8 consumer warps, each
// consumer thread 8 rows x up to 8 centers (fewer in a narrow last tile); x
// and the center tile pass through a four-stage ring, 32 columns of d a
// stage. Within a tile the row maximum goes to the lowest center (value
// desc, id asc); with one center tile the block writes idx and best_sim,
// with more it writes its tile's (best, id) and a second launch merges the
// tiles in tile order with a strict '>', so an earlier tile keeps a tie. So
// idx is the argmax over centers of x . c with ties to the lowest index,
// and best_sim its value, each similarity one fmaf chain over d in order.
//
// With ROWSQ the blocks of center tile 0 also write each row's squared norm
// (the same fmaf chain, summed while the row passes through the ring).
//
// x and the centers are f32 here (assign_argmax, and assign_stats' f32
// mode). bf16 x (assign_stats' bf16 mode) runs launch_assign_tile_wg below
// on the tensor cores (wgmma_tile.cuh): bf16 centers as they are, f32
// centers as three bf16 parts (hi + mid + lo == c exactly, the wrapper's
// split) whose three products go into one f32 accumulator. The row
// squared norms stay the fmaf chain above, so they keep their bits; the
// similarities are within 1e-5 of the f32 mode's on unit rows and equal to
// them on integer-valued rows.
#pragma once

#include "wgmma_tile.cuh"


namespace repro {

constexpr int kTileRows = 128, kTileCols = 128;
constexpr int kTileWarps = 8;   // consumer warps; one more produces
constexpr int kTileStages = 4;
constexpr int kTileTy = kTileRows / 8, kTileTx = kTileCols / 8;
using TileThread = PipeThread<kTileTy, kTileTx>;
// the ring, its barriers, then each row's (best, id) of the 2 warp columns
constexpr int kTileSmem = kPipeAlign + kTileStages * (kPipeStage + 16) + kTileRows * 2 * 8;

inline int assign_tiles(int k) { return (k + kTileCols - 1) / kTileCols; }

// A block's consumer work for a center tile of width > 8 * (JN / 2) (JN
// column groups of 16).
template <bool ROWSQ, int JN>
__device__ __forceinline__ void tile_consume(const PipeRing& ring, int nk, bool rowsq_here,
                                             int row0, int col0, int n, int k, int tiles,
                                             int ct, float* xv, int* xi,
                                             int* __restrict__ idx,
                                             float* __restrict__ best_sim,
                                             float* __restrict__ rowsq,
                                             float* __restrict__ part_v,
                                             int* __restrict__ part_i) {
  const int t = threadIdx.x, lane = t & 31;
  const TileThread th(t);
  float acc[8][JN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
  float rsq = 0.f, unused = 0.f;
  for (int i = 0; i < nk; ++i) {
    pipe_wait(ring, i);
    const float* a = ring.block(i, 0);
    if (ROWSQ && rowsq_here && t < kTileRows) pipe_row<false>(a, nullptr, t, rsq, unused);
    pipe_fma<kTileTy, kTileTx, JN>(a, ring.block(i, 1), th.ty, th.tx, acc);
    pipe_release(ring, i, lane);
  }
  // each row's tile winner: a thread's columns ascend with j, then the 8
  // lanes of the row in this warp, then the 2 warp columns through shared
  // memory
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float tb = kNeg;
    int tj = -1;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int col = col0 + th.tx + kTileTx * j;
      if (col < k && beats(acc[i][j], col, tb, tj)) {
        tb = acc[i][j];
        tj = col;
      }
    }
    lanes_argmax<1, 8>(tb, tj);
    if ((lane & 7) == 0) {
      const int r = th.ty + kTileTy * i;
      xv[r * 2 + th.wc] = tb;
      xi[r * 2 + th.wc] = tj;
    }
  }
  consumers_sync(kTileWarps * 32);
  if (t < kTileRows && row0 + t < n) {
    float bv = xv[t * 2];
    int bj = xi[t * 2];
    if (beats(xv[t * 2 + 1], xi[t * 2 + 1], bv, bj)) {
      bv = xv[t * 2 + 1];
      bj = xi[t * 2 + 1];
    }
    const int row = row0 + t;
    if (tiles == 1) {
      idx[row] = bj;
      best_sim[row] = bv;
    } else {
      part_v[(size_t)ct * n + row] = bv;
      part_i[(size_t)ct * n + row] = bj;
    }
    if (ROWSQ && rowsq_here) rowsq[row] = rsq;
  }
}

template <bool ROWSQ>
__global__ void __launch_bounds__((kTileWarps + 1) * 32, 1)
    assign_tile(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap cmap, int xtma, int ctma,
                const float* __restrict__ x, const float* __restrict__ centers, int n,
                int k, int d, int tiles, int* __restrict__ idx,
                float* __restrict__ best_sim, float* __restrict__ rowsq,
                float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ unsigned char raw[];
  PipeRing ring;
  float* xv = reinterpret_cast<float*>(pipe_ring(raw, kTileStages, ring));
  int* xi = reinterpret_cast<int*>(xv + kTileRows * 2);
  const int ct = blockIdx.x % tiles, row0 = (blockIdx.x / tiles) * kTileRows;
  const int col0 = ct * kTileCols;
  const int nk = (d + kPipeK - 1) / kPipeK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) pipe_ring_init(ring, kTileWarps);
  __syncthreads();

  if (warp == kTileWarps) {  // producer
    const uint32_t tx = (xtma ? kPipeBlock : 0) + (ctma ? kPipeBlock : 0);
    for (int i = 0; i < nk; ++i) {
      pipe_acquire(ring, i, tx, lane);
      pipe_load(ring.block(i, 0), xtma ? &xmap : nullptr, x, n, d, row0, i * kPipeK,
                kTileRows, ring.full_of(i), lane);
      pipe_load(ring.block(i, 1), ctma ? &cmap : nullptr, centers, k, d, col0, i * kPipeK,
                kTileCols, ring.full_of(i), lane);
      pipe_commit(ring, i);
    }
    pipe_drain(ring, nk);
    return;
  }
  const bool rowsq_here = ct == 0;
  const int jn = pipe_jn<kTileTx>(min(kTileCols, k - col0));
#define REPRO_TILE_CONSUME(JN)                                                          \
  tile_consume<ROWSQ, JN>(ring, nk, rowsq_here, row0, col0, n, k, tiles, ct, xv, xi, idx, \
                          best_sim, rowsq, part_v, part_i)
  if (jn == 8)
    REPRO_TILE_CONSUME(8);
  else if (jn == 4)
    REPRO_TILE_CONSUME(4);
  else if (jn == 2)
    REPRO_TILE_CONSUME(2);
  else
    REPRO_TILE_CONSUME(1);
#undef REPRO_TILE_CONSUME
}

// Tile winners -> each row's winner, in tile order, strict '>'.
__global__ void assign_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
                             int n, int tiles, int* __restrict__ idx,
                             float* __restrict__ best_sim) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float bv = part_v[row];
  int bj = part_i[row];
  for (int c = 1; c < tiles; ++c) {
    const float v = part_v[(size_t)c * n + row];
    if (v > bv) {
      bv = v;
      bj = part_i[(size_t)c * n + row];
    }
  }
  idx[row] = bj;
  best_sim[row] = bv;
}

// Floats of scratch a row the launch needs (the tiles' winners), 0 for one
// center tile.
inline int assign_tile_scratch(int k) {
  const int tiles = assign_tiles(k);
  return tiles > 1 ? 2 * tiles : 0;
}

// per library, per kernel [ROWSQ]: devices whose limit is raised
static unsigned tile_smem_set[2] = {};

// Set up the tile winners' scratch and the grid; false when the grid is too
// large.
inline bool assign_grid(int n, int k, float* scratch, int& tiles, float*& part_v,
                        int*& part_i, unsigned& blocks) {
  tiles = assign_tiles(k);
  part_v = scratch;
  part_i = tiles > 1 ? reinterpret_cast<int*>(scratch + (size_t)tiles * n) : nullptr;
  const long long b = (long long)((n + kTileRows - 1) / kTileRows) * tiles;
  blocks = (unsigned)b;
  return b <= 0x7fffffffLL;
}

// After the tile launch: merge the center tiles' winners (more than one
// tile).
inline int assign_finish(const float* part_v, const int* part_i, int n, int tiles, int* idx,
                         float* best_sim, cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || tiles == 1) return (int)e;
  assign_merge<<<(n + 255) / 256, 256, 0, st>>>(part_v, part_i, n, tiles, idx, best_sim);
  return (int)cudaGetLastError();
}

// Launch on `st`; n == 0 launches nothing. scratch: n * assign_tile_scratch(k)
// floats (may be null when that is 0).
template <bool ROWSQ>
inline int launch_assign_tile(const float* x, const float* centers, int n, int k, int d,
                              int* idx, float* best_sim, float* rowsq, float* scratch,
                              cudaStream_t st) {
  if (n == 0) return 0;
  int err = allow_smem(assign_tile<ROWSQ>, kTileSmem, tile_smem_set[ROWSQ]);
  if (err != 0) return err;
  CUtensorMap xmap{}, cmap{};
  const bool xtma = pipe_map(&xmap, x, n, d, kTileRows, &err);
  if (err != 0) return err;
  const bool ctma = pipe_map(&cmap, centers, k, d, kTileCols, &err);
  if (err != 0) return err;
  int tiles, *part_i;
  float* part_v;
  unsigned blocks;
  if (!assign_grid(n, k, scratch, tiles, part_v, part_i, blocks))
    return (int)cudaErrorInvalidConfiguration;
  assign_tile<ROWSQ><<<blocks, (kTileWarps + 1) * 32, kTileSmem, st>>>(
      xmap, cmap, xtma, ctma, x, centers, n, k, d, tiles, idx, best_sim, rowsq, part_v,
      part_i);
  return assign_finish(part_v, part_i, n, tiles, idx, best_sim, st);
}

// ------------------------------------------------- bf16 x: tensor cores

// The center columns a bf16 tile computes for k centers: 16, 32 or 64 (one
// tile), else 128 (tiles of 128 side by side).
inline int wg_tile_n(int k) { return k > 64 ? 128 : k > 32 ? 64 : k > 16 ? 32 : 16; }

// the ring (the x block and P B blocks of N rows a stage, up to 200 KB)
template <int P, int N>
using TileWgRing = WgRing<P, N>;
template <int P, int N>
constexpr int kTileWgStages = 200 * 1024 / TileWgRing<P, N>::kStage;
template <int P, int N>
constexpr int kTileWgSmem = wg_ring_bytes<TileWgRing<P, N>>(kTileWgStages<P, N>);

// The consumers of a bf16 tile with N computed center columns against P B
// blocks (1: bf16 centers; 3: the parts of f32 ones). Columns past k hold
// products with whatever rows the boxes brought (zeros past the matrix, the
// next part's rows inside it) and are never read. With ROWSQ, in the
// blocks of center tile 0, threads 0-63 of warpgroup g sum the squared
// norms of rows 64g .. 64g + 63 as they pass (wg_row_sq: the fmaf chain of
// assign_pipe.cuh's pipe_row).
template <bool ROWSQ, int N, int P>
__device__ __forceinline__ void wg_assign_consume(const TileWgRing<P, N>& ring, int nk,
                                                  bool rowsq_here, int row0, int col0, int n,
                                                  int k, int tiles, int ct,
                                                  int* __restrict__ idx,
                                                  float* __restrict__ best_sim,
                                                  float* __restrict__ rowsq,
                                                  float* __restrict__ part_v,
                                                  int* __restrict__ part_i) {
  const int t = threadIdx.x, lane = t & 31;
  const int nrow = (t >> 7) * 64 + (t & 127);
  const bool norms = ROWSQ && rowsq_here && (t & 127) < 64;  // whole warps
  float rsq = 0.f;
  float s[N / 2];
  wg_mainloop<N>(ring, nk, s, [&](const unsigned char* xb) {
    if (norms) wg_row_sq(xb, nrow, rsq);
  });
  // each row's tile winner: a thread's columns, then the 4 lanes of its quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tb = kNeg;
    int tj = -1;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + wg_col(t, j, e);
        if (col < k && beats(s[4 * j + 2 * h + e], col, tb, tj)) {
          tb = s[4 * j + 2 * h + e];
          tj = col;
        }
      }
    lanes_argmax<1, 4>(tb, tj);
    const int row = row0 + wg_row(t, h);
    if ((lane & 3) == 0 && row < n) {
      if (tiles == 1) {
        idx[row] = tj;
        best_sim[row] = tb;
      } else {
        part_v[(size_t)ct * n + row] = tb;
        part_i[(size_t)ct * n + row] = tj;
      }
    }
  }
  if (norms && row0 + nrow < n) rowsq[row0 + nrow] = rsq;
}

// bf16 x against P = 1 bf16 center matrix (cmap, or ctma == 0: plain
// stores) or P = 3 parts (cmap: the (3k, split_stride(d)) rows of the
// parts, always the copy engine), in boxes of N center rows: part p of
// center tile ct is rows p * k + 128 ct .. of the parts.
template <bool ROWSQ, int P, int N>
__global__ void __launch_bounds__((kTileWarps + 1) * 32, 1)
    assign_tile_wg(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap cmap, int xtma, int ctma,
                   const bf16* __restrict__ x, const bf16* __restrict__ centers, int n, int k,
                   int d, int tiles, int* __restrict__ idx, float* __restrict__ best_sim,
                   float* __restrict__ rowsq, float* __restrict__ part_v,
                   int* __restrict__ part_i) {
  extern __shared__ unsigned char raw[];
  TileWgRing<P, N> ring;
  wg_ring(raw, kTileWgStages<P, N>, ring);
  const int ct = blockIdx.x % tiles, row0 = (blockIdx.x / tiles) * kTileRows;
  const int col0 = ct * kTileCols;
  const int nk = (d + kWgCols - 1) / kWgCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) pipe_ring_init(ring, kTileWarps);
  __syncthreads();

  if (warp == kTileWarps) {  // producer
    const uint32_t tx = (xtma ? kWgBlock : 0) + (ctma ? P * TileWgRing<P, N>::kB : 0);
    const bool stored = !xtma || !ctma;
    for (int i = 0; i < nk; ++i) {
      pipe_acquire(ring, i, tx, lane);
      wg_load(ring.blk(i, 0), xtma ? &xmap : nullptr, x, n, d, row0, i * kWgCols, kTileRows,
              ring.full_of(i), lane);
      if (P == 1) {
        wg_load(ring.blk(i, 1), ctma ? &cmap : nullptr, centers, k, d, col0, i * kWgCols, N,
                ring.full_of(i), lane);
      } else if (lane == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          tma_load_2d(ring.blk(i, 1 + p), &cmap, i * kWgCols, p * k + col0, ring.full_of(i));
      }
      wg_publish(ring, i, stored);
    }
    pipe_drain(ring, nk);
    return;
  }
  wg_assign_consume<ROWSQ, N, P>(ring, nk, ct == 0, row0, col0, n, k, tiles, ct, idx, best_sim,
                                 rowsq, part_v, part_i);
}

// per library, per kernel [ROWSQ][P == 3][N: 16, 32, 64, 128]: devices
// whose limit is raised
static unsigned tile_wg_smem_set[2][2][4] = {};

template <bool ROWSQ, int P, int N>
inline int launch_wg(const bf16* x, const bf16* centers, int n, int k, int d, int* idx,
                     float* best_sim, float* rowsq, float* scratch, cudaStream_t st) {
  constexpr int smem = kTileWgSmem<P, N>;
  int err = allow_smem(assign_tile_wg<ROWSQ, P, N>, smem,
                       tile_wg_smem_set[ROWSQ][P == 3][N == 16 ? 0 : N == 32 ? 1 : N == 64 ? 2 : 3]);
  if (err != 0) return err;
  CUtensorMap xmap{}, cmap{};
  const bool xtma = wg_map(&xmap, x, n, d, kTileRows, &err);
  if (err != 0) return err;
  bool ctma = wg_map(&cmap, centers, P * k, P == 1 ? d : split_stride(d), N, &err);
  if (err != 0) return err;
  if (P == 3 && !ctma) return (int)cudaErrorInvalidValue;
  int tiles, *part_i;
  float* part_v;
  unsigned blocks;
  if (!assign_grid(n, k, scratch, tiles, part_v, part_i, blocks))
    return (int)cudaErrorInvalidConfiguration;
  assign_tile_wg<ROWSQ, P, N><<<blocks, (kTileWarps + 1) * 32, smem, st>>>(
      xmap, cmap, xtma, ctma, x, centers, n, k, d, tiles, idx, best_sim, rowsq, part_v, part_i);
  return assign_finish(part_v, part_i, n, tiles, idx, best_sim, st);
}

// The bf16 launch 1: P = 1, `centers` a (k, d) bf16 matrix; P = 3, the
// (3, k, split_stride(d)) bf16 parts of f32 centers (16-byte aligned).
// Otherwise as launch_assign_tile.
template <bool ROWSQ, int P>
inline int launch_assign_tile_wg(const bf16* x, const bf16* centers, int n, int k, int d,
                                 int* idx, float* best_sim, float* rowsq, float* scratch,
                                 cudaStream_t st) {
  if (n == 0) return 0;
  switch (wg_tile_n(k)) {
    case 16:
      return launch_wg<ROWSQ, P, 16>(x, centers, n, k, d, idx, best_sim, rowsq, scratch, st);
    case 32:
      return launch_wg<ROWSQ, P, 32>(x, centers, n, k, d, idx, best_sim, rowsq, scratch, st);
    case 64:
      return launch_wg<ROWSQ, P, 64>(x, centers, n, k, d, idx, best_sim, rowsq, scratch, st);
    default:
      return launch_wg<ROWSQ, P, 128>(x, centers, n, k, d, idx, best_sim, rowsq, scratch, st);
  }
}

}  // namespace repro
