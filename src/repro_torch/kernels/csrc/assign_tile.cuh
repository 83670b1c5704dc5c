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
#pragma once

#include "assign_pipe.cuh"

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

static unsigned tile_smem_set[2] = {0, 0};  // per library: devices whose limit is raised

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
  const int tiles = assign_tiles(k);
  float* part_v = scratch;
  int* part_i = tiles > 1 ? reinterpret_cast<int*>(scratch + (size_t)tiles * n) : nullptr;
  const long long blocks = (long long)((n + kTileRows - 1) / kTileRows) * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  assign_tile<ROWSQ><<<(unsigned)blocks, (kTileWarps + 1) * 32, kTileSmem, st>>>(
      xmap, cmap, xtma, ctma, x, centers, n, k, d, tiles, idx, best_sim, rowsq, part_v,
      part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || tiles == 1) return (int)e;
  assign_merge<<<(n + 255) / 256, 256, 0, st>>>(part_v, part_i, n, tiles, idx, best_sim);
  return (int)cudaGetLastError();
}

}  // namespace repro
