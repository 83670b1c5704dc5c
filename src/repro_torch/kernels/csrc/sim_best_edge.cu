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
// match the plain fp32 product) is the ceiling. The self-search needs only
// half the products: sim(i, j) and sim(j, i) have the same bits.
//
// What the design does about it: the pipelined product tile of
// assign_pipe.cuh. A block is a 128 x 128 tile (row tile I, column tile J):
// a producer warp feeds both row blocks through a four-stage ring (TMA boxes
// with the 128-byte swizzle, 4-byte asynchronous copies where d % 4 != 0 or
// d < 32), 8 consumer warps hold 8 x 8 results a thread and read shared
// memory 16 bytes at a time. Each block writes, for every row of I, its best
// column of J (value desc, column asc) into partial slot J of that row; a
// second launch folds each row's partials in ascending slot order with a
// strict '>', which keeps the (max, then lowest column) rule. No atomics: two
// runs give identical bits.
//
// The self-search (xs_rows and xs_all the same storage, and the two label
// vectors too: the resident Borůvka round) runs only the tiles with J >= I.
// Block (I, J) also reduces its tile over the rows of I for every row j of J
// (the same (value desc, index asc) rule, over i in I), which is what block
// (J, I) would have computed, since fmaf(a, b, c) == fmaf(b, a, c) gives
// sim(j, i) the bits of sim(i, j); it writes that into partial slot I of row
// j. Every partial slot then holds what the full grid gave it, and the fold
// returns the full grid's bits. At s = 3,536: 406 tiles instead of 784.

#include "assign_pipe.cuh"

namespace {

using namespace repro;

constexpr int kRows = 128, kCols = 128;  // a tile
constexpr int kWarps = 8;                // consumer warps; one more produces
constexpr int kStages = 4;
constexpr int kTy = kRows / 8, kTx = kCols / 8;
using Thread = PipeThread<kTy, kTx>;
constexpr int kWarpRows = kWarps / Thread::kWarpsX;  // 4 warps down the tile
// the ring and its barriers; each row's (best, column) from the 2 warp
// columns; each column's (best, row) from the 4 warp rows
constexpr int kSmem =
    kPipeAlign + kStages * (kPipeStage + 16) + kRows * 2 * 8 + kCols * kWarpRows * 8;

// Block b of the self-search -> its tile (I, J), J >= I: row tile I holds the
// tiles - I blocks after those of the row tiles before it.
__device__ __forceinline__ void upper_tile(int b, int tiles, int& rt, int& ct) {
  rt = 0;
  while (b >= tiles - rt) {
    b -= tiles - rt;
    ++rt;
  }
  ct = rt + b;
}

// The consumers of tile (rt, ct) with JN column groups of 16 (a narrow last
// column tile computes fewer); with SELF, and off the diagonal, the column
// side too.
template <int JN, bool SELF>
__device__ __forceinline__ void tile_consume(const PipeRing& ring, int nk, int rt, int ct,
                                             const int* __restrict__ lr,
                                             const int* __restrict__ lc, int r, int c,
                                             float* xv, int* xi, float* cv, int* ci,
                                             float* __restrict__ part_s,
                                             int* __restrict__ part_j) {
  const int t = threadIdx.x, lane = t & 31, wr = (t >> 5) / Thread::kWarpsX;
  const Thread th(t);
  const int row0 = rt * kRows, col0 = ct * kCols;
  float acc[8][JN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < nk; ++i) {
    pipe_wait(ring, i);
    pipe_fma<kTy, kTx, JN>(ring.block(i, 0), ring.block(i, 1), th.ty, th.tx, acc);
    pipe_release(ring, i, lane);
  }

  int lrow[8], lcol[JN];  // -1 past the matrix: pads match nothing
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + th.ty + kTy * i;
    lrow[i] = row < r ? lr[row] : -1;
  }
#pragma unroll
  for (int j = 0; j < JN; ++j) {
    const int col = col0 + th.tx + kTx * j;
    lcol[j] = col < c ? lc[col] : -1;
  }
  // each row's best column: a thread's columns ascend with j, then the 8
  // lanes of the row in this warp, then the 2 warp columns in shared memory
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float tb = kNeg;
    int tj = -1;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int col = col0 + th.tx + kTx * j;
      const bool keep = lrow[i] >= 0 && lcol[j] >= 0 && lrow[i] != lcol[j];
      if (keep && beats(acc[i][j], col, tb, tj)) {
        tb = acc[i][j];
        tj = col;
      }
    }
    lanes_argmax<1, 8>(tb, tj);
    if ((lane & 7) == 0) {
      const int rr = th.ty + kTy * i;
      xv[rr * 2 + th.wc] = tb;
      xi[rr * 2 + th.wc] = tj;
    }
  }
  const bool cols_too = SELF && ct != rt;
  if (cols_too) {
    // each column's best row: a thread's rows ascend with i, then the 4
    // lanes of the column in this warp, then the 4 warp rows in shared memory
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      float tb = kNeg;
      int ti = -1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = row0 + th.ty + kTy * i;
        const bool keep = lrow[i] >= 0 && lcol[j] >= 0 && lrow[i] != lcol[j];
        if (keep && beats(acc[i][j], row, tb, ti)) {
          tb = acc[i][j];
          ti = row;
        }
      }
      lanes_argmax<8, 4>(tb, ti);
      if (lane < 8) {
        const int cc = th.tx + kTx * j;
        cv[cc * kWarpRows + wr] = tb;
        ci[cc * kWarpRows + wr] = ti;
      }
    }
  }
  consumers_sync(kWarps * 32);
  if (t < kRows && row0 + t < r) {
    float bv = xv[t * 2];
    int bj = xi[t * 2];
    if (beats(xv[t * 2 + 1], xi[t * 2 + 1], bv, bj)) {
      bv = xv[t * 2 + 1];
      bj = xi[t * 2 + 1];
    }
    part_s[(size_t)ct * r + row0 + t] = bv;
    part_j[(size_t)ct * r + row0 + t] = bj;
  }
  // columns past c were never written (a tile is at most 16 * JN wide)
  if (cols_too && t < kCols && col0 + t < c) {
    float bv = cv[t * kWarpRows];
    int bi = ci[t * kWarpRows];
#pragma unroll
    for (int w = 1; w < kWarpRows; ++w) {
      if (beats(cv[t * kWarpRows + w], ci[t * kWarpRows + w], bv, bi)) {
        bv = cv[t * kWarpRows + w];
        bi = ci[t * kWarpRows + w];
      }
    }
    part_s[(size_t)rt * r + col0 + t] = bv;  // row col0 + t, slot rt
    part_j[(size_t)rt * r + col0 + t] = bi;
  }
}

template <bool SELF>
__global__ void __launch_bounds__((kWarps + 1) * 32, 1)
    sim_best_edge_tile(const __grid_constant__ CUtensorMap rmap,
                       const __grid_constant__ CUtensorMap cmap, int rtma, int ctma,
                       const float* __restrict__ xr, const float* __restrict__ xc,
                       const int* __restrict__ lr, const int* __restrict__ lc, int r, int c,
                       int d, int tiles, float* __restrict__ part_s,
                       int* __restrict__ part_j) {
  extern __shared__ unsigned char raw[];
  PipeRing ring;
  float* xv = reinterpret_cast<float*>(pipe_ring(raw, kStages, ring));
  int* xi = reinterpret_cast<int*>(xv + kRows * 2);
  float* cv = reinterpret_cast<float*>(xi + kRows * 2);
  int* ci = reinterpret_cast<int*>(cv + kCols * kWarpRows);
  int rt, ct;
  if (SELF) {
    upper_tile(blockIdx.x, tiles, rt, ct);
  } else {
    ct = blockIdx.x % tiles;
    rt = blockIdx.x / tiles;
  }
  const int nk = (d + kPipeK - 1) / kPipeK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) pipe_ring_init(ring, kWarps);
  __syncthreads();

  if (warp == kWarps) {  // producer
    const uint32_t tx = (rtma ? kPipeBlock : 0) + (ctma ? kPipeBlock : 0);
    for (int i = 0; i < nk; ++i) {
      pipe_acquire(ring, i, tx, lane);
      pipe_load(ring.block(i, 0), rtma ? &rmap : nullptr, xr, r, d, rt * kRows, i * kPipeK,
                kRows, ring.full_of(i), lane);
      pipe_load(ring.block(i, 1), ctma ? &cmap : nullptr, xc, c, d, ct * kCols, i * kPipeK,
                kCols, ring.full_of(i), lane);
      pipe_commit(ring, i);
    }
    pipe_drain(ring, nk);
    return;
  }
  const int jn = pipe_jn<kTx>(min(kCols, c - ct * kCols));
#define REPRO_SIM_CONSUME(JN) \
  tile_consume<JN, SELF>(ring, nk, rt, ct, lr, lc, r, c, xv, xi, cv, ci, part_s, part_j)
  if (jn == 8)
    REPRO_SIM_CONSUME(8);
  else if (jn == 4)
    REPRO_SIM_CONSUME(4);
  else if (jn == 2)
    REPRO_SIM_CONSUME(2);
  else
    REPRO_SIM_CONSUME(1);
#undef REPRO_SIM_CONSUME
}

__global__ void sim_best_edge_merge(const float* __restrict__ part_s,
                                    const int* __restrict__ part_j, int r, int tiles,
                                    int* __restrict__ best_j, float* __restrict__ best_s) {
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

unsigned smem_set[2] = {0, 0};  // per kernel: devices whose limit is raised

template <bool SELF>
int launch_tiles(const float* xr, const float* xc, const int* lr, const int* lc, int r, int c,
                 int d, int tiles, float* part_s, int* part_j, cudaStream_t st) {
  int err = allow_smem(sim_best_edge_tile<SELF>, kSmem, smem_set[SELF]);
  if (err != 0) return err;
  CUtensorMap rmap{}, cmap{};
  const bool rtma = pipe_map(&rmap, xr, r, d, kRows, &err);
  if (err != 0) return err;
  const bool ctma = SELF ? rtma : pipe_map(&cmap, xc, c, d, kCols, &err);
  if (err != 0) return err;
  if (SELF) cmap = rmap;
  const long long blocks = SELF ? (long long)tiles * (tiles + 1) / 2
                                : (long long)tiles * ((r + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  sim_best_edge_tile<SELF><<<(unsigned)blocks, (kWarps + 1) * 32, kSmem, st>>>(
      rmap, cmap, rtma, ctma, xr, xc, lr, lc, r, c, d, tiles, part_s, part_j);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sim_best_edge_col_tile() { return kCols; }

// Scratch: part_s, part_j hold ceil(c / 128) * r entries each. The inputs
// are contiguous (the wrapper checks), so the same pointers and sizes mean
// the same storage: that call is the self-search.
extern "C" int sim_best_edge(const float* xr, const float* xc, const int* lr, const int* lc,
                             int r, int c, int d, float* part_s, int* part_j, int* best_j,
                             float* best_s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r == 0) return (int)cudaGetLastError();
  const int tiles = (c + kCols - 1) / kCols;
  if (tiles > 0) {
    const bool self = xr == xc && lr == lc && r == c;
    const int err = self ? launch_tiles<true>(xr, xc, lr, lc, r, c, d, tiles, part_s, part_j, st)
                         : launch_tiles<false>(xr, xc, lr, lc, r, c, d, tiles, part_s, part_j, st);
    if (err != 0) return err;
  }
  sim_best_edge_merge<<<(r + 255) / 256, 256, 0, st>>>(part_s, part_j, r, tiles, best_j, best_s);
  return (int)cudaGetLastError();
}
