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
//
// bf16 rows (both matrices bf16: the sample of a bf16 collection, as the
// JAX kernel takes it) run on the tensor cores instead (wgmma_tile.cuh):
// each warpgroup of a block computes 64 rows of the 128 x 128 tile, products
// of bf16 values exact, sums in f32 in the tensor cores' order, within 1e-5
// of the f32 mode on the upcast rows and equal to it on integer-valued
// rows. The fmaf argument for the symmetry does not carry over, so the
// self-search takes it by construction: on a diagonal tile (I, I) only the
// entries with row < column are read, row i over its columns j > i and, on
// the column side, row j over its rows i < j, the rule of the tiles off the
// diagonal; the two sides merge into slot I with the same (value desc,
// index asc) rule. The full grid reads every entry of its tiles; it equals
// the self-search where the tensor cores' sum for a pair does not depend on
// which operand is the row (held on the card: tests/test_torch_gpu.py's bf16
// gates, the full grid on a copy against the self-search).

#include "wgmma_tile.cuh"

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
// the bf16 tile: its ring (two 16 KB blocks a stage), each row's (best,
// column), each column's (best, row) from the 8 consumer warps, the tile's
// row and column labels
constexpr int kWgStages = 6;
constexpr int kWgSmem =
    wg_ring_bytes<WgRing<1>>(kWgStages) + kRows * 8 + kCols * kWarps * 8 + (kRows + kCols) * 4;

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

// The block's tile: (I, J) of the self-search's upper triangle, or of the
// full grid.
template <bool SELF>
__device__ __forceinline__ void block_tile(int tiles, int& rt, int& ct) {
  if (SELF) {
    upper_tile(blockIdx.x, tiles, rt, ct);
  } else {
    ct = blockIdx.x % tiles;
    rt = blockIdx.x / tiles;
  }
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
  block_tile<SELF>(tiles, rt, ct);
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

// ------------------------------------------------- bf16 rows: tensor cores

// The consumers of the bf16 tile (rt, ct), N computed columns (16, 32, 64 or
// 128: a narrow last column tile computes fewer). Rows and columns past the
// matrices carry label -1 and match nothing.
template <int N, bool SELF>
__device__ __forceinline__ void wg_tile_consume(const WgRing<1>& ring, int nk, int rt, int ct,
                                                int r, int c, const int* lrs, const int* lcs,
                                                float* xv, int* xi, float* cv, int* ci,
                                                float* __restrict__ part_s,
                                                int* __restrict__ part_j) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int row0 = rt * kRows, col0 = ct * kCols;
  const bool diag = SELF && rt == ct;  // there only the entries with row < column
  float s[N / 2];
  wg_mainloop<N>(ring, nk, s, [](const unsigned char*) {});
  consumers_sync(kWarps * 32);  // the staged labels
  // each row's best column: a thread's columns, then the 4 lanes of its quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = wg_row(t, h), lrow = lrs[rr];
    float tb = kNeg;
    int tj = -1;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = wg_col(t, j, e), lcol = lcs[cc];
        const bool keep = lrow >= 0 && lcol >= 0 && lrow != lcol && (!diag || cc > rr);
        if (keep && beats(s[4 * j + 2 * h + e], col0 + cc, tb, tj)) {
          tb = s[4 * j + 2 * h + e];
          tj = col0 + cc;
        }
      }
    lanes_argmax<1, 4>(tb, tj);
    if ((lane & 3) == 0) {
      xv[rr] = tb;
      xi[rr] = tj;
    }
  }
  if (SELF) {
    // each column's best row: a thread's two rows, then the 8 lanes of the
    // column in this warp, then the 8 warps in shared memory
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = wg_col(t, j, e), lcol = lcs[cc];
        float tb = kNeg;
        int ti = -1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = wg_row(t, h), lrow = lrs[rr];
          const bool keep = lrow >= 0 && lcol >= 0 && lrow != lcol && (!diag || rr < cc);
          if (keep && beats(s[4 * j + 2 * h + e], row0 + rr, tb, ti)) {
            tb = s[4 * j + 2 * h + e];
            ti = row0 + rr;
          }
        }
        lanes_argmax<4, 8>(tb, ti);
        if (lane < 4) {
          cv[cc * kWarps + warp] = tb;
          ci[cc * kWarps + warp] = ti;
        }
      }
  }
  consumers_sync(kWarps * 32);
  if (t < kRows && row0 + t < r) {
    float bv = xv[t];
    int bj = xi[t];
    if (diag) {  // row i's partners i' < i, read at (i', i)
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (beats(cv[t * kWarps + w], ci[t * kWarps + w], bv, bj)) {
          bv = cv[t * kWarps + w];
          bj = ci[t * kWarps + w];
        }
      }
    }
    part_s[(size_t)ct * r + row0 + t] = bv;
    part_j[(size_t)ct * r + row0 + t] = bj;
  }
  // columns past c were never written (a tile is at most N wide)
  if (SELF && !diag && t < kCols && col0 + t < c) {
    float bv = cv[t * kWarps];
    int bi = ci[t * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (beats(cv[t * kWarps + w], ci[t * kWarps + w], bv, bi)) {
        bv = cv[t * kWarps + w];
        bi = ci[t * kWarps + w];
      }
    }
    part_s[(size_t)rt * r + col0 + t] = bv;  // row col0 + t, slot rt
    part_j[(size_t)rt * r + col0 + t] = bi;
  }
}

template <bool SELF>
__global__ void __launch_bounds__((kWarps + 1) * 32, 1)
    sim_best_edge_wg(const __grid_constant__ CUtensorMap rmap,
                     const __grid_constant__ CUtensorMap cmap, int rtma, int ctma,
                     const bf16* __restrict__ xr, const bf16* __restrict__ xc,
                     const int* __restrict__ lr, const int* __restrict__ lc, int r, int c,
                     int d, int tiles, float* __restrict__ part_s, int* __restrict__ part_j) {
  extern __shared__ unsigned char raw[];
  WgRing<1> ring;
  float* xv = reinterpret_cast<float*>(wg_ring(raw, kWgStages, ring));
  int* xi = reinterpret_cast<int*>(xv + kRows);
  float* cv = reinterpret_cast<float*>(xi + kRows);
  int* ci = reinterpret_cast<int*>(cv + kCols * kWarps);
  int* lrs = ci + kCols * kWarps;
  int* lcs = lrs + kRows;
  int rt, ct;
  block_tile<SELF>(tiles, rt, ct);
  const int nk = (d + kWgCols - 1) / kWgCols;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) pipe_ring_init(ring, kWarps);
  __syncthreads();

  if (warp == kWarps) {  // producer
    const uint32_t tx = (rtma ? kWgBlock : 0) + (ctma ? kWgBlock : 0);
    const bool stored = !rtma || !ctma;
    for (int i = 0; i < nk; ++i) {
      pipe_acquire(ring, i, tx, lane);
      wg_load(ring.blk(i, 0), rtma ? &rmap : nullptr, xr, r, d, rt * kRows, i * kWgCols, kRows,
              ring.full_of(i), lane);
      wg_load(ring.blk(i, 1), ctma ? &cmap : nullptr, xc, c, d, ct * kCols, i * kWgCols, kCols,
              ring.full_of(i), lane);
      wg_publish(ring, i, stored);
    }
    pipe_drain(ring, nk);
    return;
  }
  if (t < kRows) {
    const int row = rt * kRows + t, col = ct * kCols + t;
    lrs[t] = row < r ? lr[row] : -1;
    lcs[t] = col < c ? lc[col] : -1;
  }
  const int jn = pipe_jn<16>(min(kCols, c - ct * kCols));
#define REPRO_SIM_WG(JN) \
  wg_tile_consume<16 * JN, SELF>(ring, nk, rt, ct, r, c, lrs, lcs, xv, xi, cv, ci, part_s, part_j)
  if (jn == 8)
    REPRO_SIM_WG(8);
  else if (jn == 4)
    REPRO_SIM_WG(4);
  else if (jn == 2)
    REPRO_SIM_WG(2);
  else
    REPRO_SIM_WG(1);
#undef REPRO_SIM_WG
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

unsigned smem_set[2][2] = {};  // per kernel [SELF][bf16]: devices whose limit is raised

// The f32 tile (fmaf chains) or, on bf16 rows, the tensor-core tile.
template <bool SELF, typename T>
int launch_tiles(const T* xr, const T* xc, const int* lr, const int* lc, int r, int c, int d,
                 int tiles, float* part_s, int* part_j, cudaStream_t st) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int smem = kBf16 ? kWgSmem : kSmem;
  int err = kBf16 ? allow_smem(sim_best_edge_wg<SELF>, smem, smem_set[SELF][1])
                  : allow_smem(sim_best_edge_tile<SELF>, smem, smem_set[SELF][0]);
  if (err != 0) return err;
  CUtensorMap rmap{}, cmap{};
  bool rtma, ctma;
  if constexpr (kBf16) {
    rtma = wg_map(&rmap, xr, r, d, kRows, &err);
    if (err == 0) ctma = SELF ? rtma : wg_map(&cmap, xc, c, d, kCols, &err);
  } else {
    rtma = pipe_map(&rmap, xr, r, d, kRows, &err);
    if (err == 0) ctma = SELF ? rtma : pipe_map(&cmap, xc, c, d, kCols, &err);
  }
  if (err != 0) return err;
  if (SELF) cmap = rmap;
  const long long blocks = SELF ? (long long)tiles * (tiles + 1) / 2
                                : (long long)tiles * ((r + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if constexpr (kBf16)
    sim_best_edge_wg<SELF><<<(unsigned)blocks, (kWarps + 1) * 32, smem, st>>>(
        rmap, cmap, rtma, ctma, xr, xc, lr, lc, r, c, d, tiles, part_s, part_j);
  else
    sim_best_edge_tile<SELF><<<(unsigned)blocks, (kWarps + 1) * 32, smem, st>>>(
        rmap, cmap, rtma, ctma, xr, xc, lr, lc, r, c, d, tiles, part_s, part_j);
  return (int)cudaGetLastError();
}

// The self-search or the full grid, on rows of T.
template <typename T>
int launch_grid(const void* xr, const void* xc, const int* lr, const int* lc, int r, int c,
                int d, int tiles, float* part_s, int* part_j, cudaStream_t st) {
  const T* a = static_cast<const T*>(xr);
  const T* b = static_cast<const T*>(xc);
  return xr == xc && lr == lc && r == c
             ? launch_tiles<true>(a, b, lr, lc, r, c, d, tiles, part_s, part_j, st)
             : launch_tiles<false>(a, b, lr, lc, r, c, d, tiles, part_s, part_j, st);
}

}  // namespace

extern "C" int sim_best_edge_col_tile() { return kCols; }

// Scratch: part_s, part_j hold ceil(c / 128) * r entries each. xr and xc
// are both f32 or both bf16 (elem: kElemF32 or kElemBf16). The inputs are
// contiguous (the wrapper checks), so the same pointers and sizes mean the
// same storage: that call is the self-search.
extern "C" int sim_best_edge(const void* xr, const void* xc, int elem, const int* lr,
                             const int* lc, int r, int c, int d, float* part_s, int* part_j,
                             int* best_j, float* best_s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem != kElemF32 && elem != kElemBf16) return (int)cudaErrorInvalidValue;
  if (r == 0) return (int)cudaGetLastError();
  const int tiles = (c + kCols - 1) / kCols;
  if (tiles > 0) {
    const int err =
        elem == kElemBf16
            ? launch_grid<bf16>(xr, xc, lr, lc, r, c, d, tiles, part_s, part_j, st)
            : launch_grid<float>(xr, xc, lr, lc, r, c, d, tiles, part_s, part_j, st);
    if (err != 0) return err;
  }
  sim_best_edge_merge<<<(r + 255) / 256, 256, 0, st>>>(part_s, part_j, r, tiles, best_j, best_s);
  return (int)cudaGetLastError();
}
