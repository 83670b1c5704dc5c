// assign_argmax: nearest center per row, without statistics.
//
// Replaces the TPU kernel src/repro/kernels/assign_argmax.py
// (assign_argmax_pallas, body _kernel). Contract: idx is the argmax over
// centers of x . c (ties -> lowest index), best_sim its value. It carries
// the two-pass (fused=False) paths of K-Means, the micro-clusters and BKC,
// and the center index's mini-Lloyd rounds (ops.build_center_index).
//
// What bounds it on an H100: arithmetic. At the main path's n = 250,000,
// d = 2,048, k = 400 the work is 2*n*k*d = 410 GFLOP of fp32 FMA (6.1 ms at
// 67 TFLOP/s, no TF32: the result must match the plain fp32 product) on
// 2.05 GB of x (0.61 ms at 3.35 TB/s).
//
// What the design does about it: the pipelined tile of assign_tile.cuh,
// shared with assign_stats' launch 1: a grid over (128 rows, 128 centers)
// whose center tiles of one row tile run side by side, so x (2.05 GB) comes
// from device memory about once and from L2 for the other tiles; x and the
// center tile reach shared memory through a four-stage ring fed by the copy
// engine from a producer warp, while 8 consumer warps hold 8 x 8 results a
// thread and read shared memory 16 bytes at a time. A second launch merges
// the center tiles' winners in tile order. Each similarity is one fmaf chain
// over d in order, so idx and best_sim have the same bits as assign_stats'
// on the same inputs. The TPU kernel held every center tile in VMEM; here
// the centers (k * d * 4 = 3.3 MB at k = 400) stay in the 50 MB L2.
//
// bf16 x (the TPU kernel's bf16 mode, assign_argmax.py:46-51: bf16
// operands, f32 sums) runs the tensor-core kernel argmax_wg below, bf16
// centers as they are or f32 centers as the three bf16 parts of the
// wrapper's split. At k = 400 the work is 410 GFLOP of bf16 products
// (0.41 ms at 989 TFLOP/s; three products a column for f32 centers,
// 1.24 ms) on 1.02 GB of x (0.31 ms at 3.35 TB/s): the tensor cores bound
// it. This mode ran assign_stats' bf16 tile (assign_tile.cuh's
// launch_assign_tile_wg) at 32-53 % of that bound. Throwaway builds timed
// on an H100 (PERF.md, row 6b) showed what paced it: not the L2 reads of
// the boxes (with no loads after the ring's first fill it still ran at
// 46-49 % with bf16 centers) but the products themselves, a fresh
// accumulator every 64 columns of d (the contract's sum order), and a last
// center tile of k = 400 or 800 that computed 128 columns for its 16 or 32
// centers (0.30-0.39 ms of a call). So argmax_wg computes the last center
// tile at the narrowest width in {16, 32, 64, 128} that holds its centers,
// in the same launch beside the row tile's other tiles, each block in a
// ring of stages as wide as its tiles (7 stages for a last tile of 16
// columns of f32 centers' parts, 3 for one of 128); with bf16 centers and
// a last tile 16 or 32 wide, in the block of the tile before it (128 + 16
// or 32 columns a stage, x read once for both). A block of f32 centers'
// parts has three consumer warpgroups (192 rows of x, three warpgroups'
// products in flight), one of bf16 centers two. Built, timed and not
// kept, being slower or no faster: clusters of two row tiles or two center
// tiles sharing each box by multicast (the blocks of a cluster wait for
// one another at every stage, and L2 does not set the pace), a persistent
// grid, a warpgroup that issues stage i + 1's products before it adds
// stage i's, the two warpgroups taking turns on the tensor cores, and
// folding the last tile of f32 centers' three parts. The
// wrapper's tile_plan (kernels/assign_argmax.py) gives the tiles, the
// folding and the grid, and this entry checks them against its own.
//
// The bits do not move: every product goes through wg_stage in its part
// and k16 order, a stage's products of a column go into a fresh
// accumulator and are added into its f32 sum in stage order (wg_sweep's
// order), and a similarity has the same bits at every computed width and
// column (tests/test_torch_gpu.py's width probe). Ties go to the lowest
// index within a tile (beats) and across tiles (assign_merge's strict
// '>'). So idx and best_sim have the bits of assign_stats' bf16 pass on
// the same inputs.

#include <algorithm>

#include "assign_tile.cuh"

namespace repro {

// -------------------------------------------------------- bf16 x: argmax_wg

// Consumer warpgroups a block, each 64 rows of x: three with f32 centers'
// three parts (a stage's B is 3/4 of its bytes, read once for 192 rows,
// and three warpgroups' products in flight ran 5-10 % faster than two),
// two with bf16 centers (where folding the last tile, which needs two
// warpgroups' registers, ran faster); PERF.md, row 6b.
template <int P>
constexpr int kArgmaxRows = P == 3 ? 192 : 128;  // rows of x a block
template <int P>
constexpr int kArgmaxWarps = kArgmaxRows<P> / 16;  // consumer warps; one more produces

template <int P, int BR>
struct ArgmaxRing : PipeRing {
  static constexpr int kX = kArgmaxRows<P> * kWgRowBytes;
  static constexpr int kB = BR * kWgRowBytes;
  static constexpr int kStage = kX + P * kB;
  __device__ __forceinline__ unsigned char* blk(int i, int b) const {
    return base + (i % stages) * kStage + (b ? kX + (b - 1) * kB : 0);
  }
  __device__ __forceinline__ unsigned char* xblk(int i) const { return blk(i, 0); }
  __device__ __forceinline__ unsigned char* bblk(int i) const { return blk(i, 1); }
};
// as many stages as a block's 227 KB of shared memory holds
template <int P, int BR>
constexpr int kArgmaxStages = (232448 - kPipeAlign) / (ArgmaxRing<P, BR>::kStage + 16);
template <int P, int BR>
constexpr int kArgmaxSmem = wg_ring_bytes<ArgmaxRing<P, BR>>(kArgmaxStages<P, BR>);

// sum[j] += acc[j], once acc's products have landed.
template <int M>
__device__ __forceinline__ void argmax_add(float (&sum)[M], float (&acc)[M]) {
  wg_fence_acc(acc);
#pragma unroll
  for (int j = 0; j < M; ++j) sum[j] += acc[j];
}

// Each of a warpgroup's rows' winner among its N columns (sum in m64nN's
// fragment order): a thread's columns, then the 4 lanes of its quad.
template <int N>
__device__ __forceinline__ void argmax_write(const float (&s)[N / 2], int row0, int col0, int n,
                                             int k, int tiles, int ct, int* __restrict__ idx,
                                             float* __restrict__ best_sim,
                                             float* __restrict__ part_v,
                                             int* __restrict__ part_i) {
  const int t = threadIdx.x, lane = t & 31;
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
}

// One block's work on W computed center columns from tile ct's first, in
// a ring of its own: x's kArgmaxRows<P> rows and P B blocks of W rows a
// stage, as many stages as fit. W = 128, or NT < 128 (the narrow last
// tile), or 128 + NT (WIDE: the last two tiles, cmap's box of 128 rows then
// tmap's of NT, so the narrow tile reads no x of its own). The producer
// warp fills the ring; the consumers sweep it in wg_sweep's order (a
// stage's products waited for, then added) and write the rows' winners of
// each tile.
template <int P, int W, bool WIDE>
__device__ __forceinline__ void argmax_block(
    unsigned char* raw, const CUtensorMap& xmap, const CUtensorMap& cmap,
    const CUtensorMap& tmap, int xtma, int ctma, const bf16* __restrict__ x,
    const bf16* __restrict__ centers, int n, int k, int d, int tiles, int row0, int ct,
    int* __restrict__ idx, float* __restrict__ best_sim, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  constexpr int kC = W >= 128 ? 128 : 0, kT = W - kC;  // B rows from cmap's, tmap's boxes
  ArgmaxRing<P, W> ring;
  wg_ring(raw, kArgmaxStages<P, W>, ring);
  const int col0 = ct * kTileCols, nk = (d + kWgCols - 1) / kWgCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) pipe_ring_init(ring, kArgmaxWarps<P>);
  __syncthreads();

  if (warp == kArgmaxWarps<P>) {  // producer
    const uint32_t tx = (xtma ? ArgmaxRing<P, W>::kX : 0) + (ctma ? P * W * kWgRowBytes : 0);
    const bool stored = !xtma || !ctma;
    for (int i = 0; i < nk; ++i) {
      pipe_acquire(ring, i, tx, lane);
      wg_load(ring.blk(i, 0), xtma ? &xmap : nullptr, x, n, d, row0, i * kWgCols,
              kArgmaxRows<P>, ring.full_of(i), lane);
      if (P == 1 && !ctma) {
        wg_load(ring.blk(i, 1), nullptr, centers, k, d, col0, i * kWgCols, W, ring.full_of(i),
                lane);
      } else if (lane == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (kC)
            tma_load_2d(ring.blk(i, 1 + p), &cmap, i * kWgCols, p * k + col0, ring.full_of(i));
          if (kT)
            tma_load_2d(ring.blk(i, 1 + p) + kC * kWgRowBytes, &tmap, i * kWgCols,
                        p * k + col0 + kC, ring.full_of(i));
        }
      }
      wg_publish(ring, i, stored);
    }
    pipe_drain(ring, nk);
    return;
  }
  if constexpr (WIDE) {
    constexpr int kB = ArgmaxRing<P, W>::kB;
    const int g = threadIdx.x >> 7;
    float a[64], b[kT / 2], s[64], t[kT / 2];
#pragma unroll
    for (int j = 0; j < 64; ++j) s[j] = 0.f;
#pragma unroll
    for (int j = 0; j < kT / 2; ++j) t[j] = 0.f;
    for (int i = 0; i < nk; ++i) {
      pipe_wait(ring, i);
      const uint64_t rows = wg_desc(ring.xblk(i) + g * 64 * kWgRowBytes);
      wg_stage<128, P>(a, rows, ring.bblk(i), kB);
      wg_stage<kT, P>(b, rows, ring.bblk(i) + 128 * kWgRowBytes, kB);
      wg_wait_all();
      argmax_add(s, a);
      argmax_add(t, b);
      pipe_release(ring, i, lane);
    }
    argmax_write<128>(s, row0, col0, n, k, tiles, ct, idx, best_sim, part_v, part_i);
    argmax_write<kT>(t, row0, col0 + 128, n, k, tiles, ct + 1, idx, best_sim, part_v, part_i);
  } else {
    float s[W / 2];
    int it = 0;
    wg_sweep<W, P>(ring, it, nk, 0, ArgmaxRing<P, W>::kB, s, [](const unsigned char*) {});
    argmax_write<W>(s, row0, col0, n, k, tiles, ct, idx, best_sim, part_v, part_i);
  }
}

// bf16 x against P = 1 bf16 center matrix (cmap, tmap, or ctma == 0: plain
// stores) or P = 3 parts (the (3k, split_stride(d)) rows of the parts,
// always the copy engine): part p of center tile ct is rows p * k + 128 ct
// .. of the parts. The grid runs over (row tile of kArgmaxRows<P>, block of
// the row tile), the blocks of a row tile side by side (x from device
// memory about once, from L2 for the other blocks). Center tiles 0 ..
// tiles - 2 are 128 wide and the last NT wide: with FOLD the block of tile
// tiles - 2 computes both (argmax_block's WIDE), else the last tile has a
// block, and a ring, of its own. cmap's boxes are 128 rows, tmap's NT.
template <int P, int NT, bool FOLD>
__global__ void __launch_bounds__((kArgmaxWarps<P> + 1) * 32, 1)
    argmax_wg(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap cmap,
              const __grid_constant__ CUtensorMap tmap, int xtma, int ctma,
              const bf16* __restrict__ x, const bf16* __restrict__ centers, int n, int k, int d,
              int tiles, int* __restrict__ idx, float* __restrict__ best_sim,
              float* __restrict__ part_v, int* __restrict__ part_i) {
  static_assert(!FOLD || NT < 128, "only a narrow last tile folds");
  extern __shared__ unsigned char raw[];
  const int blocks = tiles - FOLD;  // a row tile's
  const int ct = blockIdx.x % blocks, row0 = (blockIdx.x / blocks) * kArgmaxRows<P>;
#define REPRO_ARGMAX_BLOCK(W, WIDE)                                                          \
  argmax_block<P, W, WIDE>(raw, xmap, cmap, tmap, xtma, ctma, x, centers, n, k, d, tiles, row0, \
                           ct, idx, best_sim, part_v, part_i)
  if (NT < 128 && ct == blocks - 1) {
    if constexpr (FOLD)
      REPRO_ARGMAX_BLOCK(128 + NT, true);
    else if constexpr (NT < 128)
      REPRO_ARGMAX_BLOCK(NT, false);
  } else {
    REPRO_ARGMAX_BLOCK(128, false);
  }
#undef REPRO_ARGMAX_BLOCK
}

// per library, per kernel [P == 3][NT: 16, 32, 64, 128][FOLD]: devices whose
// limit is raised
static unsigned argmax_smem_set[2][4][2] = {};

// Whether the last block of a row tile computes both of its last two
// center tiles: a last tile of 16 or 32 bf16 centers' columns. (With f32
// centers' three parts the wider block ran slower than a block of its own,
// PERF.md, row 6b; at 64 columns its sums no longer fit in the registers.)
constexpr bool argmax_folds(int parts, int tiles, int last) {
  return parts == 1 && tiles > 1 && last <= 32;
}

// The kernel's plan, as the wrapper's tile_plan makes it: center tiles,
// the last one's width, whether it is folded into the block before it,
// and the blocks.
struct ArgmaxPlan {
  int tiles, last, folded;
  long long blocks;
};

inline bool argmax_plan_ok(const ArgmaxPlan& pl, int parts, int n, int k) {
  const int rows = parts == 3 ? kArgmaxRows<3> : kArgmaxRows<1>;
  const int tiles = assign_tiles(k), last = wg_tile_n(k - kTileCols * (tiles - 1));
  const bool folds = argmax_folds(parts, tiles, last);
  return pl.tiles == tiles && pl.last == last && pl.folded == (int)folds &&
         pl.blocks == (long long)((n + rows - 1) / rows) * (tiles - folds);
}

template <int P, int NT, bool FOLD>
inline int launch_argmax(const bf16* x, const bf16* centers, int n, int k, int d,
                         const ArgmaxPlan& pl, int* idx, float* best_sim, float* scratch,
                         cudaStream_t st) {
  constexpr int last = FOLD ? 128 + NT : NT;  // the last block's ring's B rows
  static_assert(kArgmaxStages<P, 128> >= 3 && kArgmaxStages<P, last> >= 3, "rings of 3 stages");
  constexpr int smem = std::max(kArgmaxSmem<P, 128>, kArgmaxSmem<P, last>);
  constexpr int ni = NT == 16 ? 0 : NT == 32 ? 1 : NT == 64 ? 2 : 3;
  int err = allow_smem(argmax_wg<P, NT, FOLD>, smem, argmax_smem_set[P == 3][ni][FOLD]);
  if (err != 0) return err;
  const int rows = P * k, stride = P == 1 ? d : split_stride(d);
  CUtensorMap xmap{}, cmap{}, tmap{};
  const bool xtma = wg_map(&xmap, x, n, d, kArgmaxRows<P>, &err);
  if (err != 0) return err;
  const bool ctma = wg_map(&cmap, centers, rows, stride, 128, &err);
  if (err != 0) return err;
  if (NT < 128 && ctma) {
    wg_map(&tmap, centers, rows, stride, NT, &err);
    if (err != 0) return err;
  }
  int tiles, *part_i;
  float* part_v;
  unsigned unused;
  if ((P == 3 && !ctma) || !argmax_plan_ok(pl, P, n, k) || pl.blocks > 0x7fffffffLL ||
      !assign_grid(n, k, scratch, tiles, part_v, part_i, unused))
    return (int)cudaErrorInvalidValue;
  argmax_wg<P, NT, FOLD><<<(unsigned)pl.blocks, (kArgmaxWarps<P> + 1) * 32, smem, st>>>(
      xmap, cmap, tmap, xtma, ctma, x, centers, n, k, d, tiles, idx, best_sim, part_v, part_i);
  return assign_finish(part_v, part_i, n, tiles, idx, best_sim, st);
}

template <int P, int NT>
inline int launch_argmax_nt(const bf16* x, const bf16* centers, int n, int k, int d,
                            const ArgmaxPlan& pl, int* idx, float* best_sim, float* scratch,
                            cudaStream_t st) {
  if constexpr (argmax_folds(P, 2, NT))
    if (pl.folded)
      return launch_argmax<P, NT, true>(x, centers, n, k, d, pl, idx, best_sim, scratch, st);
  return launch_argmax<P, NT, false>(x, centers, n, k, d, pl, idx, best_sim, scratch, st);
}

template <int P>
inline int launch_argmax_wg(const bf16* x, const bf16* centers, int n, int k, int d,
                            const ArgmaxPlan& pl, int* idx, float* best_sim, float* scratch,
                            cudaStream_t st) {
  if (n == 0) return 0;
  switch (pl.last) {
    case 16:
      return launch_argmax_nt<P, 16>(x, centers, n, k, d, pl, idx, best_sim, scratch, st);
    case 32:
      return launch_argmax_nt<P, 32>(x, centers, n, k, d, pl, idx, best_sim, scratch, st);
    case 64:
      return launch_argmax_nt<P, 64>(x, centers, n, k, d, pl, idx, best_sim, scratch, st);
    case 128:
      return launch_argmax_nt<P, 128>(x, centers, n, k, d, pl, idx, best_sim, scratch, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro

extern "C" int assign_argmax_scratch(int k) { return repro::assign_tile_scratch(k); }

// scratch: n * assign_argmax_scratch(k) floats (null when that is 0).
// xelem, celem (csrc/tma.cuh): both kElemF32, or x kElemBf16 with bf16
// centers (kElemBf16) or the (3, k, split_stride(d)) bf16 parts of f32
// centers (kElemSplit3). tiles, last, folded, blocks: bf16 x's plan
// (kernels/assign_argmax.py tile_plan; checked here), unread for f32 x.
extern "C" int assign_argmax(const void* x, const void* centers, int xelem, int celem, int n,
                             int d, int k, int tiles, int last, int folded, long long blocks,
                             int* idx, float* best_sim, float* scratch, void* stream) {
  using repro::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xelem == repro::kElemF32 && celem == repro::kElemF32)
    return repro::launch_assign_tile<false>(static_cast<const float*>(x),
                                            static_cast<const float*>(centers), n, k, d, idx,
                                            best_sim, nullptr, scratch, st);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* cb = static_cast<const bf16*>(centers);
  const repro::ArgmaxPlan plan{tiles, last, folded, blocks};
  if (xelem == repro::kElemBf16 && celem == repro::kElemSplit3)
    return repro::launch_argmax_wg<3>(xb, cb, n, k, d, plan, idx, best_sim, scratch, st);
  if (xelem == repro::kElemBf16 && celem == repro::kElemBf16)
    return repro::launch_argmax_wg<1>(xb, cb, n, k, d, plan, idx, best_sim, scratch, st);
  return (int)cudaErrorInvalidValue;
}
