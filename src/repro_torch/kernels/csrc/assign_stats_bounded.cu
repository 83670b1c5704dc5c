// assign_stats_bounded: one bound-pruned K-Means pass. assign_stats' outputs
// plus the refreshed Elkan/Hamerly carry.
//
// Replaces the TPU kernel src/repro/kernels/assign_stats.py
// (assign_stats_bounded_pallas, body _bounded_kernel). Contract: the six
// outputs of assign_stats (idx, best_sim, sums, counts, min_sim, sumsq) with
// labels in ORIGINAL center ids and ties to the lowest id, and for each row
// the refreshed upper bound `sec` on its similarity to every center but the
// winner. The wrapper (kernels/assign_stats.py) has already, in plain tensor
// code, deflated the carried bounds by the center drift and marked the rows
// they prove settled (idx0 = their carried center, else -1), permuted the
// centers into slabs of 64 (cp, perm; pad slots perm = -1) and computed each
// slab's cone: its unit mean direction rep and the constants a_pos, a_neg,
// b_max, such that for every member c and any row x with s = x . rep and
// t = sqrt(|x|^2 - s^2):  x . c <= max(a_pos * s, a_neg * s) + b_max * t.
//
// What bounds it on an H100: arithmetic, when nothing is pruned. A full
// sweep at BigK = 800 (n = 250,000, d = 2,048) is 2*n*k*d + 4*n*d = 821 GFLOP
// of fp32 FMA, 12.3 ms at 67 TFLOP/s; x is 2.05 GB, 0.61 ms at 3.35 TB/s.
// Pruned rows and skipped slabs remove their share of the 2*n*k*d.
//
// What the design does about it: launch 1 (bounded_sweep) gives each block
// 128 rows and runs every product on the pipelined tile of assign_pipe.cuh:
// one producer warp feeds a three-stage ring (x's 128 rows and up to 128
// center rows, 32 columns of d a stage, by the copy engine), four consumer
// warps hold 8 x 8 results a thread, and the ring runs on from one sweep of
// d to the next. Where any row of the block is settled, a row pass sweeps
// x once with each settled row's carried center gathered beside it
// (coalesced 16-byte copies): the squared norm and the similarity to the
// carried center, each one fmaf chain over d in order, so that value has
// the bits a full sweep would give. If any row is active the block computes
// s for the slabs (its rows against the slab directions; the squared norms
// ride along when no row pass ran), then walks the slabs in slab order. Per
// slab the block votes (__syncthreads_or, the producer too, so it copies
// only the slabs swept) whether any active row's cone bound reaches its
// running best minus the margin; only then does it sweep the slab's 128 x 64
// product and fold it into each row's (best, lowest original id, second
// value); otherwise the slab's cone bound goes into the row's second value.
// The row state sits in shared memory (one entry a row), so the registers
// hold the 8 x 8 results and their operands. Two blocks share an SM, so one's
// slab boundary (the ring drains while the block votes) overlaps the other's
// sweep. The TPU kernel skipped slabs with @pl.when over the same per-block
// test; its sequential grid carried the row state in VMEM, where here a
// block owns its rows for the whole walk. Launches 2-3 are label_stats' deterministic fold with the extra
// scalars (label_stats.cuh), as in assign_stats.cu; the TPU kernel's
// ACC_BUDGET split existed only for VMEM and is not carried over.
//
// bf16 x (the TPU kernel's bf16 mode: bf16 x by bf16 centers, or by f32
// centers, f32 sums): launch 1 runs on the tensor cores of wgmma_tile.cuh.
// Labels and statistics must equal assign_stats' bf16 pass for any bounds
// state, so every similarity it keeps is the bf16 tile's: the same operands
// (bf16 centers as they are, f32 centers as the three bf16 parts of the
// wrapper's split), the same k16 products a stage through wg_stage into a
// fresh accumulator, the stages summed on the CUDA cores in order. The
// tensor cores give an element the same bits whatever the tile width N and
// wherever the row and column sit in the tile (tests/test_torch_gpu.py's
// width probe), so a slab's product has the bits of assign_stats' tiles.
// Launch 1 is two kernels, with the wrapper's plain deflation between:
//   1a bounded_rows_wg, the row pass (its own C entry), over blocks of 128
//      consecutive rows; only blocks holding a row with a carried center
//      work. Every row's norm (the fmaf chain of wg_row_sq, the bits the
//      fold takes) and each carried row's similarity to its center: the
//      block's carried centers are gathered (16-byte copies of the
//      wrapper's padded centers or parts) into B blocks of 128 rows,
//      warpgroup g multiplies its 64 rows by gathered rows 64g .. 64g + 63,
//      and each row reads its own column, the diagonal. So the deflation
//      reads the norms from here, and x is read once for both.
//   1b bounded_walk_wg, the walk, over the active rows only: the wrapper
//      lists them (ascending, a cumsum and a scatter, the count left on the
//      device) and a block takes 128 listed rows, so the rows a block
//      sweeps are all active, wherever they sit in x; blocks past the count
//      exit. The producer gathers the listed rows of x each stage (16-byte
//      copies into the copy engine's swizzled places; the copy engine has
//      no row gather), or, where a block's listed rows are consecutive rows
//      of x (a full sweep), asks the copy engine for their box. The rows'
//      products with the slab directions (32 a chunk, the three bf16 parts
//      of the f32 directions: s exact to the tensor cores' f32 sum, ~1e-7,
//      far inside the 1e-4 prune margin) carry the norms along; then the
//      block votes once a pair of slabs (j, j + 1) and sweeps both as one
//      128-wide tile with one read of its rows (a 64-wide one for the last
//      slab of a chunk of odd width). Folding exact values of a slab a
//      one-slab vote might have skipped never changes a winner, it only
//      tightens the second value. It overwrites what 1a wrote for its rows.
// A block is 8 consumer warps (a warpgroup per 64 rows; a row's columns
// sit in the 4 lanes of a quad, which also own its state) and one producer
// warp, which keeps up to stages - 2 stages of copies in flight before it
// publishes the oldest (cp.async groups; fenced into the async proxy), the
// gathered rows' ids in its registers.
// What bounds it: a full sweep at BigK = 800 is 819 GFLOP of bf16 products
// (0.83 ms at 989 TFLOP/s; three times that with f32 centers) on 1.02 GB
// of x (0.31 ms), but the walk still reads its rows again for each swept
// pair: 1 + ceil(13 / 2) = 8 reads of x (8.2 GB, 2.4 ms at 3.35 TB/s) when
// nothing is pruned, and the ring drains at each of the 7 votes (one block
// an SM). With carried bounds the row pass reads x once and the walk's
// blocks sweep only the active rows.

#include "label_stats.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace repro;

constexpr int BM = 128, BN = 64;  // rows a block; BN centers = one slab
constexpr int kWarps = 4;         // consumer warps; one more produces
constexpr int kStages = 3;
constexpr int kTy = BM / 8, kTx = BN / 8;
constexpr int kConsumers = kWarps * 32;  // = BM: a consumer thread a row in the row pass
using Thread = PipeThread<kTy, kTx>;
static_assert(Thread::kThreads == kConsumers && kConsumers == BM, "one consumer a row");

// s_sh's row pitch: the slabs of one chunk of slab directions, odd so that
// rows fall on different banks.
__host__ __device__ __forceinline__ int slab_pitch(int ns) { return (ns < BN ? ns : BN) | 1; }

// the ring, its barriers, s_sh, then rsq_sh, the row state and idx0_sh
inline int bounded_smem(int ns) {
  return kPipeAlign + kStages * (kPipeStage + 16) + (BM * slab_pitch(ns) + 5 * BM) * 4;
}

// Fold candidate (v, o) into a (best, lowest original id, second) triple;
// the second value masks one instance of the winner only, so an equal value
// under another id counts as the second best.
__device__ __forceinline__ void top2_push(float v, int o, float& b, int& bo, float& s) {
  if (beats(v, o, b, bo)) {
    s = fmaxf(s, b);
    b = v;
    bo = o;
  } else {
    s = fmaxf(s, v);
  }
}

// Merge the triples of the kLanes consecutive lanes of one row (8 in the
// f32 tile, a quad in the bf16 one); every one of them ends with the row's
// slab winner and second value.
template <int kLanes>
__device__ __forceinline__ void row_top2(float& b, int& bo, float& s) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, b, off);
    const int oo = __shfl_xor_sync(0xffffffffu, bo, off);
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
    if (beats(ob, oo, b, bo)) {
      s = fmaxf(fmaxf(s, os), b);
      b = ob;
      bo = oo;
    } else {
      s = fmaxf(fmaxf(s, os), ob);
    }
  }
}

// One chunk of slab directions: s_sh[r][c] = x_r . rep_(c0 + c) for the
// `width` slabs of the chunk; with FUSE also rsq_sh (no row pass ran).
template <int JN>
__device__ __forceinline__ void sweep_reps(const PipeRing& ring, int& it, int nk, bool fuse,
                                           const Thread& th, int width, int pitch,
                                           float* s_sh, float* rsq_sh) {
  const int t = threadIdx.x, lane = t & 31;
  float acc[8][JN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
  float rs = 0.f, unused = 0.f;
  for (int i = 0; i < nk; ++i, ++it) {
    pipe_wait(ring, it);
    const float* a = ring.block(it, 0);
    if (fuse) pipe_row<false>(a, nullptr, t, rs, unused);
    pipe_fma<kTy, kTx, JN>(a, ring.block(it, 1), th.ty, th.tx, acc);
    pipe_release(ring, it, lane);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int c = th.tx + kTx * j;
      if (c < width) s_sh[(th.ty + kTy * i) * pitch + c] = acc[i][j];
    }
  if (fuse) rsq_sh[t] = rs;
}

// Each row's state, in shared memory (one entry a row, read by the row's 8
// lanes, written by the first): its running best, the original id of it
// (lowest on a tie) and its second value. A settled row starts final at its
// carried center; an active row at (NEG, -1).
struct RowState {
  float* best;
  float* sec;
  int* bidx;
};

// One swept slab: its 128 x 64 product, folded into each active row's
// (best, lowest original id, second value).
template <int JN>
__device__ __forceinline__ void sweep_slab(const PipeRing& ring, int& it, int nk,
                                           const Thread& th, const int* __restrict__ perm,
                                           const RowState& rs, const int* idx0_sh, int rows) {
  const int lane = threadIdx.x & 31;
  float acc[8][JN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < nk; ++i, ++it) {
    pipe_wait(ring, it);
    pipe_fma<kTy, kTx, JN>(ring.block(it, 0), ring.block(it, 1), th.ty, th.tx, acc);
    pipe_release(ring, it, lane);
  }
  int orig[JN];
#pragma unroll
  for (int j = 0; j < JN; ++j) orig[j] = perm[th.tx + kTx * j];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = th.ty + kTy * i;
    float b = rs.best[r], sc = rs.sec[r];
    int bi = rs.bidx[r];
    float lb = kNeg, ls = kNeg;
    int lo = -1;
    if (r < rows && idx0_sh[r] < 0) {  // active
#pragma unroll
      for (int j = 0; j < JN; ++j)
        if (orig[j] >= 0) top2_push(acc[i][j], orig[j], lb, lo, ls);
    }
    row_top2<8>(lb, lo, ls);
    if (lb > kNeg) {  // the row had a candidate in this slab
      sc = fmaxf(fmaxf(sc, ls), fminf(b, lb));
      if (lb > b || (lb == b && lo < bi)) {
        b = lb;
        bi = lo;
      }
    }
    __syncwarp();  // the row's lanes have read its state
    if ((lane & 7) == 0) {
      rs.best[r] = b;
      rs.sec[r] = sc;
      rs.bidx[r] = bi;
    }
  }
  __syncwarp();  // the state written is seen by the row's lanes
}

__global__ void __launch_bounds__((kWarps + 1) * 32, 2)
    bounded_sweep(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap rmap,
                  const __grid_constant__ CUtensorMap pmap, int tma, int vec16,
                  const float* __restrict__ x, const float* __restrict__ centers,
                  const float* __restrict__ cp, const int* __restrict__ perm,
                  const float* __restrict__ reps, const float* __restrict__ cone,
                  const int* __restrict__ idx0, int n, int k, int d, int ns,
                  float margin, int* __restrict__ idx, float* __restrict__ best_sim,
                  float* __restrict__ sec_out, float* __restrict__ rowsq) {
  extern __shared__ unsigned char raw[];
  PipeRing ring;
  const int pitch = slab_pitch(ns);
  float* s_sh = reinterpret_cast<float*>(pipe_ring(raw, kStages, ring));
  float* rsq_sh = s_sh + BM * pitch;
  const RowState rs{rsq_sh + BM, rsq_sh + 2 * BM, reinterpret_cast<int*>(rsq_sh + 3 * BM)};
  int* idx0_sh = rs.bidx + BM;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, n - row0);  // the block's real rows
  const int nk = (d + kPipeK - 1) / kPipeK;

  if (t < BM) idx0_sh[t] = t < rows ? idx0[row0 + t] : -1;
  if (t == 0) pipe_ring_init(ring, kWarps);
  __syncthreads();
  const bool any_settled = __syncthreads_or(t < rows && idx0_sh[t] >= 0);
  const bool any_active = __syncthreads_or(t < rows && idx0_sh[t] < 0);

  if (warp == kWarps) {  // producer: the same sweeps, in the same order
    const CUtensorMap* xm = tma ? &xmap : nullptr;
    const uint32_t tx_x = tma ? kPipeBlock : 0, tx_c = tma ? BN * kPipeRowBytes : 0;
    int it = 0;
    if (any_settled) {  // row pass: x and each settled row's carried center
      for (int i = 0; i < nk; ++i, ++it) {
        pipe_acquire(ring, it, tx_x, lane);
        pipe_load(ring.block(it, 0), xm, x, n, d, row0, i * kPipeK, BM, ring.full_of(it), lane);
        pipe_gather(ring.block(it, 1), centers, idx0_sh, d, i * kPipeK, vec16, lane);
        pipe_commit(ring, it);
      }
    }
    if (any_active) {
      for (int c0 = 0; c0 < ns; c0 += BN) {
        for (int i = 0; i < nk; ++i, ++it) {  // the chunk's slab directions
          pipe_acquire(ring, it, tx_x + tx_c, lane);
          pipe_load(ring.block(it, 0), xm, x, n, d, row0, i * kPipeK, BM, ring.full_of(it), lane);
          pipe_load(ring.block(it, 1), tma ? &rmap : nullptr, reps, ns, d, c0, i * kPipeK, BN,
                    ring.full_of(it), lane);
          pipe_commit(ring, it);
        }
        for (int slab = c0; slab < min(ns, c0 + BN); ++slab) {
          if (!__syncthreads_or(0)) continue;  // the consumers' vote
          for (int i = 0; i < nk; ++i, ++it) {
            pipe_acquire(ring, it, tx_x + tx_c, lane);
            pipe_load(ring.block(it, 0), xm, x, n, d, row0, i * kPipeK, BM, ring.full_of(it),
                      lane);
            pipe_load(ring.block(it, 1), tma ? &pmap : nullptr, cp, ns * BN, d, slab * BN,
                      i * kPipeK, BN, ring.full_of(it), lane);
            pipe_commit(ring, it);
          }
        }
      }
    }
    pipe_drain(ring, it);
    return;
  }

  // consumer t owns row t's entries of rsq_sh and the row state
  const Thread th(t);
  int it = 0;
  float rsq = 0.f, sim0 = 0.f;
  if (any_settled) {  // row pass: fmaf chains over d in order
    const bool mine = idx0_sh[t] >= 0;
    for (int i = 0; i < nk; ++i, ++it) {
      pipe_wait(ring, it);
      const float* a = ring.block(it, 0);
      if (mine)
        pipe_row<true>(a, ring.block(it, 1), t, rsq, sim0);
      else
        pipe_row<false>(a, nullptr, t, rsq, sim0);
      pipe_release(ring, it, lane);
    }
    rsq_sh[t] = rsq;
  }
  rs.best[t] = idx0_sh[t] >= 0 ? sim0 : kNeg;
  rs.bidx[t] = idx0_sh[t];
  rs.sec[t] = kNeg;

  if (any_active) {
    for (int c0 = 0; c0 < ns; c0 += BN) {
      const int c1 = min(ns, c0 + BN);
      const bool fuse = !any_settled && c0 == 0;
      switch (pipe_jn<kTx>(c1 - c0)) {
        case 8: sweep_reps<8>(ring, it, nk, fuse, th, c1 - c0, pitch, s_sh, rsq_sh); break;
        case 4: sweep_reps<4>(ring, it, nk, fuse, th, c1 - c0, pitch, s_sh, rsq_sh); break;
        case 2: sweep_reps<2>(ring, it, nk, fuse, th, c1 - c0, pitch, s_sh, rsq_sh); break;
        default: sweep_reps<1>(ring, it, nk, fuse, th, c1 - c0, pitch, s_sh, rsq_sh); break;
      }
      consumers_sync(kConsumers);

      for (int slab = c0; slab < c1; ++slab) {
        const float ap = cone[slab], an = cone[ns + slab], bm = cone[2 * ns + slab];
        float ub[8];
        int need = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = th.ty + kTy * i;
          const float s = s_sh[r * pitch + slab - c0];
          const float tt = sqrtf(fmaxf(rsq_sh[r] - s * s, 0.f));
          ub[i] = fmaxf(ap * s, an * s) + bm * tt;
          need |= r < rows && idx0_sh[r] < 0 && ub[i] >= rs.best[r] - margin;
        }
        if (__syncthreads_or(need)) {
          const int* ps = perm + slab * BN;
          switch (pipe_jn<kTx>(min(BN, k - slab * BN))) {  // pad slots sit past k
            case 8: sweep_slab<8>(ring, it, nk, th, ps, rs, idx0_sh, rows); break;
            case 4: sweep_slab<4>(ring, it, nk, th, ps, rs, idx0_sh, rows); break;
            case 2: sweep_slab<2>(ring, it, nk, th, ps, rs, idx0_sh, rows); break;
            default: sweep_slab<1>(ring, it, nk, th, ps, rs, idx0_sh, rows); break;
          }
        } else if ((lane & 7) == 0) {
          // not searched: the cone bound caps every member of the slab
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = th.ty + kTy * i;
            if (r < rows && idx0_sh[r] < 0) rs.sec[r] = fmaxf(rs.sec[r], ub[i]);
          }
        }
      }
    }
  }

  consumers_sync(kConsumers);
  if (t < rows) {
    idx[row0 + t] = rs.bidx[t];
    best_sim[row0 + t] = rs.best[t];
    sec_out[row0 + t] = rs.sec[t];
    rowsq[row0 + t] = rsq_sh[t];
  }
}

static unsigned sweep_smem_set = 0;  // devices whose limit is raised

// ------------------------------------------------- bf16 x: tensor cores

constexpr int kWgConsumers = 256;  // two warpgroups; one more warp produces
constexpr int kRepChunk = 32;      // slab directions a chunk (N of their product)
constexpr int kPair = 2 * BN;      // the walk's tile: two adjacent slabs

// A stage: x's 128 rows, then P parts of 128 rows (16 KB each): the row
// pass's gathered carried centers, a pair of slabs (two 64-row boxes a
// part), or a chunk's three parts of 32 slab directions (4 KB each).
template <int P>
struct BoundedWgRing : PipeRing {
  static constexpr int kPart = kPipeRows * kWgRowBytes;
  static constexpr int kStage = kWgBlock + P * kPart;
  __device__ __forceinline__ unsigned char* xblk(int i) const {
    return base + (i % stages) * kStage;
  }
  __device__ __forceinline__ unsigned char* bblk(int i) const { return xblk(i) + kWgBlock; }
};
static_assert(3 * kRepChunk * kWgRowBytes <= kPipeRows * kWgRowBytes, "directions fit a part");
template <int P>
constexpr int kBoundedWgStages = P == 1 ? 6 : 3;
// Stages a producer lane keeps in flight before it publishes the oldest:
// at most stages - 1, or the consumers could wait on a stage the producer
// holds while it waits on them for a slot.
template <int P>
constexpr int kBoundedWgLag = kBoundedWgStages<P> - 2;

__host__ __device__ __forceinline__ int rep_pitch(int ns) {
  return (ns < kRepChunk ? ns : kRepChunk) | 1;
}

// the ring and its barriers, then carried_sh
template <int P>
inline int rows_wg_smem() {
  return wg_ring_bytes<BoundedWgRing<P>>(kBoundedWgStages<P>) + BM * 4;
}

// the ring, its barriers, s_sh, then rsq_sh, the row state and ids_sh
template <int P>
inline int walk_wg_smem(int ns) {
  return wg_ring_bytes<BoundedWgRing<P>>(kBoundedWgStages<P>) + (BM * rep_pitch(ns) + 5 * BM) * 4;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Producer lane: stage i of a sweep that began at stage `first` is issued
// (its asynchronous copies, its plain stores). Publish stage i - L, whose
// copies have landed by now, fenced into the async proxy through which
// wgmma reads shared memory; L stages stay in flight.
template <int L>
__device__ __forceinline__ void wg_issued(const PipeRing& ring, int i, int first) {
  cp_async_commit();
  if (i - first >= L) {
    cp_async_wait_group<L>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(ring.full_of(i - L));
  }
}

// Producer lane, at the end of the sweep [first, end): publish the stages
// still held, so the consumers can finish it and vote.
template <int L>
__device__ __forceinline__ void wg_flush(const PipeRing& ring, int first, int end) {
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int i = max(first, end - L); i < end; ++i) mbar_arrive(ring.full_of(i));
}

// Rows ids[0 .. 127] of x, (n, d) bf16, columns [k0, k0 + kWgCols), into a
// staged block: 16-byte asynchronous copies where every row starts on 16
// bytes (vec16: d % 8 == 0 and a 16-byte base), else 2-byte loads and
// stores; zeros for ids < 0 and columns past d. The same swizzled places
// as wg_load's box, so the tile's operands are the same.
__device__ __forceinline__ void gather_x(unsigned char* dst, const bf16* __restrict__ x,
                                         const GatherRows& rows, const int* ids, int d, int k0,
                                         bool vec16, int lane) {
  if (vec16) {
    rows.copy<1>(dst, x, 0, d, d, k0, lane);
    return;
  }
  const unsigned short* bits = reinterpret_cast<const unsigned short*>(x);
  unsigned short* out = reinterpret_cast<unsigned short*>(dst);
#pragma unroll 4
  for (int r = 0; r < kPipeRows; ++r) {
    const int id = ids[r];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * 32 + lane, col = k0 + c;
      out[wg_at(r, c)] = id >= 0 && col < d ? bits[(size_t)id * d + col] : 0;
    }
  }
}

// One swept tile of N slab columns (one slab, or a pair: slab j's 64
// slots, then slab j + 1's), folded into each listed row's (best, lowest
// original id, second value). ps: the tile's original ids, -1 on pads.
template <int N>
__device__ __forceinline__ void fold_tile(const float (&sv)[N / 2], const int* __restrict__ ps,
                                          const RowState& rs, int rows) {
  const int t = threadIdx.x, lane = t & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg_row(t, h);
    float b = rs.best[r], sc = rs.sec[r];
    int bi = rs.bidx[r];
    float lb = kNeg, ls = kNeg;
    int lo = -1;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = ps[wg_col(t, j, e)];
          if (o >= 0) top2_push(sv[4 * j + 2 * h + e], o, lb, lo, ls);
        }
    }
    row_top2<4>(lb, lo, ls);  // a row's N columns sit in a quad
    if (lb > kNeg) {          // the row had a candidate in this tile
      sc = fmaxf(fmaxf(sc, ls), fminf(b, lb));
      if (lb > b || (lb == b && lo < bi)) {
        b = lb;
        bi = lo;
      }
    }
    __syncwarp();  // the row's lanes have read its state
    if ((lane & 3) == 0) {
      rs.best[r] = b;
      rs.sec[r] = sc;
      rs.bidx[r] = bi;
    }
  }
}

// Launch 1a, the row pass: blocks of 128 consecutive rows; a block with no
// carried row (prev in [0, k)) exits at once. x by the copy engine (or
// plain stores), each carried row's center gathered beside it (cg: P
// matrices of (k, stride) bf16, bf16 centers padded to the stride or
// split_bf16x3's parts); warpgroup g multiplies its 64 rows by gathered
// rows 64g .. 64g + 63 and each carried row reads its own column, the
// diagonal. Writes every row's norm (the deflation's, then the fold's) and,
// for a carried row, its center, that similarity and kNeg: final where the
// wrapper then finds the row settled, and overwritten by the walk where
// not. work (null: not kept): block b that ran sets work[b] to 1.
template <int P>
__global__ void __launch_bounds__(kWgConsumers + 32, 1)
    bounded_rows_wg(const __grid_constant__ CUtensorMap xmap, int xtma,
                    const bf16* __restrict__ x, const bf16* __restrict__ cg,
                    const int* __restrict__ prev, int n, int k, int d, int* __restrict__ idx,
                    float* __restrict__ best_sim, float* __restrict__ sec_out,
                    float* __restrict__ rowsq, int* __restrict__ work) {
  constexpr int L = kBoundedWgLag<P>;
  extern __shared__ unsigned char raw[];
  BoundedWgRing<P> ring;
  int* carried_sh = reinterpret_cast<int*>(wg_ring(raw, kBoundedWgStages<P>, ring));
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, n - row0);
  const int nk = (d + kWgCols - 1) / kWgCols;

  if (t < BM) {
    const int p = t < rows ? prev[row0 + t] : -1;
    carried_sh[t] = p >= 0 && p < k ? p : -1;
  }
  if (!__syncthreads_or(t < BM && carried_sh[t] >= 0)) return;  // no row carries a center
  if (t == 0) {
    pipe_ring_init(ring, kWgConsumers / 32);
    if (work != nullptr) work[blockIdx.x] = 1;
  }
  __syncthreads();

  if (warp == kWgConsumers / 32) {  // producer
    const CUtensorMap* xm = xtma ? &xmap : nullptr;
    const int stride = split_stride(d);
    const GatherRows carried(carried_sh, lane);
    for (int i = 0; i < nk; ++i) {
      pipe_acquire(ring, i, xtma ? kWgBlock : 0, lane);
      wg_load(ring.xblk(i), xm, x, n, d, row0, i * kWgCols, BM, ring.full_of(i), lane);
      carried.copy<P>(ring.bblk(i), cg, k, stride, stride, i * kWgCols, lane);
      wg_issued<L>(ring, i, 0);
    }
    wg_flush<L>(ring, 0, nk);
    pipe_drain(ring, nk);
    return;
  }

  // warpgroup g = t / 128 owns tile rows 64g .. 64g + 63; (t & 127) < 64
  // the norm of row nrow
  const int g = t >> 7, nrow = g * 64 + (t & 127);
  const bool norm_thread = (t & 127) < 64;
  int it = 0;
  float rsq = 0.f, sd[32];
  wg_sweep<64, P>(ring, it, nk, g * 64 * kWgRowBytes, BoundedWgRing<P>::kPart, sd,
                  [&](const unsigned char* xb) {
                    if (norm_thread) wg_row_sq(xb, nrow, rsq);
                  });
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = wg_row(t, h);
        if (r - g * 64 == wg_col(t, j, e) && carried_sh[r] >= 0) {
          idx[row0 + r] = carried_sh[r];
          best_sim[row0 + r] = sd[4 * j + 2 * h + e];
          sec_out[row0 + r] = kNeg;
        }
      }
  if (norm_thread && nrow < rows) rowsq[row0 + nrow] = rsq;
}

// Launch 1b, the walk: blocks of 128 rows of the active list (ascending
// original ids, `count` of them on the device; a block past the count
// exits). The producer gathers the listed rows of x every stage (gather_x;
// rows past the count are zeros). First their products with the slab
// directions, 32 a chunk, as the three bf16 parts of the f32 directions,
// the rows' norms riding along in the first chunk; then, per pair of slabs
// (j, j + 1) of the chunk, one vote (__syncthreads_or, the producer too, so
// it copies only the pairs swept): does any row's cone bound in either slab
// reach its running best minus the margin? If so both slabs are swept as
// one 128-wide tile with one read of the rows and folded into each row's
// (best, lowest original id, second value); if not, both cone bounds go
// into the second value. The last pair of a chunk of odd width is one slab
// (a 64-wide tile). Results go back by original row.
// rmap: the slab directions' three parts, (3 * nsr, stride), boxes of 32
// rows; pmap: cpp, P matrices of (ns * 64, stride), boxes of 64 rows.
// work (null: not kept): block b that ran sets work[gridDim.x + b] to 1.
template <int P>
__global__ void __launch_bounds__(kWgConsumers + 32, 1)
    bounded_walk_wg(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap rmap,
                    const __grid_constant__ CUtensorMap pmap, int xtma, int vec16,
                    const bf16* __restrict__ x, const int* __restrict__ list,
                    const long long* __restrict__ count, const int* __restrict__ perm,
                    const float* __restrict__ cone, int d, int ns, float margin,
                    int* __restrict__ idx, float* __restrict__ best_sim,
                    float* __restrict__ sec_out, float* __restrict__ rowsq,
                    int* __restrict__ work) {
  constexpr int L = kBoundedWgLag<P>;
  constexpr int kPart = BoundedWgRing<P>::kPart;
  extern __shared__ unsigned char raw[];
  const long long start = (long long)blockIdx.x * BM, listed = *count;
  if (start >= listed) return;
  const int rows = (int)min((long long)BM, listed - start);
  BoundedWgRing<P> ring;
  const int pitch = rep_pitch(ns);
  float* s_sh = reinterpret_cast<float*>(wg_ring(raw, kBoundedWgStages<P>, ring));
  float* rsq_sh = s_sh + BM * pitch;
  const RowState rs{rsq_sh + BM, rsq_sh + 2 * BM, reinterpret_cast<int*>(rsq_sh + 3 * BM)};
  int* ids_sh = rs.bidx + BM;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int nk = (d + kWgCols - 1) / kWgCols;

  if (t < BM) {
    ids_sh[t] = t < rows ? list[start + t] : -1;
    rs.best[t] = kNeg;
    rs.bidx[t] = -1;
    rs.sec[t] = kNeg;
  }
  if (t == 0) {
    pipe_ring_init(ring, kWgConsumers / 32);
    if (work != nullptr) work[gridDim.x + blockIdx.x] = 1;
  }
  __syncthreads();

  if (warp == kWgConsumers / 32) {  // producer: the same sweeps, in the same order
    const int nsr = (ns + kRepChunk - 1) / kRepChunk * kRepChunk;
    // listed rows that are consecutive rows of x (a full sweep) come as
    // one box from the copy engine
    const bool run = xtma && ids_sh[rows - 1] - ids_sh[0] == rows - 1;
    const uint32_t tx_x = run ? kWgBlock : 0;
    const GatherRows listed(ids_sh, lane);
    auto load_x = [&](int i, int it) {
      if (run)
        wg_load(ring.xblk(it), &xmap, x, 0, d, ids_sh[0], i * kWgCols, BM, ring.full_of(it), lane);
      else
        gather_x(ring.xblk(it), x, listed, ids_sh, d, i * kWgCols, vec16, lane);
    };
    int it = 0;
    for (int c0 = 0; c0 < ns; c0 += kRepChunk) {
      const int c1 = min(ns, c0 + kRepChunk);
      int first = it;
      for (int i = 0; i < nk; ++i, ++it) {  // the chunk's slab directions, three parts
        pipe_acquire(ring, it, tx_x + 3 * kRepChunk * kWgRowBytes, lane);
        load_x(i, it);
        if (lane == 0)
#pragma unroll
          for (int p = 0; p < 3; ++p)
            tma_load_2d(ring.bblk(it) + p * kRepChunk * kWgRowBytes, &rmap, i * kWgCols,
                        p * nsr + c0, ring.full_of(it));
        wg_issued<L>(ring, it, first);
      }
      wg_flush<L>(ring, first, it);
      for (int j = c0; j < c1; j += 2) {
        if (!__syncthreads_or(0)) continue;  // the consumers' vote
        const int slabs = j + 1 < c1 ? 2 : 1;
        first = it;
        for (int i = 0; i < nk; ++i, ++it) {
          pipe_acquire(ring, it, tx_x + slabs * P * BN * kWgRowBytes, lane);
          load_x(i, it);
          if (lane == 0)
#pragma unroll
            for (int p = 0; p < P; ++p)
              for (int s = 0; s < slabs; ++s)
                tma_load_2d(ring.bblk(it) + p * kPart + s * BN * kWgRowBytes, &pmap,
                            i * kWgCols, p * ns * BN + (j + s) * BN, ring.full_of(it));
          wg_issued<L>(ring, it, first);
        }
        wg_flush<L>(ring, first, it);
      }
    }
    pipe_drain(ring, it);
    return;
  }

  // consumers: warpgroup g = t / 128 owns tile rows 64g .. 64g + 63;
  // (t & 127) < 64 the norm of row nrow; each quad owns the state of its
  // two fragment rows
  const int g = t >> 7, nrow = g * 64 + (t & 127);
  const bool norm_thread = (t & 127) < 64;
  int it = 0;
  float rsq = 0.f;
  for (int c0 = 0; c0 < ns; c0 += kRepChunk) {
    const int width = min(kRepChunk, ns - c0);
    const bool fuse = c0 == 0;
    float sr[kRepChunk / 2];
    wg_sweep<kRepChunk, 3>(ring, it, nk, 0, kRepChunk * kWgRowBytes, sr,
                           [&](const unsigned char* xb) {
                             if (fuse && norm_thread) wg_row_sq(xb, nrow, rsq);
                           });
#pragma unroll
    for (int j = 0; j < kRepChunk / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wg_col(t, j, e);
          if (c < width) s_sh[wg_row(t, h) * pitch + c] = sr[4 * j + 2 * h + e];
        }
    if (fuse && norm_thread) rsq_sh[nrow] = rsq;
    consumers_sync(kWgConsumers);

    for (int j = c0; j < c0 + width; j += 2) {
      const int slabs = j + 1 < c0 + width ? 2 : 1;
      float ub[2] = {kNeg, kNeg};  // a row's larger cone bound of the pair
      int need = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg_row(t, h);
        for (int s = 0; s < slabs; ++s) {
          const int slab = j + s;
          const float ap = cone[slab], an = cone[ns + slab], bm = cone[2 * ns + slab];
          const float sv = s_sh[r * pitch + slab - c0];
          const float tt = sqrtf(fmaxf(rsq_sh[r] - sv * sv, 0.f));
          const float u = fmaxf(ap * sv, an * sv) + bm * tt;
          ub[h] = fmaxf(ub[h], u);
          need |= r < rows && u >= rs.best[r] - margin;
        }
      }
      if (__syncthreads_or(need)) {
        if (slabs == 2) {
          float sv[kPair / 2];
          wg_sweep<kPair, P>(ring, it, nk, 0, kPart, sv, [](const unsigned char*) {});
          fold_tile<kPair>(sv, perm + j * BN, rs, rows);
        } else {
          float sv[BN / 2];
          wg_sweep<BN, P>(ring, it, nk, 0, kPart, sv, [](const unsigned char*) {});
          fold_tile<BN>(sv, perm + j * BN, rs, rows);
        }
      } else if ((lane & 3) == 0) {
        // not searched: the cone bounds cap every member of both slabs
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg_row(t, h);
          if (r < rows) rs.sec[r] = fmaxf(rs.sec[r], ub[h]);
        }
      }
      __syncwarp();  // the state written is seen by the row's lanes
    }
  }

  consumers_sync(kWgConsumers);
  if (t < rows) {
    const int row = ids_sh[t];
    idx[row] = rs.bidx[t];
    best_sim[row] = rs.best[t];
    sec_out[row] = rs.sec[t];
    rowsq[row] = rsq_sh[t];
  }
}

static unsigned rows_wg_smem_set[2] = {}, walk_wg_smem_set[2] = {};  // per P == 3

template <int P>
int launch_rows_wg(const bf16* x, const bf16* cg, const int* prev, int n, int d, int k,
                   int* idx, float* best_sim, float* sec, float* rowsq, int* work,
                   cudaStream_t st) {
  int err = allow_smem(bounded_rows_wg<P>, kStatsMaxSmem, rows_wg_smem_set[P == 3]);
  if (err != 0) return err;
  CUtensorMap xmap{};
  const bool xtma = wg_map(&xmap, x, n, d, BM, &err);
  if (err != 0) return err;
  bounded_rows_wg<P><<<(n + BM - 1) / BM, kWgConsumers + 32, rows_wg_smem<P>(), st>>>(
      xmap, xtma, x, cg, prev, n, k, d, idx, best_sim, sec, rowsq, work);
  return (int)cudaGetLastError();
}

template <int P>
int launch_walk_wg(const bf16* x, const bf16* cpp, const int* perm, const bf16* reps,
                   const float* cone, const int* list, const long long* count, int* work, int n,
                   int d, int ns, float margin, int* idx, float* best_sim, float* sec,
                   float* rowsq, cudaStream_t st) {
  int err = allow_smem(bounded_walk_wg<P>, kStatsMaxSmem, walk_wg_smem_set[P == 3]);
  if (err != 0) return err;
  const int stride = split_stride(d), nsr = (ns + kRepChunk - 1) / kRepChunk * kRepChunk;
  CUtensorMap xmap{}, rmap{}, pmap{};
  const bool xtma = wg_map(&xmap, x, n, d, BM, &err);
  if (err != 0) return err;
  // the padded operands are 16-byte rows at least kWgCols wide: the copy engine takes them
  if (!wg_map(&rmap, reps, 3 * nsr, stride, kRepChunk, &err)) return err ? err : (int)cudaErrorInvalidValue;
  if (!wg_map(&pmap, cpp, P * ns * BN, stride, BN, &err)) return err ? err : (int)cudaErrorInvalidValue;
  const int vec16 = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  bounded_walk_wg<P><<<(n + BM - 1) / BM, kWgConsumers + 32, walk_wg_smem<P>(ns), st>>>(
      xmap, rmap, pmap, xtma, vec16, x, list, count, perm, cone, d, ns, margin, idx, best_sim,
      sec, rowsq, work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int assign_stats_bounded_slab() { return BN; }

extern "C" int assign_stats_bounded_rep_chunk() { return kRepChunk; }

extern "C" int assign_stats_bounded_lists(int n, int k, int chunks) {
  return stats_list_ints(n, k, chunks);
}

extern "C" int assign_stats_bounded_chunks(int n, int k, int d) {
  return stats_chunks(n, k, d);
}

// bf16 x, launch 1a (the row pass), before the wrapper finds the settled
// rows: prev, (n,) int32, each row's carried center (outside [0, k): none);
// centers as assign_stats_bounded's bf16 x takes them, celem kElemBf16 or
// kElemSplit3. Writes idx, best_sim and sec of every carried row, rowsq of
// every row of a block holding one (the caller zeroes rowsq first); work:
// null, or (2, ceil(n / 128)) ints zeroed by the caller, where row 0 takes
// a 1 for each 128-row block that worked.
extern "C" int assign_stats_bounded_rows(const void* x, const void* centers, const int* prev,
                                         int celem, int n, int d, int k, int* idx,
                                         float* best_sim, float* sec, float* rowsq, int* work,
                                         void* stream) {
  if (celem != kElemBf16 && celem != kElemSplit3) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto go = celem == kElemSplit3 ? &launch_rows_wg<3> : &launch_rows_wg<1>;
  return go(static_cast<const bf16*>(x), static_cast<const bf16*>(centers), prev, n, d, k, idx,
            best_sim, sec, rowsq, work, static_cast<cudaStream_t>(stream));
}

// xelem, celem: kElemF32 both, or x kElemBf16 with centers kElemBf16 or
// kElemSplit3 (csrc/tma.cuh).
// f32: centers (k, d) (the row pass's carried centers); cp: (ns * 64, d)
// permuted centers, zero pad rows; reps: (ns, d).
// bf16 x (stride = split_stride(d), P = 1 for bf16 centers, 3 for f32
// ones): centers: P matrices of (k, stride) bf16 (bf16 centers padded, or
// split_bf16x3's parts); cp: P matrices of (ns * 64, stride), the permuted
// centers likewise; reps: split_bf16x3's three parts of the directions
// padded to nsr = ns rounded up to assign_stats_bounded_rep_chunk() rows,
// (3, nsr, stride).
// bf16 x: launch 1b (the walk) and the fold, after assign_stats_bounded_rows
// and the wrapper's deflation: list, the active rows (idx0 < 0) in
// ascending order, their number in the int64 at count (both on the device;
// the walk's blocks read them); work: null, or the row pass's (2,
// ceil(n / 128)) ints, whose row 1 takes a 1 for each walk block that
// worked. centers and idx0 are not read (the row pass took them). The f32 mode reads none of list, count and work.
// Both: perm: (ns * 64,) original id per slot, -1 on pad; cone: (3, ns)
// a_pos, a_neg, b_max; idx0: (n,) carried center of a settled row, -1 for
// an active one. Scratch: rowsq holds n floats, part chunks * k * d, part_k
// chunks * 3 * k (then, for bf16 x, the fold's lists: label_stats.cu says
// where).
extern "C" int assign_stats_bounded(
    const void* x, const void* centers, const void* cp, const int* perm,
    const void* reps, const float* cone, const int* idx0, const int* list,
    const long long* count, int* work, int xelem, int celem,
    const float* w, int n, int d, int k, int ns, float margin, int chunks, int* idx,
    float* best_sim, float* sec, float* rowsq, float* part, float* part_k,
    float* sums, float* counts, float* min_sim, float* sumsq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xelem == kElemBf16) {
    if (celem != kElemBf16 && celem != kElemSplit3) return (int)cudaErrorInvalidValue;
    const bf16* xb = static_cast<const bf16*>(x);
    if (n > 0) {
      auto go = celem == kElemSplit3 ? &launch_walk_wg<3> : &launch_walk_wg<1>;
      const int err = go(xb, static_cast<const bf16*>(cp), perm, static_cast<const bf16*>(reps),
                         cone, list, count, work, n, d, ns, margin, idx, best_sim, sec, rowsq,
                         st);
      if (err != 0) return err;
    }
    return launch_stats<true>(xb, idx, w, rowsq, best_sim, n, d, k, chunks, part, part_k, sums,
                              counts, min_sim, sumsq, st);
  }
  if (xelem != kElemF32 || celem != kElemF32) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(centers);
  const float* cpf = static_cast<const float*>(cp);
  const float* rf = static_cast<const float*>(reps);
  if (n > 0) {
    int err = allow_smem(bounded_sweep, kStatsMaxSmem, sweep_smem_set);
    if (err != 0) return err;
    CUtensorMap xmap{}, rmap{}, pmap{};
    const bool tx = pipe_map(&xmap, xf, n, d, BM, &err);
    if (err != 0) return err;
    const bool tr = pipe_map(&rmap, rf, ns, d, BN, &err);
    if (err != 0) return err;
    const bool tp = pipe_map(&pmap, cpf, ns * BN, d, BN, &err);
    if (err != 0) return err;
    const int vec16 = d % 4 == 0 && reinterpret_cast<uintptr_t>(cf) % 16 == 0;
    bounded_sweep<<<(n + BM - 1) / BM, (kWarps + 1) * 32, bounded_smem(ns), st>>>(
        xmap, rmap, pmap, tx && tr && tp, vec16, xf, cf, cpf, perm, rf, cone, idx0, n,
        k, d, ns, margin, idx, best_sim, sec, rowsq);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return launch_stats<true>(xf, idx, w, rowsq, best_sim, n, d, k, chunks, part,
                            part_k, sums, counts, min_sim, sumsq, st);
}
