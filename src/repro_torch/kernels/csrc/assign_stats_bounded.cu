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

#include "assign_pipe.cuh"
#include "label_stats.cuh"

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

// Merge the triples of the 8 lanes of one row; every one of them ends with
// the row's slab winner and second value.
__device__ __forceinline__ void row_top2(float& b, int& bo, float& s) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
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
    row_top2(lb, lo, ls);
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

}  // namespace

extern "C" int assign_stats_bounded_slab() { return BN; }

extern "C" int assign_stats_bounded_chunks(int n, int k, int d) {
  return stats_chunks(n, k, d);
}

// cp: (ns * 64, d) permuted centers, zero pad rows; perm: (ns * 64,) original
// id per slot, -1 on pad; reps: (ns, d); cone: (3, ns) a_pos, a_neg, b_max;
// idx0: (n,) carried center of a settled row, -1 for an active one.
// Scratch: rowsq holds n floats, part chunks * k * d, part_k chunks * 3 * k.
extern "C" int assign_stats_bounded(
    const float* x, const float* centers, const float* cp, const int* perm,
    const float* reps, const float* cone, const int* idx0, const float* w,
    int n, int d, int k, int ns, float margin, int chunks, int* idx,
    float* best_sim, float* sec, float* rowsq, float* part, float* part_k,
    float* sums, float* counts, float* min_sim, float* sumsq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    int err = allow_smem(bounded_sweep, kStatsMaxSmem, sweep_smem_set);
    if (err != 0) return err;
    CUtensorMap xmap{}, rmap{}, pmap{};
    const bool tx = pipe_map(&xmap, x, n, d, BM, &err);
    if (err != 0) return err;
    const bool tr = pipe_map(&rmap, reps, ns, d, BN, &err);
    if (err != 0) return err;
    const bool tp = pipe_map(&pmap, cp, ns * BN, d, BN, &err);
    if (err != 0) return err;
    const int vec16 = d % 4 == 0 && reinterpret_cast<uintptr_t>(centers) % 16 == 0;
    bounded_sweep<<<(n + BM - 1) / BM, (kWarps + 1) * 32, bounded_smem(ns), st>>>(
        xmap, rmap, pmap, tx && tr && tp, vec16, x, centers, cp, perm, reps, cone, idx0, n,
        k, d, ns, margin, idx, best_sim, sec, rowsq);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return launch_stats<true>(x, idx, w, rowsq, best_sim, n, d, k, chunks, part,
                            part_k, sums, counts, min_sim, sumsq, st);
}
