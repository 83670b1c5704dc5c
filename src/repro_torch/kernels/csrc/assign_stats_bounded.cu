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
// 128 rows. It first walks the rows once (one fmaf chain over d per row, in
// order): the squared norm, and for a settled row its similarity to its
// carried center, so that value has the bits a full sweep would give. If any
// row of the block is active it computes s for every slab at once (one
// register tile of the rows against the slab directions), then walks the
// slabs in slab order. Per slab the block votes (__syncthreads_or) whether
// any active row's cone bound reaches its running best minus the margin;
// only then does it run the 128 x 64 tile of tile_dot.cuh and fold the slab
// into each row's (best, lowest original id, second value); otherwise the
// slab's cone bound goes into the row's second value. A block whose rows are
// all settled sweeps nothing. The TPU kernel skipped slabs with @pl.when
// over the same per-block test; its sequential grid carried the row state
// in VMEM, where here a block owns its rows for the whole walk. Launches 2-3
// are label_stats' deterministic fold with the extra scalars
// (label_stats.cuh), as in assign_stats.cu; the TPU kernel's ACC_BUDGET split
// existed only for VMEM and is not carried over.

#include "label_stats.cuh"
#include "tile_dot.cuh"

namespace {

using namespace repro;

constexpr int BM = 128, BN = 64, TM = 8, TN = 4;  // BN centers = one slab
constexpr int kTx = TileShape<BM, BN, TM, TN>::kTx;

// Fold candidate (v, o) into a (best, lowest original id, second) triple;
// the second value masks one instance of the winner only, so an equal value
// under another id counts as the second best.
__device__ __forceinline__ void top2_push(float v, int o, float& b, int& bo,
                                          float& s) {
  if (beats(v, o, b, bo)) {
    s = fmaxf(s, b);
    b = v;
    bo = o;
  } else {
    s = fmaxf(s, v);
  }
}

// Merge the triples of the kTx threads of one tile row; every one of them
// ends with the row's slab winner and second value.
__device__ __forceinline__ void row_top2(float& b, int& bo, float& s) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1) {
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

__global__ void __launch_bounds__(kThreads, 2)
    bounded_sweep(const float* __restrict__ x, const float* __restrict__ centers,
                  const float* __restrict__ cp, const int* __restrict__ perm,
                  const float* __restrict__ reps, const float* __restrict__ cone,
                  const int* __restrict__ idx0, int n, int k, int d, int ns,
                  float margin, int* __restrict__ idx,
                  float* __restrict__ best_sim, float* __restrict__ sec_out,
                  float* __restrict__ rowsq) {
  __shared__ __align__(16) float as[kBK][BM + 4];
  __shared__ __align__(16) float bs[kBK][BN + 4];
  __shared__ float s_sh[BM][BN + 1];  // x . rep for (row, slab of the chunk)
  __shared__ float rsq_sh[BM], sim0_sh[BM];
  __shared__ int idx0_sh[BM];
  const int t = threadIdx.x;
  const int tx = t % kTx, ty = t / kTx;
  const int row0 = blockIdx.x * BM;

  if (t < BM) idx0_sh[t] = row0 + t < n ? idx0[row0 + t] : -1;
  __syncthreads();

  // Row pass: the fmaf chains of tile_dot.cuh over d in order (pad columns
  // would add fmaf(0, 0, .), which changes nothing, so they are skipped).
  {
    const int p = t < BM ? idx0_sh[t] : -1;
    const float* c = centers + (size_t)(p < 0 ? 0 : p) * d;
    float rs = 0.f, sp = 0.f;
    for (int k0 = 0; k0 < d; k0 += kBK) {
      stage<BM>(x, n, d, row0, k0, as);
      __syncthreads();
      if (t < BM) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          const float v = as[kk][t];
          rs = fmaf(v, v, rs);
          if (p >= 0 && k0 + kk < d) sp = fmaf(v, c[k0 + kk], sp);
        }
      }
      __syncthreads();
    }
    if (t < BM) {
      rsq_sh[t] = rs;
      sim0_sh[t] = sp;
      if (row0 + t < n) rowsq[row0 + t] = rs;
    }
  }
  __syncthreads();

  // Row state, held by each of the kTx threads of a tile row. A settled row
  // starts final at its carried center; an active row at (NEG, -1).
  float best[TM], sec[TM];
  int bidx[TM];
  bool act[TM];
  int any = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tile_row<BM, TM>(ty, i);
    const int p = idx0_sh[r];
    act[i] = row0 + r < n && p < 0;
    best[i] = p >= 0 ? sim0_sh[r] : kNeg;
    bidx[i] = p;
    sec[i] = kNeg;
    any |= act[i];
  }
  if (__syncthreads_or(any)) {
    for (int c0 = 0; c0 < ns; c0 += BN) {
      float acc[TM][TN];
      float unused = 0.f;
      tile_dot<BM, BN, TM, TN, false>(x, n, reps, ns, d, row0, c0, as, bs, acc,
                                      unused);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          s_sh[tile_row<BM, TM>(ty, i)][tile_row<BN, TN>(tx, j)] = acc[i][j];
      __syncthreads();

      const int c1 = min(ns, c0 + BN);
      for (int slab = c0; slab < c1; ++slab) {
        const float ap = cone[slab], an = cone[ns + slab], bm = cone[2 * ns + slab];
        float ub[TM];
        int need = 0;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = tile_row<BM, TM>(ty, i);
          const float s = s_sh[r][slab - c0];
          const float tt = sqrtf(fmaxf(rsq_sh[r] - s * s, 0.f));
          ub[i] = fmaxf(ap * s, an * s) + bm * tt;
          need |= act[i] && ub[i] >= best[i] - margin;
        }
        if (__syncthreads_or(need)) {
          tile_dot<BM, BN, TM, TN, false>(x, n, cp, ns * BN, d, row0, slab * BN,
                                          as, bs, acc, unused);
          int orig[TN];
#pragma unroll
          for (int j = 0; j < TN; ++j) orig[j] = perm[slab * BN + tile_row<BN, TN>(tx, j)];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            float lb = kNeg, ls = kNeg;
            int lo = -1;
            if (act[i]) {
#pragma unroll
              for (int j = 0; j < TN; ++j)
                if (orig[j] >= 0) top2_push(acc[i][j], orig[j], lb, lo, ls);
            }
            row_top2(lb, lo, ls);
            if (lb > kNeg) {  // the row had a candidate in this slab
              sec[i] = fmaxf(fmaxf(sec[i], ls), fminf(best[i], lb));
              if (lb > best[i] || (lb == best[i] && lo < bidx[i])) {
                best[i] = lb;
                bidx[i] = lo;
              }
            }
          }
        } else {
          // not searched: the cone bound caps every member of the slab
#pragma unroll
          for (int i = 0; i < TM; ++i)
            if (act[i]) sec[i] = fmaxf(sec[i], ub[i]);
        }
      }
      __syncthreads();  // s_sh is rewritten by the next chunk of slabs
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + tile_row<BM, TM>(ty, i);
      if (row < n) {
        idx[row] = bidx[i];
        best_sim[row] = best[i];
        sec_out[row] = sec[i];
      }
    }
  }
}

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
    bounded_sweep<<<(n + BM - 1) / BM, kThreads, 0, st>>>(
        x, centers, cp, perm, reps, cone, idx0, n, k, d, ns, margin, idx,
        best_sim, sec, rowsq);
    REPRO_CHECK_LAUNCH();
  }
  return launch_stats<true>(x, idx, w, rowsq, best_sim, n, d, k, chunks, part,
                            part_k, sums, counts, min_sim, sumsq, st);
}
