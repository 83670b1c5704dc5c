// best_edge: per row of an already-built similarity block, the best column
// in another component.
//
// Replaces the TPU kernel src/repro/kernels/best_edge.py (best_edge_pallas,
// body _kernel). Contract of ref.best_edge: a column is a candidate iff
// lr != lc && lr >= 0 && lc >= 0; every other column counts as f32.min; the
// row maximum goes to the lowest column on ties (-0.0 and +0.0 compare
// equal); NaN ranks above every number and the first NaN wins, as
// torch.amax/argmax rank them; a row whose maximum is f32.min gets
// (-1, f32.min).
//
// What bounds it on an H100: bytes. The kernel reads the (r, c) block once
// (r*c*4 bytes: 16 MB at 2,000 x 2,000, 50 MB at the main path's
// 3,536 x 3,536, a bound of 4.8 and 14.9 us at 3.35 TB/s) and does no
// arithmetic: it only compares values, so its result is exact whatever order
// it visits the columns in.
//
// What the design does about it. Rows are independent, so one warp reduces
// one row, and the block has to keep enough of the row in flight that HBM,
// not the round trips, sets the time:
//  - 16-byte loads. A row is read as float4 from its first 16-byte-aligned
//    column (read-only, not kept in L1); the up to 3 columns before it (a
//    row starts at another alignment when c % 4 != 0) and the up to 3 after
//    the last whole vector are scalar loads started with the first batch.
//    Each lane loads kVec vectors a batch (2 KB a warp) and starts the next
//    batch before it compares the current one, so two batches are in flight
//    and a 14 KB row takes about 4 round trips (the first design: 4 bytes a
//    lane, 14 dependent round trips).
//  - The column labels are staged in shared memory once per block (c*4
//    bytes; 14 KB at 3,536) while the first batch of the block's first rows
//    is in flight, and every row of the block reads them from there (the
//    first design re-read them from global memory for every row: as many
//    bytes again as the block). Past kMaxStaged columns a second
//    instantiation of the same kernel reads them from global memory.
//  - A persistent grid sized to the card: blocks per SM from the occupancy
//    calculator times the SM count (both kept per device), capped by the
//    rows. Warp w of block b takes rows b + G*w, b + G*(w + kWarps), ...
//    (G blocks), so the blocks' rows differ by at most one and an SM's by
//    one or two (the first design's 8-row blocks spread 3 or 4 to an SM).
//    While a warp merges its lanes' winners, the first batch of its next
//    row is already in flight.
// Within a lane the columns come in increasing order, so a later column
// takes the lane's place only when it is strictly above it (or is the first
// NaN); lanes are merged under the total (value desc, column asc) order of
// beats(). A lane starts at (-inf, c) and no -inf column ever replaces it, so
// a row whose candidates are all -inf (and that has no other column) ends at
// -inf and gets column 0, the lowest of its tied columns.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kWarps = 16;                  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 4;                     // float4 loads a lane a batch
constexpr int kBatch = 32 * kVec;           // vectors a warp a batch
constexpr int kMaxStaged = 232448 / 4;      // labels one block's shared memory holds
constexpr float kNeg = -FLT_MAX;

// (value desc, column asc) winner of two candidates, with NaN above every
// number and the first NaN winning, as torch.amax/argmax rank them.
__device__ __forceinline__ bool beats(float v, int j, float bv, int bj) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || j < bj);
  return v > bv || (v == bv && j < bj);
}

// 16 bytes read once: not kept in L1.
__device__ __forceinline__ float4 ld_stream(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_stream1(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// One row as the lanes read it: `head` scalar columns, then `nv` float4
// vectors from column `head`, then `c - head - 4*nv` scalar columns.
struct Row {
  const float* p;
  int head, nv;
};

__device__ __forceinline__ Row row_view(const float* sim, int row, int c) {
  const float* p = sim + (size_t)row * c;
  const int head = min(c, (int)((0u - (unsigned)(reinterpret_cast<uintptr_t>(p) >> 2)) & 3u));
  return {p, head, (c - head) >> 2};
}

// The lane's vectors of the batch that starts at vector q0.
__device__ __forceinline__ void fetch(float4 (&buf)[kVec], const Row& w, int q0, int lane) {
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int q = q0 + lane + 32 * u;
    if (q < w.nv) buf[u] = ld_stream(w.p + w.head + 4 * q);
  }
}

// The lane's running (max, column) over one column, in increasing column
// order: strictly above, or the first NaN.
__device__ __forceinline__ void take(float v, int l, int j, int lrow, float& best, int& bj) {
  const float m = (l >= 0 && l != lrow) ? v : kNeg;
  if (!(m <= best) && best == best) {
    best = m;
    bj = j;
  }
}

__device__ __forceinline__ void scan(const float4 (&buf)[kVec], const Row& w, int q0, int lane,
                                     const int* lab, int lrow, float& best, int& bj) {
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int q = q0 + lane + 32 * u;
    if (q >= w.nv) break;
    const int j = w.head + 4 * q;
    take(buf[u].x, lab[j], j, lrow, best, bj);
    take(buf[u].y, lab[j + 1], j + 1, lrow, best, bj);
    take(buf[u].z, lab[j + 2], j + 2, lrow, best, bj);
    take(buf[u].w, lab[j + 3], j + 3, lrow, best, bj);
  }
}

// A row's first loads: its label, its first batch, its head and tail columns.
struct First {
  int lrow;
  float hv, tv;
};

__device__ __forceinline__ First fetch_first(float4 (&buf)[kVec], const Row& w, const int* lr,
                                             int row, int c, int lane) {
  First f;
  f.lrow = __ldg(lr + row);
  fetch(buf, w, 0, lane);
  const int tail = w.head + 4 * w.nv;
  f.hv = lane < w.head ? ld_stream1(w.p + lane) : -INFINITY;
  f.tv = tail + lane < c ? ld_stream1(w.p + tail + lane) : -INFINITY;
  return f;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    best_edge_rows(const float* __restrict__ sim, const int* __restrict__ lr,
                   const int* __restrict__ lc, int r, int c,
                   int* __restrict__ best_j, float* __restrict__ best_s) {
  extern __shared__ __align__(16) int staged[];
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  int row = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;

  float4 a[kVec], b[kVec];
  Row w{};
  First f{};
  if (row < r) {
    w = row_view(sim, row, c);
    f = fetch_first(a, w, lr, row, c, lane);
  }
  const int* lab = lc;
  if constexpr (kStaged) {
    const int nq = (reinterpret_cast<uintptr_t>(lc) & 15) == 0 ? c >> 2 : 0;
    for (int q = threadIdx.x; q < nq; q += kThreads)
      reinterpret_cast<int4*>(staged)[q] = __ldg(reinterpret_cast<const int4*>(lc) + q);
    for (int j = 4 * nq + threadIdx.x; j < c; j += kThreads) staged[j] = __ldg(lc + j);
    __syncthreads();
    lab = staged;
  }

  while (row < r) {
    const int lrow = f.lrow;
    float best = -INFINITY;  // loses to every column, f32.min included
    int bj = c;
    if (lrow >= 0) {  // a pad row has no candidate: (-1, f32.min)
      if (lane < w.head) take(f.hv, lab[lane], lane, lrow, best, bj);
      const int nb = (w.nv + kBatch - 1) / kBatch;
      for (int i = 0; i < nb; i += 2) {
        if (i + 1 < nb) fetch(b, w, (i + 1) * kBatch, lane);
        scan(a, w, i * kBatch, lane, lab, lrow, best, bj);
        if (i + 1 >= nb) break;
        if (i + 2 < nb) fetch(a, w, (i + 2) * kBatch, lane);
        scan(b, w, (i + 1) * kBatch, lane, lab, lrow, best, bj);
      }
      const int tail = w.head + 4 * w.nv + lane;
      if (tail < c) take(f.tv, lab[tail], tail, lrow, best, bj);
    }
    const int cur = row;
    row += stride;
    if (row < r) {  // the next row's loads fly while this one is merged
      w = row_view(sim, row, c);
      f = fetch_first(a, w, lr, row, c, lane);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (beats(ov, oj, best, bj)) {
        best = ov;
        bj = oj;
      }
    }
    if (lane == 0) {
      if (lrow < 0) best = kNeg;
      best_s[cur] = best;
      // -inf: no column got past a lane's start, so every column was a
      // candidate at -inf, and the lowest of them wins
      best_j[cur] = best == kNeg ? -1 : best == -INFINITY ? 0 : bj;
    }
  }
}

// Per device: the SM count and the blocks an SM holds of each instantiation
// (the staged one for the shared memory of the last c asked for).
struct Fit {
  int sms = 0, global_blocks = 0, staged_bytes = -1, staged_blocks = 0;
};
constexpr int kDevices = 32;
Fit fits[kDevices];
unsigned smem_allowed = 0;  // repro::allow_smem's bit per device

int blocks_per_sm(bool staged, int bytes, int& sms, int& blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  Fit local;
  Fit& fit = dev < kDevices ? fits[dev] : local;
  if (fit.sms == 0) {
    e = cudaDeviceGetAttribute(&fit.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit.global_blocks,
                                                        best_edge_rows<false>, kThreads, 0);
    if (e != cudaSuccess) {
      fit.sms = 0;
      return (int)e;
    }
  }
  if (staged && fit.staged_bytes != bytes) {
    const int err = repro::allow_smem(best_edge_rows<true>, kMaxStaged * 4, smem_allowed);
    if (err != 0) return err;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit.staged_blocks, best_edge_rows<true>,
                                                      kThreads, bytes);
    if (e != cudaSuccess) return (int)e;
    fit.staged_bytes = bytes;
  }
  sms = fit.sms;
  blocks = staged ? fit.staged_blocks : fit.global_blocks;
  return 0;
}

}  // namespace

// r > 0 and c > 0: the wrapper answers the empty cases without a launch.
extern "C" int best_edge(const float* sim, const int* lr, const int* lc, int r,
                         int c, int* best_j, float* best_s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool staged = c <= kMaxStaged;
  const int bytes = staged ? c * 4 : 0;
  int sms = 0, per_sm = 0;
  const int err = blocks_per_sm(staged, bytes, sms, per_sm);
  if (err != 0) return err;
  // enough blocks an SM for the rows, the same number on every SM, and
  // never more blocks than rows
  const long long wave = (long long)sms * kWarps;
  const long long per = std::min<long long>((r + wave - 1) / wave, std::max(per_sm, 1));
  const int grid = (int)std::min<long long>(sms * per, r);
  if (staged)
    best_edge_rows<true><<<grid, kThreads, bytes, st>>>(sim, lr, lc, r, c, best_j, best_s);
  else
    best_edge_rows<false><<<grid, kThreads, 0, st>>>(sim, lr, lc, r, c, best_j, best_s);
  return static_cast<int>(cudaGetLastError());
}
