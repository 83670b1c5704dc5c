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
//
// A bf16 block (the TPU kernel upcasts a bf16 block in its body,
// best_edge.py:40) is read as it lies, with the same 16-byte loads (8
// columns each), and its result has the bits of the f32 kernel on the
// block's f32 upcast; the bound halves (r*c*2 bytes: 25.0 MB, 7.5 us at
// 3,536 x 3,536). Read the f32 way it ran at 31 % of that bound, paced by
// its label reads: lane L's vector starts at column head + 8(q0 + L + 32u),
// so for each of its 8 columns the 32 lanes read int32 labels 32 bytes
// apart, 8 to a shared-memory bank, 64 wavefronts for every 256 columns a
// warp reads (the f32 block's 4 columns a vector make it 4-way, and its
// bytes hide it). On an H100 that kernel took 0.0173-0.0185 ms alone at
// 3,536^2, and 0.0126-0.0127 with its label reads taken out. So
// best_edge_rows_bf16:
//  - stages the labels as int16 (every negative one as -1) and learns while
//    it stages, by __syncthreads_or, whether every label fits. A lane then
//    reads its vector's 8 labels in one 16-byte load, lanes 16 bytes apart:
//    4 wavefronts for 256 columns. A row off 16 bytes (head = 1..7, its
//    vectors start at column head + 8q) reads the 16 labels from column 8q
//    in two loads and shifts them by head halves in registers. Int16 also
//    holds twice the columns (kMaxStaged16). Where a label does not fit,
//    the block stages their high halves too (up to kMaxStagedWide columns),
//    else reads the int32 labels from global memory column by column, as an
//    f32 block's are.
//  - compares two columns at a time: each word of two labels gives a mask
//    of the candidates (label >= 0, not the row's), a non-candidate's value
//    becomes -inf in bf16 (f32.min has no bf16 value: it lies between -inf
//    and the lowest finite bf16, so a row whose candidates are all -inf is
//    told apart by a flag, `masked`, and gets (-1, f32.min) where some
//    column was masked), and the vector's maximum (max.NaN.bf16x2: NaN if
//    any is NaN) decides whether any of its columns beats the lane's best;
//    only then are its 8 columns taken one by one, as above. A lane first
//    loads its batch's labels and makes every vector's mask and maximum,
//    then takes the vectors in column order.
// What paces it now: the block's bytes and the reads' fixed costs. A build
// that loads the block the same way and does no compare at all took
// 0.0110-0.0111 ms alone and 0.0168-0.0172 after a 512 MB write, this one
// 0.0129-0.0132 and 0.0185-0.0191 (NVIDIA H100 80GB HBM3, 700 W;
// tools/best_edge_probe.py).

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 16;                  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 4;                     // 16-byte loads a lane a batch
constexpr int kBatch = 32 * kVec;           // vectors a warp a batch
constexpr int kSmem = 232448;               // shared memory a block can have
constexpr int kMaxStaged = kSmem / 4;       // int32 labels it holds (an f32 block)
// A bf16 block's int16 labels: round8(c) + 8 a copy, the 8 for the second
// load of a shifted read at the row's last vector. One copy (every label in
// the int16 range) up to kMaxStaged16 columns, two (their low and high
// halves) up to kMaxStagedWide.
__host__ __device__ constexpr int staged16_len(int c) { return ((c + 7) & ~7) + 8; }
constexpr int kMaxStaged16 = kSmem / 2 - 8;    // 116,216
constexpr int kMaxStagedWide = kSmem / 4 - 8;  // 58,104
static_assert(2 * staged16_len(kMaxStaged16) <= kSmem && 4 * staged16_len(kMaxStagedWide) <= kSmem);
constexpr float kNeg = -FLT_MAX;

// (value desc, column asc) winner of two candidates, with NaN above every
// number and the first NaN winning, as torch.amax/argmax rank them.
__device__ __forceinline__ bool beats(float v, int j, float bv, int bj) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || j < bj);
  return v > bv || (v == bv && j < bj);
}

// Columns a 16-byte vector holds: 4 f32 or 8 bf16.
template <typename T>
constexpr int kPer = 16 / sizeof(T);

// 16 bytes read once: not kept in L1.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_stream1(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_stream1(const bf16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.L1::no_allocate.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return __uint_as_float((unsigned)v << 16);
}

// Column u of a vector, as f32 (a bf16 value's bits are the top half of its
// f32's, so the conversion is exact).
template <typename T>
__device__ __forceinline__ float column(const uint4& v, int u) {
  const unsigned w = u / (kPer<T> / 4) == 0 ? v.x : u / (kPer<T> / 4) == 1 ? v.y
                     : u / (kPer<T> / 4) == 2 ? v.z : v.w;
  if constexpr (kPer<T> == 4) return __uint_as_float(w);
  return __uint_as_float(u & 1 ? w & 0xffff0000u : w << 16);
}

// One row as the lanes read it: `head` scalar columns, then `nv` 16-byte
// vectors from column `head`, then `c - head - kPer*nv` scalar columns.
template <typename T>
struct Row {
  const T* p;
  int head, nv;
};

template <typename T>
__device__ __forceinline__ Row<T> row_view(const T* sim, int row, int c) {
  constexpr unsigned per = kPer<T>;
  const T* p = sim + (size_t)row * c;
  const int head = min(c, (int)((0u - (unsigned)(reinterpret_cast<uintptr_t>(p) / sizeof(T))) &
                                (per - 1)));
  return {p, head, (c - head) / (int)per};
}

// The lane's vectors of the batch that starts at vector q0.
template <typename T>
__device__ __forceinline__ void fetch(uint4 (&buf)[kVec], const Row<T>& w, int q0, int lane) {
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int q = q0 + lane + 32 * u;
    if (q < w.nv) buf[u] = ld_stream(w.p + w.head + kPer<T> * q);
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

template <typename T>
__device__ __forceinline__ void scan(const uint4 (&buf)[kVec], const Row<T>& w, int q0, int lane,
                                     const int* lab, int lrow, float& best, int& bj) {
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int q = q0 + lane + 32 * u;
    if (q >= w.nv) break;
    const int j = w.head + kPer<T> * q;
#pragma unroll
    for (int e = 0; e < kPer<T>; ++e) take(column<T>(buf[u], e), lab[j + e], j + e, lrow, best, bj);
  }
}

// A row's first loads: its label, its first batch, its head and tail columns.
struct First {
  int lrow;
  float hv, tv;
};

template <typename T>
__device__ __forceinline__ First fetch_first(uint4 (&buf)[kVec], const Row<T>& w, const int* lr,
                                             int row, int c, int lane) {
  First f;
  f.lrow = __ldg(lr + row);
  fetch(buf, w, 0, lane);
  const int tail = w.head + kPer<T> * w.nv;
  f.hv = lane < w.head ? ld_stream1(w.p + lane) : -INFINITY;
  f.tv = tail + lane < c ? ld_stream1(w.p + tail + lane) : -INFINITY;
  return f;
}

// The lanes' (best, column) merged under beats() and written by lane 0.
// `masked`: some column of the row was not a candidate (bf16 mode, where a
// lane's best skips them); -inf: no column got past a lane's start, so every
// column was a candidate at -inf, and the lowest of them wins.
template <bool kMasked>
__device__ __forceinline__ void merge_and_write(float best, int bj, int lrow, bool masked, int lane,
                                                int cur, int* best_j, float* best_s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (beats(ov, oj, best, bj)) {
      best = ov;
      bj = oj;
    }
  }
  if constexpr (kMasked) masked = __any_sync(0xffffffffu, masked);
  if (lane == 0) {
    if (lrow < 0 || (best == -INFINITY && masked)) best = kNeg;
    best_s[cur] = best;
    best_j[cur] = best == kNeg ? -1 : best == -INFINITY ? 0 : bj;
  }
}

// The warp's rows from `row` on, each column's label read from `lab` (shared
// or global memory) as one int: the f32 block, and a bf16 block whose labels
// do not fit shared memory. The first batch of `row` is in flight in `a`.
template <typename T>
__device__ __forceinline__ void rows_by_column(const T* sim, const int* lr, const int* lab, int r,
                                               int c, int* best_j, float* best_s, int row,
                                               Row<T>& w, First& f, uint4 (&a)[kVec],
                                               uint4 (&b)[kVec]) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
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
      const int tail = w.head + kPer<T> * w.nv + lane;
      if (tail < c) take(f.tv, lab[tail], tail, lrow, best, bj);
    }
    const int cur = row;
    row += stride;
    if (row < r) {  // the next row's loads fly while this one is merged
      w = row_view(sim, row, c);
      f = fetch_first(a, w, lr, row, c, lane);
    }
    merge_and_write<false>(best, bj, lrow, false, lane, cur, best_j, best_s);
  }
}

// The f32 block (labels staged as int32, or read from global memory past
// kMaxStaged columns) and a bf16 block past kMaxStaged16 columns.
template <bool kStaged, typename T>
__global__ void __launch_bounds__(kThreads)
    best_edge_rows(const T* __restrict__ sim, const int* __restrict__ lr,
                   const int* __restrict__ lc, int r, int c,
                   int* __restrict__ best_j, float* __restrict__ best_s) {
  extern __shared__ __align__(16) int staged[];
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;

  uint4 a[kVec], b[kVec];
  Row<T> w{};
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
  rows_by_column(sim, lr, lab, r, c, best_j, best_s, row, w, f, a, b);
}

// ------------------------------------------------------------ a bf16 block

// Each 16-bit half of x with its own bit 15 copied over it.
__device__ __forceinline__ unsigned spread_sign16(unsigned x) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(x), "r"(0u), "r"(0xbb99u));
  return d;
}

// The larger of two bf16 values in each half, NaN if either is NaN.
__device__ __forceinline__ unsigned max_nan2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.NaN.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 0xffff in each half of a word of two staged labels (or, wide, of their
// low halves `lo` and high halves `hi`) whose column is a candidate: a label
// >= 0 (its high half's bit 15 clear) that is not the row's (x's half not 0;
// bit 15 of ((x & 0x7fff) + 0x7fff) | x is set iff the half is not 0).
// `rl`, `rh`: the row label's halves, each in both halves of a word.
template <bool kWide>
__device__ __forceinline__ unsigned candidates(unsigned lo, unsigned hi, unsigned rl, unsigned rh) {
  const unsigned x = kWide ? (lo ^ rl) | (hi ^ rh) : lo ^ rl;
  const unsigned nz = ((x & 0x7fff7fffu) + 0x7fff7fffu) | x;
  return spread_sign16(nz & ~(kWide ? hi : lo));
}

// The 8 staged labels of columns head + 8q .. head + 8q + 7, two a word in
// column order: one 16-byte load at a row that starts on 16 bytes (head =
// 0), else the 16 labels from column 8q and a shift by head halves in
// registers (head is the warp's: no divergence).
template <bool kAligned>
__device__ __forceinline__ uint4 labels8(const unsigned short* s, int q, int head) {
  const uint4 a = *reinterpret_cast<const uint4*>(s + 8 * q);
  if constexpr (kAligned) {
    return a;
  }
  const uint4 b = *reinterpret_cast<const uint4*>(s + 8 * q + 8);
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned v[6], u[5];
#pragma unroll
  for (int m = 0; m < 6; ++m) v[m] = head & 4 ? w[m + 2] : w[m];
#pragma unroll
  for (int m = 0; m < 5; ++m) u[m] = head & 2 ? v[m + 1] : v[m];
  const unsigned sh = (head & 1) * 16;
  return {__funnelshift_r(u[0], u[1], sh), __funnelshift_r(u[1], u[2], sh),
          __funnelshift_r(u[2], u[3], sh), __funnelshift_r(u[3], u[4], sh)};
}

// A bf16 vector's 8 columns with every one that is not a candidate (its
// half of k clear) made -inf.
__device__ __forceinline__ uint4 masked8(const uint4& v, const uint4& k) {
  constexpr unsigned kNegInf2 = 0xff80ff80u;  // -inf in both halves
  return {(v.x & k.x) | (kNegInf2 & ~k.x), (v.y & k.y) | (kNegInf2 & ~k.y),
          (v.z & k.z) | (kNegInf2 & ~k.z), (v.w & k.w) | (kNegInf2 & ~k.w)};
}

// Their maximum, taken two columns at a time, as f32: NaN if one is NaN.
__device__ __forceinline__ float max8(const uint4& m) {
  unsigned top = max_nan2(max_nan2(m.x, m.y), max_nan2(m.z, m.w));
  top = max_nan2(top, top >> 16);
  return __uint_as_float(top << 16);
}

// The lane's running (max, column) over a masked vector of 8 columns from j,
// in column order: strictly above, or the first NaN. Called only where the
// vector's maximum beats the lane's best.
__device__ __forceinline__ void take8(const uint4& m, int j, float& best, int& bj) {
  const unsigned w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float x = __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
    if (!(x <= best) && best == best) {
      best = x;
      bj = j + e;
    }
  }
}

// A staged label as an int (negative labels staged as -1).
template <bool kWide>
__device__ __forceinline__ int label_at(const unsigned short* lo, const unsigned short* hi, int j) {
  if constexpr (kWide) return (int)((unsigned)hi[j] << 16 | lo[j]);
  return (short)lo[j];
}

// One column, its label l: a column that is not a candidate only sets
// `masked`.
__device__ __forceinline__ void take16(float v, int l, int j, int lrow, float& best, int& bj,
                                       bool& masked) {
  if (l < 0 || l == lrow) {
    masked = true;
  } else if (!(v <= best) && best == best) {
    best = v;
    bj = j;
  }
}

// The lane's vectors of a batch: first every vector's labels, candidate
// masks and maximum (a vector past the row reads the first vector's labels
// and counts for nothing: no candidate, no masked column), then, in column
// order, the columns of each vector whose maximum beats the lane's best
// (the others' columns are never compared one by one).
template <bool kWide, bool kAligned>
__device__ __forceinline__ void scan16(const uint4 (&buf)[kVec], const Row<bf16>& w, int q0,
                                       int lane, const unsigned short* lo, const unsigned short* hi,
                                       unsigned rl, unsigned rh, float& best, int& bj,
                                       unsigned& all) {
  uint4 m[kVec];
  float mx[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int q = q0 + lane + 32 * u;
    const bool in = q < w.nv;
    const uint4 l = labels8<kAligned>(lo, in ? q : 0, w.head);
    uint4 h{};
    if constexpr (kWide) h = labels8<kAligned>(hi, in ? q : 0, w.head);
    uint4 k = {candidates<kWide>(l.x, h.x, rl, rh), candidates<kWide>(l.y, h.y, rl, rh),
               candidates<kWide>(l.z, h.z, rl, rh), candidates<kWide>(l.w, h.w, rl, rh)};
    if (!in) k = {0u, 0u, 0u, 0u};
    all &= in ? k.x & k.y & k.z & k.w : ~0u;
    m[u] = masked8(buf[u], k);
    mx[u] = max8(m[u]);
  }
#pragma unroll
  for (int u = 0; u < kVec; ++u)
    if (!(mx[u] <= best) && best == best) take8(m[u], w.head + 8 * (q0 + lane + 32 * u), best, bj);
}

// One row's vectors, two batches in flight (a holds the first).
template <bool kWide, bool kAligned>
__device__ __forceinline__ void row16(const Row<bf16>& w, uint4 (&a)[kVec],
                                      uint4 (&b)[kVec], int lane, const unsigned short* lo,
                                      const unsigned short* hi, unsigned rl, unsigned rh,
                                      float& best, int& bj, unsigned& all) {
  const int nb = (w.nv + kBatch - 1) / kBatch;
  for (int i = 0; i < nb; i += 2) {
    if (i + 1 < nb) fetch(b, w, (i + 1) * kBatch, lane);
    scan16<kWide, kAligned>(a, w, i * kBatch, lane, lo, hi, rl, rh, best, bj, all);
    if (i + 1 >= nb) break;
    if (i + 2 < nb) fetch(a, w, (i + 2) * kBatch, lane);
    scan16<kWide, kAligned>(b, w, (i + 1) * kBatch, lane, lo, hi, rl, rh, best, bj, all);
  }
}

// The warp's rows from `row` on, labels staged as int16: `lo` the labels
// (narrow) or their low halves, `hi` their high halves (wide).
template <bool kWide>
__device__ __forceinline__ void rows16(const bf16* sim, const int* lr, const unsigned short* lo,
                                       const unsigned short* hi, int r, int c, int* best_j,
                                       float* best_s, int row, Row<bf16>& w, First& f,
                                       uint4 (&a)[kVec], uint4 (&b)[kVec]) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  while (row < r) {
    const int lrow = f.lrow;
    float best = -INFINITY;
    int bj = c;
    bool masked = false;
    if (lrow >= 0) {
      // narrow: a row label past the int16 range as 0x8000, which no staged
      // label is (every negative one is staged as -1)
      const unsigned rl = (kWide ? lrow & 0xffff : lrow > 0x7fff ? 0x8000 : lrow) * 0x10001u;
      const unsigned rh = ((unsigned)lrow >> 16) * 0x10001u;
      unsigned all = ~0u;
      if (lane < w.head) take16(f.hv, label_at<kWide>(lo, hi, lane), lane, lrow, best, bj, masked);
      if (w.head == 0)
        row16<kWide, true>(w, a, b, lane, lo, hi, rl, rh, best, bj, all);
      else
        row16<kWide, false>(w, a, b, lane, lo, hi, rl, rh, best, bj, all);
      const int tail = w.head + 8 * w.nv + lane;
      if (tail < c) take16(f.tv, label_at<kWide>(lo, hi, tail), tail, lrow, best, bj, masked);
      masked |= all != ~0u;
    }
    const int cur = row;
    row += stride;
    if (row < r) {
      w = row_view(sim, row, c);
      f = fetch_first(a, w, lr, row, c, lane);
    }
    merge_and_write<true>(best, bj, lrow, masked, lane, cur, best_j, best_s);
  }
}

// A bf16 block of at most kMaxStaged16 columns. The block stages the
// labels as int16 (every negative one as -1) and learns while it stages
// whether every label fits (__syncthreads_or): then that copy serves; else
// they are its low halves and the block stages their high halves beside it
// (c <= kMaxStagedWide), or past that reads the int32 labels in global
// memory, column by column.
__global__ void __launch_bounds__(kThreads)
    best_edge_rows_bf16(const bf16* __restrict__ sim, const int* __restrict__ lr,
                        const int* __restrict__ lc, int r, int c, int* __restrict__ best_j,
                        float* __restrict__ best_s) {
  extern __shared__ __align__(16) unsigned short lab16[];
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;

  uint4 a[kVec], b[kVec];
  Row<bf16> w{};
  First f{};
  if (row < r) {
    w = row_view(sim, row, c);
    f = fetch_first(a, w, lr, row, c, lane);
  }
  // the labels as int16, and whether one is past the int16 range
  int wide = 0;
  const int nq = (reinterpret_cast<uintptr_t>(lc) & 15) == 0 ? c >> 2 : 0;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int4 l = __ldg(reinterpret_cast<const int4*>(lc) + q);
    wide |= max(max(l.x, l.y), max(l.z, l.w)) > 0x7fff;
    reinterpret_cast<uint2*>(lab16)[q] = {
        ((unsigned)max(l.x, -1) & 0xffffu) | (unsigned)max(l.y, -1) << 16,
        ((unsigned)max(l.z, -1) & 0xffffu) | (unsigned)max(l.w, -1) << 16};
  }
  for (int j = 4 * nq + threadIdx.x; j < c; j += kThreads) {
    const int l = __ldg(lc + j);
    wide |= l > 0x7fff;
    lab16[j] = (unsigned short)max(l, -1);
  }
  wide = __syncthreads_or(wide);
  // one is: their high halves beside them, where shared memory has room
  const bool room = c <= kMaxStagedWide;
  unsigned short* hi = lab16 + staged16_len(c);
  if (wide && room) {
    for (int j = threadIdx.x; j < c; j += kThreads)
      hi[j] = (unsigned short)((unsigned)max(__ldg(lc + j), -1) >> 16);
    __syncthreads();
  }
  if (!wide)
    rows16<false>(sim, lr, lab16, hi, r, c, best_j, best_s, row, w, f, a, b);
  else if (room)
    rows16<true>(sim, lr, lab16, hi, r, c, best_j, best_s, row, w, f, a, b);
  else
    rows_by_column(sim, lr, lc, r, c, best_j, best_s, row, w, f, a, b);
}

// Per device and element type: the SM count and the blocks an SM holds of
// each kernel (the staged one for the shared memory of the last c asked
// for).
struct Fit {
  int sms = 0, global_blocks = 0, staged_bytes = -1, staged_blocks = 0;
};
constexpr int kDevices = 32;
Fit fits[2][kDevices];        // [bf16]
unsigned smem_allowed[2] = {};  // [bf16]: repro::allow_smem's bit per device

// The kernel of a block whose labels shared memory holds: int32 labels for
// an f32 block, int16 for a bf16 one.
template <typename T>
auto staged_kernel() {
  if constexpr (sizeof(T) == 2) return best_edge_rows_bf16;
  else return best_edge_rows<true, T>;
}

template <typename T>
int blocks_per_sm(bool staged, int bytes, int& sms, int& blocks) {
  constexpr int kind = sizeof(T) == 2;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  Fit local;
  Fit& fit = dev < kDevices ? fits[kind][dev] : local;
  if (fit.sms == 0) {
    e = cudaDeviceGetAttribute(&fit.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit.global_blocks,
                                                        best_edge_rows<false, T>, kThreads, 0);
    if (e != cudaSuccess) {
      fit.sms = 0;
      return (int)e;
    }
  }
  if (staged && fit.staged_bytes != bytes) {
    const int err = repro::allow_smem(staged_kernel<T>(), kSmem, smem_allowed[kind]);
    if (err != 0) return err;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit.staged_blocks, staged_kernel<T>(),
                                                      kThreads, bytes);
    if (e != cudaSuccess) return (int)e;
    fit.staged_bytes = bytes;
  }
  sms = fit.sms;
  blocks = staged ? fit.staged_blocks : fit.global_blocks;
  return 0;
}

template <typename T>
int launch(const T* sim, const int* lr, const int* lc, int r, int c, int* best_j,
           float* best_s, cudaStream_t st) {
  constexpr bool half = sizeof(T) == 2;
  const bool staged = c <= (half ? kMaxStaged16 : kMaxStaged);
  const int bytes = !staged ? 0 : !half ? c * 4 : (c <= kMaxStagedWide ? 4 : 2) * staged16_len(c);
  int sms = 0, per_sm = 0;
  const int err = blocks_per_sm<T>(staged, bytes, sms, per_sm);
  if (err != 0) return err;
  // enough blocks an SM for the rows, the same number on every SM, and
  // never more blocks than rows
  const long long wave = (long long)sms * kWarps;
  const long long per = std::min<long long>((r + wave - 1) / wave, std::max(per_sm, 1));
  const int grid = (int)std::min<long long>(sms * per, r);
  const auto kernel = staged_kernel<T>();
  if (staged)
    kernel<<<grid, kThreads, bytes, st>>>(sim, lr, lc, r, c, best_j, best_s);
  else
    best_edge_rows<false, T><<<grid, kThreads, 0, st>>>(sim, lr, lc, r, c, best_j, best_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r > 0 and c > 0: the wrapper answers the empty cases without a launch.
// elem: the block's element type, kElemF32 or kElemBf16 (csrc/tma.cuh).
extern "C" int best_edge(const void* sim, int elem, const int* lr, const int* lc, int r,
                         int c, int* best_j, float* best_s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == repro::kElemF32)
    return launch(static_cast<const float*>(sim), lr, lc, r, c, best_j, best_s, st);
  if (elem == repro::kElemBf16)
    return launch(static_cast<const bf16*>(sim), lr, lc, r, c, best_j, best_s, st);
  return (int)cudaErrorInvalidValue;
}
