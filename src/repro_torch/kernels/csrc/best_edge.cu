// best_edge: per row of an already-built similarity block, the best column
// in another component.
//
// Replaces the TPU kernel src/repro/kernels/best_edge.py (best_edge_pallas,
// body _kernel). Contract of ref.best_edge: a column is a candidate iff
// lr != lc && lr >= 0 && lc >= 0; every other column counts as f32.min; the
// row maximum goes to the lowest column on ties (-0.0 and +0.0 compare
// equal); a row whose maximum is f32.min gets (-1, f32.min).
//
// What bounds it on an H100: bytes. The kernel only compares values: it
// reads the (r, c) block once (r*c*4 bytes; 16 MB at 2,000 x 2,000, 50 MB at
// the main path's 3,536 x 3,536, a bound of 4.8 and 14.9 us at 3.35 TB/s)
// and does no arithmetic, so its result is exact whatever order it visits
// the columns in.
//
// What the design does about it: the Pallas kernel carried (max, argmax)
// across column tiles in grid order. Here rows are independent, so one warp
// owns one row: its lanes walk the row 32 consecutive floats at a time (one
// 128-byte load per warp), eight loads in flight per lane, each lane keeping
// a running (max, lowest column) under the (value desc, column asc) order,
// and a shuffle reduction under the same order picks the row's winner. The
// order is total, so the visiting order does not matter and two runs give
// the same bits. NaN ranks above every number, as in torch.max/argmax.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // rows per block
constexpr int kUnroll = 8;  // loads in flight per lane
constexpr float kNeg = -FLT_MAX;

// (value desc, column asc) winner of two candidates, with NaN above every
// number and the first NaN winning, as torch.amax/argmax rank them.
__device__ __forceinline__ bool beats(float v, int j, float bv, int bj) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || j < bj);
  return v > bv || (v == bv && j < bj);
}

__global__ void __launch_bounds__(kWarps * 32)
    best_edge_rows(const float* __restrict__ sim, const int* __restrict__ lr,
                   const int* __restrict__ lc, int r, int c,
                   int* __restrict__ best_j, float* __restrict__ best_s) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= r) return;
  const int lrow = lr[row];
  const float* srow = sim + (size_t)row * c;
  // -inf at column c loses to every column, f32.min included
  float best = -INFINITY;
  int bj = c;
  for (int j0 = lane; j0 < c; j0 += 32 * kUnroll) {
    float v[kUnroll];
    int l[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + 32 * u;
      v[u] = j < c ? __ldg(srow + j) : -INFINITY;
      l[u] = j < c ? __ldg(lc + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + 32 * u;
      if (j >= c) break;
      const bool keep = lrow >= 0 && l[u] >= 0 && lrow != l[u];
      const float m = keep ? v[u] : kNeg;
      if (beats(m, j, best, bj)) {
        best = m;
        bj = j;
      }
    }
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
    best_s[row] = best;
    best_j[row] = best == kNeg ? -1 : bj;
  }
}

}  // namespace

// r > 0 and c > 0: the wrapper answers the empty cases without a launch.
extern "C" int best_edge(const float* sim, const int* lr, const int* lc, int r,
                         int c, int* best_j, float* best_s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  best_edge_rows<<<(r + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      sim, lr, lc, r, c, best_j, best_s);
  return static_cast<int>(cudaGetLastError());
}
