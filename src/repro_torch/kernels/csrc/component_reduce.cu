// component_best_edge: per dense component id, the (w desc, row asc) best of
// a shard's per-row Borůvka candidates; the combiner of distributed Borůvka.
//
// Replaces the TPU kernel src/repro/kernels/component_reduce.py
// (component_best_edge_pallas, body _kernel). Contract of
// ref.component_best_edge: (c,) best_w / best_row / best_j; an empty segment
// gets (f32.min, BIG_I, -1); rows whose id lies outside [0, c) (pad rows,
// tagged -1 or c) fall into no segment; row ids are unique within a call.
// Distributed Borůvka launches it twice per round under the sharded sweep
// (the column, then the target component as payload) and once per round
// from round 1 on under the replicated sweep or the point-level merge.
//
// What bounds it on an H100: bytes, and in practice launch latency. Each row
// is read once (w, column, row id, component: 16 B) and each segment written
// once (12 B); at the main path's r = 3,536 rows and c = 1,768 segments
// (round 1) that is 78 KB, ~23 ns at 3.35 TB/s, far below the few
// microseconds of the three launches.
//
// What the design does about it: no (segments x rows) membership matrices as
// in the Pallas kernel, which kept them in VMEM. Each candidate becomes one
// 64-bit key that orders (w desc, row asc): the high word is an
// order-preserving map of w's bits (-0.0 mapped as +0.0, since the reference
// compares with == and >), the low word BIG_I - row. Launch 1 fills the
// outputs with the empty sentinel and the keys with 0, which loses to any
// real row (f32.min included). Launch 2 takes one integer atomicMax per row
// into its segment's key. Launch 3 lets the row whose key equals its
// segment's key write w, row and column from its own values, so w keeps the
// row's bits, -0.0 included. atomicMax on unsigned long long is a max over a
// total order: its result does not depend on the order the rows arrive in,
// so every run gives the same bits, unlike an fp32 atomic add, whose sum
// depends on that order.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kBigI = 0x7fffffff;
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long pack_key(float w, int row) {
  // -0.0 == +0.0 under the reference's comparisons, so both rank as +0.0
  unsigned int u = __float_as_uint(w == 0.0f ? 0.0f : w);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // order-preserving
  const unsigned int lo =
      static_cast<unsigned int>(static_cast<long long>(kBigI) - row);
  return (static_cast<unsigned long long>(u) << 32) | lo;
}

__global__ void fill(int c, unsigned long long* key, float* best_w,
                     int* best_row, int* best_j) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= c) return;
  key[s] = 0ull;
  best_w[s] = -FLT_MAX;
  best_row[s] = kBigI;
  best_j[s] = -1;
}

__global__ void claim(const float* w, const int* rows, const int* comp, int r,
                      int c, unsigned long long* key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  const int s = comp[i];
  if (s < 0 || s >= c) return;
  atomicMax(&key[s], pack_key(w[i], rows[i]));
}

__global__ void write_winner(const float* w, const int* col, const int* rows,
                             const int* comp, int r, int c,
                             const unsigned long long* key, float* best_w,
                             int* best_row, int* best_j) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  const int s = comp[i];
  if (s < 0 || s >= c) return;
  const float wi = w[i];
  const int row = rows[i];
  if (key[s] != pack_key(wi, row)) return;
  best_w[s] = wi;
  best_row[s] = row;
  best_j[s] = col[i];
}

}  // namespace

extern "C" int component_best_edge(const float* w, const int* col,
                                   const int* rows, const int* comp, int r,
                                   int c, unsigned long long* key,
                                   float* best_w, int* best_row, int* best_j,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c > 0) {
    fill<<<(c + kThreads - 1) / kThreads, kThreads, 0, st>>>(c, key, best_w,
                                                            best_row, best_j);
    if (r > 0) {
      const int blocks = (r + kThreads - 1) / kThreads;
      claim<<<blocks, kThreads, 0, st>>>(w, rows, comp, r, c, key);
      write_winner<<<blocks, kThreads, 0, st>>>(w, col, rows, comp, r, c, key,
                                                best_w, best_row, best_j);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
