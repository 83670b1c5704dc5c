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
// What bounds it on an H100: bytes, and in practice the host's time to
// launch it. Each row is read once (w, column, row id, component: 16 B) and
// each segment written once (12 B); at the main path's r = 3,536 rows and
// c = 1,768 segments (round 1) that is 78 KB, ~23 ns at 3.35 TB/s, far below
// the few microseconds a launch costs.
//
// What the design does about it: no (segments x rows) membership matrices as
// in the Pallas kernel, which kept them in VMEM, and one launch. Each
// candidate becomes one 64-bit key that orders (w desc, row asc): the high
// word is an order-preserving map of w's bits (-0.0 mapped as +0.0, since
// the reference compares with == and >), the low word BIG_I - row. A key of
// 0 loses to any real row (f32.min included). Every row takes one integer
// atomicMax into its segment's key; after a barrier the row whose key equals
// its segment's key writes w, row and column from its own values, so w keeps
// the row's bits, -0.0 included, and a segment whose key is still 0 gets the
// empty sentinel. atomicMax on unsigned long long is a max over a total
// order: its result does not depend on the order the rows arrive in, so
// every run gives the same bits, unlike an fp32 atomic add, whose sum
// depends on that order.
//
// Two grids, chosen on the host from (r, c):
//  - one block of 1,024 threads where the keys fit in its shared memory
//    (c <= 28,672, 224 KB) and its threads can hold every row in registers
//    (r <= 8,192): the keys are zeroed in shared memory, the barrier is
//    __syncthreads(), and nothing is left behind. The main path's caps
//    (1,768 in round 1) all take it.
//  - otherwise a cooperative grid (every block resident at once) over keys
//    in device memory, with one grid-wide barrier between the claims and the
//    winners. The keys must be zero at the start, and no launch of its own
//    clears them: the wrapper keeps two key buffers a device and alternates
//    them, and each call zeroes the other buffer (the previous call's keys,
//    finished since: calls on one stream run in order) while it claims.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kBigI = 0x7fffffff;
constexpr int kBlockThreads = 1024;  // the one-block grid
constexpr int kBlockRows = 8;        // rows a thread of it holds
constexpr int kBlockKeys = 28672;    // keys in its shared memory (224 KB)
constexpr int kGridThreads = 256;    // a block of the cooperative grid

__device__ __forceinline__ unsigned long long pack_key(float w, int row) {
  // -0.0 == +0.0 under the reference's comparisons, so both rank as +0.0
  unsigned int u = __float_as_uint(w == 0.0f ? 0.0f : w);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // order-preserving
  const unsigned int lo = static_cast<unsigned int>(static_cast<long long>(kBigI) - row);
  return (static_cast<unsigned long long>(u) << 32) | lo;
}

__device__ __forceinline__ void write_empty(int s, float* best_w, int* best_row, int* best_j) {
  best_w[s] = -FLT_MAX;
  best_row[s] = kBigI;
  best_j[s] = -1;
}

__global__ void __launch_bounds__(kBlockThreads, 1)
    cbe_block(const float* __restrict__ w, const int* __restrict__ col,
              const int* __restrict__ rows, const int* __restrict__ comp, int r, int c,
              float* __restrict__ best_w, int* __restrict__ best_row,
              int* __restrict__ best_j) {
  extern __shared__ unsigned long long key[];
  const int t = threadIdx.x;
  for (int s = t; s < c; s += kBlockThreads) key[s] = 0ull;
  float wi[kBlockRows];
  int seg[kBlockRows], row[kBlockRows];
#pragma unroll
  for (int k = 0; k < kBlockRows; ++k) {  // rows t, t + 1024, ...: coalesced
    const int i = t + k * kBlockThreads;
    seg[k] = -1;
    wi[k] = 0.f;
    row[k] = 0;
    if (i < r) {
      const int s = comp[i];
      seg[k] = s >= 0 && s < c ? s : -1;
      wi[k] = w[i];
      row[k] = rows[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kBlockRows; ++k)
    if (seg[k] >= 0) atomicMax(&key[seg[k]], pack_key(wi[k], row[k]));
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kBlockRows; ++k) {
    if (seg[k] >= 0 && key[seg[k]] == pack_key(wi[k], row[k])) {
      best_w[seg[k]] = wi[k];
      best_row[seg[k]] = row[k];
      best_j[seg[k]] = col[t + k * kBlockThreads];
    }
  }
  for (int s = t; s < c; s += kBlockThreads)
    if (key[s] == 0ull) write_empty(s, best_w, best_row, best_j);
}

// Every block of the (cooperative) grid waits here until all have arrived.
// bar[0] counts arrivals and wraps to 0 on the last (atomicInc); bar[1] is
// the generation, which the last arrival moves on. A block reads the
// generation before it arrives, so it cannot miss the move.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicInc(bar, gridDim.x - 1) == gridDim.x - 1) {
      atomicInc(bar + 1, 0xffffffffu);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kGridThreads)
    cbe_grid(const float* __restrict__ w, const int* __restrict__ col,
             const int* __restrict__ rows, const int* __restrict__ comp, int r, int c,
             unsigned long long* key, unsigned long long* spare, int spare_n,
             unsigned* bar, float* __restrict__ best_w, int* __restrict__ best_row,
             int* __restrict__ best_j) {
  const int stride = gridDim.x * kGridThreads;
  const int t0 = blockIdx.x * kGridThreads + threadIdx.x;
  for (int s = t0; s < spare_n; s += stride) spare[s] = 0ull;  // the next call's keys
  for (int i = t0; i < r; i += stride) {
    const int s = comp[i];
    if (s >= 0 && s < c) atomicMax(&key[s], pack_key(w[i], rows[i]));
  }
  grid_barrier(bar);
  for (int i = t0; i < r; i += stride) {
    const int s = comp[i];
    if (s < 0 || s >= c) continue;
    const float wi = w[i];
    const int ri = rows[i];
    if (__ldcg(&key[s]) != pack_key(wi, ri)) continue;  // from L2: the atomics' values
    best_w[s] = wi;
    best_row[s] = ri;
    best_j[s] = col[i];
  }
  for (int s = t0; s < c; s += stride)
    if (__ldcg(&key[s]) == 0ull) write_empty(s, best_w, best_row, best_j);
}

unsigned block_smem_set = 0;  // devices whose shared-memory limit is raised
int grid_blocks[32] = {0};    // per device: blocks of cbe_grid resident at once

}  // namespace

// The one-block grid's limits: the wrapper takes it for c <= keys and
// r <= rows, and hands the cooperative grid its key buffers otherwise.
extern "C" int component_best_edge_block_keys() { return kBlockKeys; }
extern "C" int component_best_edge_block_rows() { return kBlockThreads * kBlockRows; }

// out: 3 * c int32, best_w (as f32 bits), best_row, best_j one after another.
extern "C" int component_best_edge_block(const float* w, const int* col, const int* rows,
                                         const int* comp, int r, int c, int* out,
                                         void* stream) {
  if (c <= 0) return 0;
  if (c > kBlockKeys || r > kBlockThreads * kBlockRows) return (int)cudaErrorInvalidValue;
  const int smem = c * (int)sizeof(unsigned long long);
  if (smem > 48 * 1024) {  // past 48 KB the limit is raised once a device
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 32 || !(block_smem_set >> dev & 1u)) {
      const cudaError_t e = cudaFuncSetAttribute(
          cbe_block, cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockKeys * 8);
      if (e != cudaSuccess) return (int)e;
      if (dev < 32) block_smem_set |= 1u << dev;
    }
  }
  cbe_block<<<1, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, col, rows, comp, r, c, reinterpret_cast<float*>(out), out + c, out + 2 * c);
  return (int)cudaGetLastError();
}

// key: c zeroed keys; spare: the other buffer, whose first spare_n keys this
// call zeroes; bar: 2 unsigned ints, zero before the first call.
extern "C" int component_best_edge_grid(const float* w, const int* col, const int* rows,
                                        const int* comp, int r, int c, int* out,
                                        unsigned long long* key, unsigned long long* spare,
                                        int spare_n, unsigned* bar, void* stream) {
  if (c <= 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (grid_blocks[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cbe_grid, kGridThreads, 0);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    grid_blocks[dev] = per_sm * sms;
  }
  const int work = r > c ? r : c;
  int blocks = (work + kGridThreads - 1) / kGridThreads;
  if (blocks > grid_blocks[dev]) blocks = grid_blocks[dev];
  if (blocks < 1) blocks = 1;
  float* best_w = reinterpret_cast<float*>(out);
  int* best_row = out + c;
  int* best_j = out + 2 * c;
  void* args[] = {&w, &col, &rows, &comp, &r, &c, &key, &spare, &spare_n,
                  &bar, &best_w, &best_row, &best_j};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cbe_grid), dim3(blocks),
                                  dim3(kGridThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
