// Pipelined fp32 product tile shared by assign_tile.cuh (assign_argmax,
// assign_stats' launch 1), assign_stats_bounded.cu and sim_best_edge.cu.
//
// A block is one producer warp and W consumer warps. The producer fills a
// ring of stages in shared memory, each stage 32 columns of d (one 128-byte
// row a staged row) of up to two row blocks: x's rows, and center rows (a
// tile of a row-major matrix, or rows gathered by id). It copies with the
// copy engine (TMA: one 2-D box a row block, 128-byte swizzle) where the
// matrix has a 16-byte row stride and base, and otherwise with 4-byte
// asynchronous copies written to the same swizzled places; gathered rows go
// by 16-byte (or 4-byte) asynchronous copies. A stage's arrival is one
// mbarrier phase (bytes from the copy engine, one arrival a producer lane
// once its own copies have landed); consumers free a stage on a second
// mbarrier. The ring runs on across sweeps: producer and consumers count
// stages the same way, so a block may sweep d several times in a row.
//
// Swizzle: the 16-byte chunk c (4 columns) of staged row r sits at chunk
// c ^ (r % 8) of that row, so the 8 rows read by a quarter-warp at one chunk
// fall on 8 different bank groups. Each consumer thread holds an 8 x JN
// sub-tile of results: rows ty + kTy * i, columns tx + kTx * j, and reads
// each row's 4 consecutive columns of d as one float4. Rows ty + kTy * i
// share ty % 8, so one XOR serves all of a thread's rows.
//
// Every result is ONE fp32 register updated by fmaf over k = 0 .. d-1 in
// order (the float4's four columns are applied one after another, chunks
// and stages ascend): no split-k, no TF32, no tensor cores. So a result
// does not depend on the tile shape, the kernels built on the tile agree bit
// for bit, and because fmaf(a, b, c) == fmaf(b, a, c) the (i, j) and (j, i)
// entries of xs . xs^T are bit-identical: the Borůvka search sees a
// symmetric similarity. Pads (rows past the matrix, columns past d) arrive
// as zeros and add nothing.
#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace repro {

constexpr float kNeg = -FLT_MAX;

// (value desc, index asc) winner of two candidates; index -1 (no
// candidate) never wins a tie.
__device__ __forceinline__ bool beats(float v, int j, float bv, int bj) {
  return v > bv || (v == bv && (unsigned)j < (unsigned)bj);
}

// Reduce a per-thread (best value, best index) over the kN lanes whose ids
// differ only in the bits kLo .. kLo * kN / 2 (<1, 8>: 8 consecutive lanes,
// a tile row's threads in one warp): every one ends with the winner.
template <int kLo, int kN>
__device__ __forceinline__ void lanes_argmax(float& best, int& bj) {
#pragma unroll
  for (int off = kLo * kN / 2; off >= kLo; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (beats(ov, oj, best, bj)) {
      best = ov;
      bj = oj;
    }
  }
}

constexpr int kPipeK = 32;                      // columns of d a stage
constexpr int kPipeRowBytes = kPipeK * 4;       // one swizzle row
constexpr int kPipeRows = 128;                  // rows of x a stage
constexpr int kPipeBlock = kPipeRows * kPipeRowBytes;  // 16 KB: 128 staged rows
constexpr int kPipeStage = 2 * kPipeBlock;      // x rows, then center rows
constexpr int kPipeAlign = 1024;                // the swizzle repeats every 8 rows

// Offset (floats) of element (r, c) of a staged block.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kPipeK + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// Barrier among the consumer warps only (barrier 0 is the whole block's).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// ------------------------------------------------------------ the producer

// One row block of a stage: rows [row0, row0 + nrows) x columns
// [k0, k0 + 32) of a row-major (rows, d) matrix. With a tensor map, lane 0
// asks the copy engine for the box (its bytes are expected by the caller);
// otherwise the warp copies 4 bytes a lane, zeros outside the matrix.
__device__ __forceinline__ void pipe_load(float* dst, const CUtensorMap* map,
                                          const float* __restrict__ src, int rows,
                                          int d, int row0, int k0, int nrows,
                                          uint64_t* bar, int lane) {
  if (map != nullptr) {
    if (lane == 0) tma_load_2d(dst, map, k0, row0, bar);
    return;
  }
  const int col = k0 + lane;
  for (int r = 0; r < nrows; ++r) {
    const int gr = row0 + r;
    const bool in = gr < rows && col < d;
    cp_async4(dst + swz(r, lane), src + (in ? (size_t)gr * d + col : 0), in ? 4 : 0);
  }
}

// Rows ids[0 .. 127] of a (rows, d) matrix, columns [k0, k0 + 32), into a
// staged block; a row whose id is negative is not copied (its place is left
// as it is: the consumers do not read it). vec16: 16-byte copies (d % 4 == 0
// and a 16-byte-aligned base), else 4-byte ones.
__device__ __forceinline__ void pipe_gather(float* dst, const float* __restrict__ src,
                                            const int* ids, int d, int k0, bool vec16,
                                            int lane) {
  if (vec16) {
    for (int e = lane; e < kPipeRows * 8; e += 32) {
      const int r = e >> 3, c = (e & 7) << 2;
      const int p = ids[r];
      if (p < 0) continue;
      const bool in = k0 + c < d;
      cp_async16(dst + swz(r, c), src + (in ? (size_t)p * d + k0 + c : 0), in ? 16 : 0);
    }
    return;
  }
  const int col = k0 + lane;
  for (int r = 0; r < kPipeRows; ++r) {
    const int p = ids[r];
    if (p < 0) continue;
    const bool in = col < d;
    cp_async4(dst + swz(r, lane), src + (in ? (size_t)p * d + col : 0), in ? 4 : 0);
  }
}

// ----------------------------------------------------------- the consumers

// Where a consumer thread sits: kTy x kTx threads, warps of 4 x 8 lanes; a
// quarter-warp's 8 lanes share ty (so their row reads are one broadcast)
// and hold 8 consecutive tx (so their column reads hit 8 bank groups).
template <int kTy, int kTx>
struct PipeThread {
  static_assert(kTy % 8 == 0 && kTx % 8 == 0, "rows and columns step by multiples of 8");
  static constexpr int kWarpsX = kTx / 8;
  static constexpr int kThreads = kTy * kTx;
  int ty, tx, wc;
  __device__ __forceinline__ explicit PipeThread(int t) {
    const int w = t >> 5, lane = t & 31;
    wc = w % kWarpsX;
    ty = (w / kWarpsX) * 4 + (lane >> 3);
    tx = wc * 8 + (lane & 7);
  }
};

// acc[i][j] += A[ty + kTy*i] . B[tx + kTx*j] over one stage's 32 columns,
// column by column (a and b are staged blocks).
template <int kTy, int kTx, int JN>
__device__ __forceinline__ void pipe_fma(const float* a, const float* b, int ty, int tx,
                                         float (&acc)[8][JN]) {
  const float* ap = a + ty * kPipeK;
  const float* bp = b + tx * kPipeK;
  const int sa = ty & 7, sb = tx & 7;
#pragma unroll
  for (int kc = 0; kc < kPipeK / 4; ++kc) {
    float4 av[8], bv[JN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(ap + i * kTy * kPipeK + ((kc ^ sa) << 2));
#pragma unroll
    for (int j = 0; j < JN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(bp + j * kTx * kPipeK + ((kc ^ sb) << 2));
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
  }
}

// Staged row r's squared norm over one stage, and with DOT its product
// with staged row r of g: the fmaf chains of pipe_fma.
template <bool DOT>
__device__ __forceinline__ void pipe_row(const float* a, const float* g, int r, float& sq,
                                         float& dot) {
#pragma unroll
  for (int kc = 0; kc < kPipeK / 4; ++kc) {
    const int off = r * kPipeK + ((kc ^ (r & 7)) << 2);
    const float4 v = *reinterpret_cast<const float4*>(a + off);
    sq = fmaf(v.x, v.x, sq);
    sq = fmaf(v.y, v.y, sq);
    sq = fmaf(v.z, v.z, sq);
    sq = fmaf(v.w, v.w, sq);
    if (DOT) {
      const float4 c = *reinterpret_cast<const float4*>(g + off);
      dot = fmaf(v.x, c.x, dot);
      dot = fmaf(v.y, c.y, dot);
      dot = fmaf(v.z, c.z, dot);
      dot = fmaf(v.w, c.w, dot);
    }
  }
}

// The smallest JN in {1, 2, 4, 8} whose columns tx + kTx*j, j < JN, cover
// `width` columns of a tile.
template <int kTx>
__host__ __device__ __forceinline__ int pipe_jn(int width) {
  return width <= kTx ? 1 : width <= 2 * kTx ? 2 : width <= 4 * kTx ? 4 : 8;
}

// Ring bookkeeping shared by both roles: stage i of the block's life sits in
// slot i % stages and is that slot's phase i / stages.
struct PipeRing {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  __device__ __forceinline__ float* block(int i, int half) const {
    return reinterpret_cast<float*>(base + (i % stages) * kPipeStage + half * kPipeBlock);
  }
  __device__ __forceinline__ uint32_t parity(int i) const { return (i / stages) & 1; }
  __device__ __forceinline__ uint64_t* full_of(int i) const { return &full[i % stages]; }
  __device__ __forceinline__ uint64_t* empty_of(int i) const { return &empty[i % stages]; }
};

// Carve `stages` stages (1024-byte aligned) and their barriers out of the
// dynamic shared memory; returns the first byte after them.
__device__ __forceinline__ unsigned char* pipe_ring(unsigned char* raw, int stages,
                                                    PipeRing& ring) {
  // aligned by an offset from raw, not through an integer, so the compiler
  // keeps every access a shared-memory one (LDS/STS, not generic)
  ring.base = raw + ((kPipeAlign - (smem_addr(raw) & (kPipeAlign - 1))) & (kPipeAlign - 1));
  ring.full = reinterpret_cast<uint64_t*>(ring.base + stages * kPipeStage);
  ring.empty = ring.full + stages;
  ring.stages = stages;
  return reinterpret_cast<unsigned char*>(ring.empty + stages);
}

// Thread 0: the barriers (full: the producer's 32 lanes; empty: one arrival
// a consumer warp). The caller synchronises the block after.
__device__ __forceinline__ void pipe_ring_init(const PipeRing& ring, int consumer_warps) {
  for (int s = 0; s < ring.stages; ++s) {
    mbar_init(&ring.full[s], 32);
    mbar_init(&ring.empty[s], consumer_warps);
  }
  mbar_fence_init();
}

// Producer: wait until stage i's slot is free; lane 0 announces `tx_bytes`
// from the copy engine.
__device__ __forceinline__ void pipe_acquire(const PipeRing& ring, int i, uint32_t tx_bytes,
                                             int lane) {
  mbar_wait(ring.empty_of(i), ring.parity(i) ^ 1);
  if (lane == 0 && tx_bytes) mbar_expect_tx(ring.full_of(i), tx_bytes);
}

// Producer: stage i is issued; each lane arrives once its copies land.
__device__ __forceinline__ void pipe_commit(const PipeRing& ring, int i) {
  cp_async_arrive(ring.full_of(i));
}

// Producer, last: wait until the consumers have freed the last stages, so
// no copy of this warp is in flight when it exits.
__device__ __forceinline__ void pipe_drain(const PipeRing& ring, int total) {
  for (int i = total > ring.stages ? total - ring.stages : 0; i < total; ++i)
    mbar_wait(ring.empty_of(i), ring.parity(i));
}

// Consumer: wait for stage i / free it (one arrival a warp).
__device__ __forceinline__ void pipe_wait(const PipeRing& ring, int i) {
  mbar_wait(ring.full_of(i), ring.parity(i));
}

__device__ __forceinline__ void pipe_release(const PipeRing& ring, int i, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(ring.empty_of(i));
}

// Host: a tensor map of a row-major (rows, d) f32 matrix in boxes of
// `box_rows` x 32 with the 128-byte swizzle. Returns false (and leaves the
// matrix to the producer's 4-byte copies) where the copy engine cannot take
// it: a row stride or base that is not a multiple of 16 bytes, or rows
// narrower than a box; *err is a CUDA error if the map could not be made.
inline bool pipe_map(CUtensorMap* map, const float* base, int rows, int d, int box_rows,
                     int* err) {
  *err = 0;
  if (d % 4 != 0 || d < kPipeK || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kPipeK, (cuuint32_t)box_rows};
  *err = make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  return *err == 0;
}

}  // namespace repro
