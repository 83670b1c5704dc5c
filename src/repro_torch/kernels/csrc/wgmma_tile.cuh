// The bf16 product tile on Hopper's tensor cores (wgmma), shared by
// sim_best_edge.cu and assign_tile.cuh (assign_stats' launch 1) for bf16
// document rows. It keeps the roles and barriers of assign_pipe.cuh's ring
// (one producer warp, 8 consumer warps, a full and an empty mbarrier a
// stage) with its own stages and consumers.
//
// Contract. The JAX kernels multiply bf16 operands on the matrix unit and
// sum in f32 (preferred_element_type=jnp.float32). So does this tile:
// wgmma.mma_async.m64nNk16.f32.bf16.bf16 forms every product of two bf16
// values exactly and sums them in f32 in the tensor cores' order, which is
// not the fmaf chain's and is not promised to round to nearest. So a bf16
// result is not bit-equal to the f32 mode on the upcast rows: it is equal
// wherever every product and partial sum is exact in f32 (integer-valued
// rows), and within 1e-5 of it on unit rows (tests/test_torch_gpu.py's
// bf16 gates, chip_smoke.py's phase 2). The f32 mode keeps its fmaf chains
// (assign_pipe.cuh) and every bit.
//
// Accumulation. The tensor cores add each k16 step's 16 products into the
// accumulator with their own alignment and rounding. Each stage's products
// go into a fresh accumulator (scale_d = 0 on the stage's first product),
// which the consumers add into an f32 register sum on the CUDA cores (round
// to nearest) once they have landed: the tensor cores sum 64 columns of d,
// the CUDA cores the 32 stages of d = 2,048, for N / 2 FADD a thread a
// stage. On dense unit rows at d = 2,048 this sum's largest error against
// the exact (f64) similarity read 3.2e-8, against 3.1e-7 for a one-off
// build that left all of d to the tensor cores (PERF.md section 6): both
// far inside the 1e-5 gate, and the FADDs hide under the stage's products.
//
// Stage layout. A staged row is 64 bf16 columns in 128 bytes (an L2 line),
// under the copy engine's 128-byte swizzle: 16-byte chunk c of row r at
// chunk c ^ (r % 8), which is wgmma's K-major B128 layout (an atom of 8
// rows, 1,024 bytes). So a descriptor reads a staged block as it lies:
// start address the block's (1,024-byte aligned), leading offset unused
// (1), stride offset 1,024 bytes between 8-row groups, the k16 steps of a
// stage 32 bytes apart. Rows the copy engine cannot take (d % 8 != 0, a
// base off 16 bytes, d < 64) go by plain 2-byte loads and stores to the
// same places (wg_load), fenced into the async proxy before the producer
// arrives (wg_publish). Pads (rows past the matrix, columns past d) arrive
// as zeros and add nothing. A stage (WgRing) is x's 128 rows, then P B
// blocks of as many rows as the tile computes columns: sim_best_edge 6
// stages of 32 KB; assign_stats at k = 50 (64 columns) 8 stages of 24 KB
// with bf16 centers, 5 of 40 KB with the three parts of split f32 centers.
//
// Roles. Consumer warpgroup g (warps 4g .. 4g + 3) computes tile rows
// 64g .. 64g + 63 against all N columns of the B blocks; warp 8 produces.
// Each stage's products are waited for before the stage is freed; the
// other warpgroup's products keep the tensor cores busy meanwhile.
//
// Accumulator fragment (m64nN, f32): thread t of the warpgroup (warp
// w = t / 32 % 4, lane l) holds element 4j + 2h + e (j < N / 8, h, e < 2)
// = row 16w + l / 4 + 8h, column 8j + 2 (l % 4) + e. A row's N columns sit
// in the 4 lanes of one quad (l / 4 equal); a column's 64 rows in the 8
// lanes with equal l % 4 of each of the 4 warps. Every index into the
// fragment is a compile-time constant (unrolled loops).
//
// What bounds the bf16 rows on an H100: at sim_best_edge's s = 3,536,
// d = 2,048 the self-search is 25.6 GFLOP of tensor-core work (0.026 ms at
// 989 TFLOP/s) on 14.5 MB, but a 128 x 128 tile reads 1 MB of the L2-held
// sample per 67 MFLOP, so the L2's rate into the SMs sets the pace; at
// assign_stats' n = 250,000, k = 50 the read of 1.02 GB of bf16 x (0.31 ms
// at 3.35 TB/s) does, with f32 centers' three products a column (0.16 ms of
// tensor-core work) and their parts read from L2 beside it.
#pragma once

#include "assign_pipe.cuh"

namespace repro {

constexpr int kWgCols = 64;                        // columns of d a stage
constexpr int kWgRowBytes = kWgCols * 2;           // a staged bf16 row: 128 bytes
constexpr int kWgBlock = kPipeRows * kWgRowBytes;  // 16 KB: 128 staged rows
constexpr int kWgSteps = kWgCols / 16;             // k16 steps a stage

// The ring of the bf16 tile: stages of the x block (128 rows) and P B
// blocks of BR rows, laid out one after another (every block 1,024-byte
// aligned).
template <int P, int BR = kPipeRows>
struct WgRing : PipeRing {
  static constexpr int kB = BR * kWgRowBytes;  // a B block
  static constexpr int kStage = kWgBlock + P * kB;
  // block b (0: x, 1..P: B blocks) of stage i
  __device__ __forceinline__ unsigned char* blk(int i, int b) const {
    return base + (i % stages) * kStage + (b ? kWgBlock + (b - 1) * kB : 0);
  }
  // stage i's x block and its B region (wg_sweep's view of a ring)
  __device__ __forceinline__ unsigned char* xblk(int i) const { return blk(i, 0); }
  __device__ __forceinline__ unsigned char* bblk(int i) const { return blk(i, 1); }
};

// Row stride (elements) of the split centers' parts, (3, k, stride) bf16:
// d padded to a multiple of 8 (16-byte rows, which the copy engine takes)
// and to at least one stage's kWgCols columns; the pad columns are zeros.
// kernels/assign_stats.py's split_stride is the same.
__host__ __device__ constexpr int split_stride(int d) {
  return d < kWgCols ? kWgCols : (d + 7) / 8 * 8;
}

// Dynamic shared memory of a Ring of `stages` stages and its barriers.
template <typename Ring>
constexpr int wg_ring_bytes(int stages) {
  return kPipeAlign + stages * (Ring::kStage + 16);
}

// Carve the ring (1024-byte aligned, as pipe_ring) and its barriers out of
// the dynamic shared memory; returns the first byte after them.
template <typename Ring>
__device__ __forceinline__ unsigned char* wg_ring(unsigned char* raw, int stages, Ring& ring) {
  ring.base = raw + ((kPipeAlign - (smem_addr(raw) & (kPipeAlign - 1))) & (kPipeAlign - 1));
  ring.full = reinterpret_cast<uint64_t*>(ring.base + stages * Ring::kStage);
  ring.empty = ring.full + stages;
  ring.stages = stages;
  return reinterpret_cast<unsigned char*>(ring.empty + stages);
}

// Offset (elements) of element (r, c) of a staged block: the 16-byte chunk
// c / 8 of staged row r sits at chunk (c / 8) ^ (r % 8), the copy engine's
// 128-byte swizzle.
__device__ __forceinline__ int wg_at(int r, int c) {
  return r * kWgCols + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// The shared-memory matrix descriptor of a K-major bf16 block starting at
// `p`: the B128 layout, 1,024 bytes (8 staged rows) between 8-row groups.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(8 * kWgRowBytes >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of the accumulator across the
// asynchronous products' issue and wait.
template <int M>
__device__ __forceinline__ void wg_fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ------------------------------------------------------------ the producer

// Host: a tensor map of a row-major (rows, d) bf16 matrix in boxes of
// `box_rows` x kWgCols with the 128-byte swizzle. False (the producer's
// plain stores then) where the copy engine cannot take it: a row stride or
// base off 16 bytes, or rows narrower than a box.
inline bool wg_map(CUtensorMap* map, const bf16* base, int rows, int d, int box_rows,
                   int* err) {
  *err = 0;
  if (d % 8 != 0 || d < kWgCols || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kWgCols, (cuuint32_t)box_rows};
  *err = make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  return *err == 0;
}

// One block of a stage: rows [row0, row0 + nrows) x columns [k0, k0 +
// kWgCols) of a row-major (rows, d) bf16 matrix. With a tensor map lane 0
// asks the copy engine for the box (the caller expects its bytes);
// otherwise the warp copies with plain 2-byte loads and stores, zeros
// outside the matrix, into the same swizzled places (a row of odd d starts
// on a 2-byte boundary, which no asynchronous copy takes).
__device__ __forceinline__ void wg_load(unsigned char* dst, const CUtensorMap* map,
                                        const bf16* __restrict__ src, int rows, int d, int row0,
                                        int k0, int nrows, uint64_t* bar, int lane) {
  if (map != nullptr) {
    if (lane == 0) tma_load_2d(dst, map, k0, row0, bar);
    return;
  }
  const unsigned short* bits = reinterpret_cast<const unsigned short*>(src);
  unsigned short* out = reinterpret_cast<unsigned short*>(dst);
#pragma unroll 4
  for (int r = 0; r < nrows; ++r) {
    const int gr = row0 + r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * 32 + lane, col = k0 + c;
      out[wg_at(r, c)] = gr < rows && col < d ? bits[(size_t)gr * d + col] : 0;
    }
  }
}

// A producer lane's share of a gather of 128 rows by id into a staged
// block: chunk lane % 8 (8 columns, 16 bytes) of rows lane / 8 + 4m, m <
// 32, the rows' ids held in registers from one stage to the next, so a
// stage issues its 32 copies a part back to back (with each id read from
// shared memory before its copy, the gather ran at about half the rate on
// an H100: PERF.md section 6, row 4b).
struct GatherRows {
  int id[32];
  __device__ __forceinline__ GatherRows(const int* ids, int lane) {
#pragma unroll
    for (int m = 0; m < 32; ++m) id[m] = ids[(lane >> 3) + 4 * m];
  }
  // Columns [k0, k0 + kWgCols) of the rows of P row-major (k, stride) bf16
  // matrices laid one after another (stride a multiple of 8: the padded
  // centers, split_bf16x3's parts, or x itself with d % 8 == 0 on a
  // 16-byte base), into P staged blocks of 128 rows one after another:
  // 16-byte asynchronous copies to the swizzled places. A row whose id is
  // negative, and the columns past `cols`, are filled with zeros. The
  // caller publishes the stage as stored: the copies are generic-proxy
  // writes, fenced into the async proxy before wgmma reads them.
  template <int P>
  __device__ __forceinline__ void copy(unsigned char* dst, const bf16* __restrict__ src, int k,
                                       int stride, int cols, int k0, int lane) const {
    const int c = lane & 7, col = k0 + 8 * c;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int m = 0; m < 32; ++m) {
        const int r = (lane >> 3) + 4 * m;
        const bool in = id[m] >= 0 && col < cols;
        cp_async16(dst + p * kWgBlock + 2 * wg_at(r, 8 * c),
                   src + (in ? ((size_t)p * k + id[m]) * stride + col : 0), in ? 16 : 0);
      }
  }
};

// A producer lane's arrival on stage i's barrier: once its asynchronous
// copies land or, after plain stores, fenced into the async proxy through
// which wgmma reads shared memory.
__device__ __forceinline__ void wg_publish(const PipeRing& ring, int i, bool stored) {
  if (stored) {
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(ring.full_of(i));
  } else {
    cp_async_arrive(ring.full_of(i));
  }
}

// Staged row r's squared norm over one stage: the fmaf chain of
// assign_pipe.cuh's pipe_row, column by column in order (each bf16 element
// converted to f32 exactly), so a row's norm has its f32 upcast's bits.
__device__ __forceinline__ void wg_row_sq(const unsigned char* blk, int r, float& sq) {
  const bf16* row = reinterpret_cast<const bf16*>(blk) + r * kWgCols;
#pragma unroll
  for (int kc = 0; kc < kWgCols / 4; ++kc) {
    struct alignas(8) Four {
      __nv_bfloat162 lo, hi;
    };
    const Four v =
        *reinterpret_cast<const Four*>(row + ((((kc >> 1) ^ r) & 7) << 3) + ((kc & 1) << 2));
    const float a = __bfloat162float(v.lo.x), b = __bfloat162float(v.lo.y);
    const float c = __bfloat162float(v.hi.x), e = __bfloat162float(v.hi.y);
    sq = fmaf(a, a, sq);
    sq = fmaf(b, b, sq);
    sq = fmaf(c, c, sq);
    sq = fmaf(e, e, sq);
  }
}

// ----------------------------------------------------------- the consumers

// D (64 x N, f32) += A (64 x 16, descriptor a) . B (N x 16, descriptor b)^T;
// scale_d == 0 ignores D's old value.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d)
        : "memory");
  }
};

// Tile row (of 128) and column of fragment element 4j + 2h + e of the
// calling thread (t: its id in the block; warpgroup t / 128).
__device__ __forceinline__ int wg_row(int t, int h) {
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int wg_col(int t, int j, int e) { return 8 * j + 2 * (t & 3) + e; }

// One stage's products of a warpgroup, issued and committed, not waited
// for: acc = A (64 x kWgCols, descriptor a) . the P B blocks (N rows each,
// `part_bytes` apart from b0)^T, a fresh accumulator (scale_d = 0 on the
// first product), the parts in the order lo, mid, hi (P = 3: the small
// parts first), each part's k16 steps in column order. Every kernel on
// this tile issues a stage's products through here, so a similarity has
// one sum order wherever it is computed.
template <int N, int P>
__device__ __forceinline__ void wg_stage(float (&acc)[N / 2], uint64_t a,
                                         const unsigned char* b0, int part_bytes) {
  wg_fence_acc(acc);
  wg_fence();
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {
    const uint64_t b = wg_desc(b0 + p * part_bytes);
#pragma unroll
    for (int s = 0; s < kWgSteps; ++s)
      Wgmma<N>::mma(acc, a + 2 * s, b + 2 * s, p == P - 1 && s == 0 ? 0 : 1);
  }
  wg_commit();
}

// One warpgroup's 64 x N results over one sweep of d: the nk stages of the
// ring from stage `it` on (`it` ends past them, so a block may sweep d
// several times in a row). A is rows 64g .. 64g + 63 of each stage's x
// block (ring.xblk), B the stage's P B blocks of N rows, `part_bytes`
// apart from byte `b_off` of its B region (ring.bblk; P = 3: the lo, mid
// and hi parts of split f32 centers, summed into one accumulator, the
// small parts first). Each stage's products go into a fresh accumulator
// and are added into sum[] once they have landed. per_stage(x block) runs
// on the CUDA cores while a stage's products are in flight, in stage order.
template <int N, int P, typename Ring, typename PerStage>
__device__ __forceinline__ void wg_sweep(const Ring& ring, int& it, int nk, int b_off,
                                         int part_bytes, float (&sum)[N / 2],
                                         PerStage per_stage) {
  const int g = threadIdx.x >> 7, lane = threadIdx.x & 31;
  float acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = sum[j] = 0.f;
  for (int i = 0; i < nk; ++i, ++it) {
    pipe_wait(ring, it);
    const unsigned char* x = ring.xblk(it);
    wg_stage<N, P>(acc, wg_desc(x + g * 64 * kWgRowBytes), ring.bblk(it) + b_off, part_bytes);
    per_stage(x);
    wg_wait_all();
    wg_fence_acc(acc);
    pipe_release(ring, it, lane);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) sum[j] += acc[j];
  }
}

// wg_sweep over a WgRing from its first stage, the B blocks as it lays
// them out.
template <int N, int P, int BR, typename PerStage>
__device__ __forceinline__ void wg_mainloop(const WgRing<P, BR>& ring, int nk,
                                            float (&sum)[N / 2], PerStage per_stage) {
  int it = 0;
  wg_sweep<N, P>(ring, it, nk, 0, WgRing<P, BR>::kB, sum, per_stage);
}

}  // namespace repro
