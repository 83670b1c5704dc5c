// assign_stats: one K-Means pass. Nearest center per row, plus per-cluster
// weighted sums, weight totals, lowest member similarity and weighted sum of
// squared row norms.
//
// Replaces the TPU kernel src/repro/kernels/assign_stats.py
// (assign_stats_pallas, body _kernel). Contract: idx is the argmax over
// centers of x . c (ties -> lowest index), best_sim its value; weight-0 rows
// count in no statistic and never in min_sim; an empty cluster has
// min_sim = FLT_MAX.
//
// What bounds it on an H100: at the main path's n = 250,000, d = 2,048,
// k = 50 the assignment is 2*n*k*d = 51 GFLOP of fp32 FMA on 2.05 GB of x,
// so the fp32 rate (0.76 ms at 67 TFLOP/s) and the read of x (0.61 ms at
// 3.35 TB/s) are close; the arithmetic is the larger.
//
// What the design does about it: launch 1 (assign_tile.cuh) runs the
// pipelined tile of assign_pipe.cuh with 128 rows x 128 centers per block
// (k = 50 fits one center tile, 64 of its columns computed; larger k runs
// the center tiles side by side and merges their winners in tile order,
// strict '>'), and also sums each row's squared norm while the row passes
// through the ring. Launches 2-3 are label_stats' deterministic fold with the extra
// scalars (label_stats.cuh). The TPU kernel folded the stats while the x tile
// was still in VMEM and read x once; this first version reads x twice (once
// per launch), which costs one more pass over x. The TPU kernel's ACC_BUDGET
// split existed only because its whole (k, d) accumulator lived in VMEM; the
// tiled fold has no such limit.
//
// bf16 x: launch 1 runs on the tensor cores (assign_tile.cuh's
// launch_assign_tile_wg, wgmma_tile.cuh), with bf16 centers as they are or
// with f32 centers as the three bf16 parts of the wrapper's split (celem
// kElemSplit3): every product exact, the sums in f32 in the tensor cores'
// order, so idx and best_sim are within 1e-5 of the f32 mode on x.float()
// (a near-tie may pick the other center) and equal to it on
// integer-valued rows. The row norms stay the f32 mode's fmaf chains, and
// the fold is label_stats.cuh's bf16 route (the classes, the lists, the
// fold, the reduce), whose adds are the f32 mode's (each element converted
// exactly):
// wherever idx agrees, sums, counts and sumsq keep the f32 mode's bits and
// min_sim is best_sim's. The tile then reads x at half
// the bytes and is bound by that read (0.31 ms at k = 50); the fold reads x
// a second time.

#include "assign_tile.cuh"
#include "label_stats.cuh"

extern "C" int assign_stats_chunks(int n, int k, int d) {
  return repro::stats_chunks(n, k, d);
}

extern "C" int assign_stats_lists(int n, int k, int chunks) {
  return repro::stats_list_ints(n, k, chunks);
}

extern "C" int assign_stats_scratch(int k) { return repro::assign_tile_scratch(k); }

extern "C" int assign_stats_split_stride(int d) { return repro::split_stride(d); }

namespace {

using repro::bf16;

// Launch 1 on x of TX and centers of TC (f32 by f32; bf16 x by bf16 centers,
// or by the three bf16 parts of f32 centers: SPLIT), then the fold.
template <typename TX, typename TC, bool SPLIT = false>
int run(const void* xv, const void* cv, const float* w, int n, int d, int k, int chunks,
        int* idx, float* best_sim, float* rowsq, float* part, float* part_k, float* tile,
        float* sums, float* counts, float* min_sim, float* sumsq, cudaStream_t st) {
  const TX* x = static_cast<const TX*>(xv);
  const TC* c = static_cast<const TC*>(cv);
  int err;
  if constexpr (sizeof(TX) == 4)
    err = repro::launch_assign_tile<true>(x, c, n, k, d, idx, best_sim, rowsq, tile, st);
  else
    err = repro::launch_assign_tile_wg<true, SPLIT ? 3 : 1>(x, c, n, k, d, idx, best_sim, rowsq,
                                                            tile, st);
  if (err != 0) return err;
  return repro::launch_stats<true>(x, idx, w, rowsq, best_sim, n, d, k, chunks, part,
                                   part_k, sums, counts, min_sim, sumsq, st);
}

}  // namespace

// Scratch: rowsq holds n floats, part chunks * k * d, part_k chunks * 3 * k
// (then, for bf16 x, the fold's lists: label_stats.cu says where), tile
// n * assign_stats_scratch(k) (null when that is 0). xelem, celem: the
// element types of x and the centers (kElemF32, kElemBf16, kElemSplit3):
// both f32, or x bf16 with bf16 centers or with the (3, k,
// assign_stats_split_stride(d)) bf16 parts of f32 centers.
extern "C" int assign_stats(const void* x, const void* centers, int xelem, int celem,
                            const float* w, int n, int d, int k, int chunks,
                            int* idx, float* best_sim, float* rowsq,
                            float* part, float* part_k, float* tile, float* sums,
                            float* counts, float* min_sim, float* sumsq,
                            void* stream) {
  using repro::kElemBf16;
  using repro::kElemF32;
  using repro::kElemSplit3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = xelem == kElemF32 && celem == kElemF32      ? &run<float, float>
            : xelem == kElemBf16 && celem == kElemSplit3 ? &run<bf16, bf16, true>
            : xelem == kElemBf16 && celem == kElemBf16   ? &run<bf16, bf16>
                                                         : nullptr;
  if (go == nullptr) return (int)cudaErrorInvalidValue;
  return go(x, centers, w, n, d, k, chunks, idx, best_sim, rowsq, part, part_k, tile, sums,
            counts, min_sim, sumsq, st);
}
