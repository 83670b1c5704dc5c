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

#include "assign_tile.cuh"
#include "label_stats.cuh"

extern "C" int assign_stats_chunks(int n, int k, int d) {
  return repro::stats_chunks(n, k, d);
}

extern "C" int assign_stats_scratch(int k) { return repro::assign_tile_scratch(k); }

// Scratch: rowsq holds n floats, part chunks * k * d, part_k chunks * 3 * k,
// tile n * assign_stats_scratch(k) (null when that is 0).
extern "C" int assign_stats(const float* x, const float* centers,
                            const float* w, int n, int d, int k, int chunks,
                            int* idx, float* best_sim, float* rowsq,
                            float* part, float* part_k, float* tile, float* sums,
                            float* counts, float* min_sim, float* sumsq,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = repro::launch_assign_tile<true>(x, centers, n, k, d, idx,
                                                  best_sim, rowsq, tile, st);
  if (err != 0) return err;
  return repro::launch_stats<true>(x, idx, w, rowsq, best_sim, n, d, k, chunks,
                                   part, part_k, sums, counts, min_sim, sumsq,
                                   st);
}
