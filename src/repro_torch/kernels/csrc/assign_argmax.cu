// assign_argmax: nearest center per row, without statistics.
//
// Replaces the TPU kernel src/repro/kernels/assign_argmax.py
// (assign_argmax_pallas, body _kernel). Contract: idx is the argmax over
// centers of x . c (ties -> lowest index), best_sim its value. It carries
// the two-pass (fused=False) paths of K-Means, the micro-clusters and BKC,
// and the center index's mini-Lloyd rounds (ops.build_center_index).
//
// What bounds it on an H100: arithmetic. At the main path's n = 250,000,
// d = 2,048, k = 400 the work is 2*n*k*d = 410 GFLOP of fp32 FMA (6.1 ms at
// 67 TFLOP/s, no TF32: the result must match the plain fp32 product) on
// 2.05 GB of x (0.61 ms at 3.35 TB/s).
//
// What the design does about it: the same register tile as assign_stats'
// launch 1 (assign_tile.cuh: 128 rows x 64 centers per block, 8 x 4 results
// per thread, d staged 16 columns at a time), without the row norms. Each
// similarity is one fmaf chain over d in order, so idx and best_sim have the
// same bits as assign_stats' on the same inputs. The TPU kernel held every
// center tile in VMEM; here the centers stream through shared memory and
// stay in the 50 MB L2 (k * d * 4 = 3.3 MB at k = 400).

#include "assign_tile.cuh"

extern "C" int assign_argmax(const float* x, const float* centers, int n,
                             int d, int k, int* idx, float* best_sim,
                             void* stream) {
  return repro::launch_assign_tile<false>(x, centers, n, k, d, idx, best_sim,
                                          nullptr,
                                          static_cast<cudaStream_t>(stream));
}
