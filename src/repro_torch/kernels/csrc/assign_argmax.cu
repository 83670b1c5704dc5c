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
// What the design does about it: the pipelined tile of assign_tile.cuh,
// shared with assign_stats' launch 1: a grid over (128 rows, 128 centers)
// whose center tiles of one row tile run side by side, so x (2.05 GB) comes
// from device memory about once and from L2 for the other tiles; x and the
// center tile reach shared memory through a four-stage ring fed by the copy
// engine from a producer warp, while 8 consumer warps hold 8 x 8 results a
// thread and read shared memory 16 bytes at a time. A second launch merges
// the center tiles' winners in tile order. Each similarity is one fmaf chain
// over d in order, so idx and best_sim have the same bits as assign_stats'
// on the same inputs. The TPU kernel held every center tile in VMEM; here
// the centers (k * d * 4 = 3.3 MB at k = 400) stay in the 50 MB L2.
//
// bf16 x (the TPU kernel's bf16 mode, assign_argmax.py:46-51: bf16
// operands, f32 sums): the tensor-core tile of assign_stats' bf16 launch 1
// (assign_tile.cuh's launch_assign_tile_wg without the row norms), bf16
// centers as they are or f32 centers as the three bf16 parts of the
// wrapper's split, at the same computed width N for the same k. So idx and
// best_sim have the bits of assign_stats' bf16 pass on the same inputs. At
// k = 400 the work is 410 GFLOP of bf16 products (0.41 ms at 989 TFLOP/s;
// three products a column for f32 centers, 1.24 ms) on 1.02 GB of x
// (0.31 ms at 3.35 TB/s): the tensor cores bound it.

#include "assign_tile.cuh"

extern "C" int assign_argmax_scratch(int k) { return repro::assign_tile_scratch(k); }

// scratch: n * assign_argmax_scratch(k) floats (null when that is 0).
// xelem, celem (csrc/tma.cuh): both kElemF32, or x kElemBf16 with bf16
// centers (kElemBf16) or the (3, k, split_stride(d)) bf16 parts of f32
// centers (kElemSplit3).
extern "C" int assign_argmax(const void* x, const void* centers, int xelem, int celem, int n,
                             int d, int k, int* idx, float* best_sim,
                             float* scratch, void* stream) {
  using repro::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xelem == repro::kElemF32 && celem == repro::kElemF32)
    return repro::launch_assign_tile<false>(static_cast<const float*>(x),
                                            static_cast<const float*>(centers), n, k, d, idx,
                                            best_sim, nullptr, scratch, st);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* cb = static_cast<const bf16*>(centers);
  if (xelem == repro::kElemBf16 && celem == repro::kElemSplit3)
    return repro::launch_assign_tile_wg<false, 3>(xb, cb, n, k, d, idx, best_sim, nullptr,
                                                  scratch, st);
  if (xelem == repro::kElemBf16 && celem == repro::kElemBf16)
    return repro::launch_assign_tile_wg<false, 1>(xb, cb, n, k, d, idx, best_sim, nullptr,
                                                  scratch, st);
  return (int)cudaErrorInvalidValue;
}
