// label_stats: per-label weighted sums and weight totals.
//
// Replaces the TPU kernel src/repro/kernels/assign_stats.py
// (label_stats_pallas, body _label_stats_kernel): sums[l] = sum of w_i * x_i
// and counts[l] = sum of w_i over the rows with label l. Labels outside
// [0, k) and weight-0 rows contribute nothing.
//
// What bounds it on an H100: memory. One add per loaded float, so the floor
// is reading x (n * d * 4 bytes) once at the card's memory rate: 0.61 ms for
// the 1 GB collection (250,000 x 2,048), 8.6 us at Buckshot's phase-1 shape
// (3,536 x 2,048, k = 50), where launch and host overhead weigh as much as
// the fold itself.
//
// What the design does about it: the TPU kernel kept one (k, 512)
// accumulator resident in VMEM across the whole row sweep, which relies on
// its grid running in order. Hopper blocks run in no order and hold at most
// 227 KB, so a block keeps every label's accumulator for 32 columns (up to
// ~1,180 labels; past that, label tiles) and one row chunk, and x streams
// through a ring of shared-memory stages filled by the copy engine, so it
// is read once whatever k (label_stats.cuh). A second launch adds the chunk
// partials in chunk order. A null w is weight 1: no fill of ones per call.
//
// bf16 x (the JAX kernel upcasts x in its body): the floor halves (0.31 ms
// at the 1 GB shape, 4.4 us at Buckshot's phase-1 shape). The f32 route's
// 128-row stages would carry half their bytes and every column tile would
// sort the same labels again, so bf16 rows take a route of their own
// (label_stats.cuh): from 65,536 rows one launch deals the labels to the
// consumer warps by their share of a sample, one lists each stage's rows
// by warp once, the fold streams 256-row stages (an f32 stage's bytes)
// beside those lists, and the reduce follows, the order of adds unchanged,
// so the sums and totals have the bits of the f32 launch on x.float().

#include "label_stats.cuh"

extern "C" int label_stats_chunks(int n, int k, int d) {
  return repro::stats_chunks(n, k, d);
}

// Ints of the bf16 route's lists, which follow the partials in the scratch.
extern "C" int label_stats_lists(int n, int k, int chunks) {
  return repro::stats_list_ints(n, k, chunks);
}

// Scratch: part holds chunks * k * d floats, part_k chunks * 3 * k; for bf16
// x, from part + chunks * k * (d + 3) rounded up to a multiple of 32 floats,
// label_stats_lists ints. elem:
// x's element type (kElemF32 or kElemBf16, csrc/tma.cuh).
extern "C" int label_stats(const void* x, int elem, const int* idx, const float* w,
                           int n, int d, int k, int chunks, float* part,
                           float* part_k, float* sums, float* counts,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem != repro::kElemF32 && elem != repro::kElemBf16) return (int)cudaErrorInvalidValue;
  if (elem == repro::kElemBf16)
    return repro::launch_stats<false>(static_cast<const __nv_bfloat16*>(x), idx, w,
                                      nullptr, nullptr, n, d, k, chunks, part, part_k,
                                      sums, counts, nullptr, nullptr, st);
  return repro::launch_stats<false>(static_cast<const float*>(x), idx, w, nullptr,
                                    nullptr, n, d, k, chunks, part, part_k, sums,
                                    counts, nullptr, nullptr, st);
}
