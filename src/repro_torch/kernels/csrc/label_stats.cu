// label_stats: per-label weighted sums and weight totals.
//
// Replaces the TPU kernel src/repro/kernels/assign_stats.py
// (label_stats_pallas, body _label_stats_kernel): sums[l] = sum of w_i * x_i
// and counts[l] = sum of w_i over the rows with label l. Labels outside
// [0, k) and weight-0 rows contribute nothing.
//
// What bounds it on an H100: memory. One add per loaded float, so the floor
// is reading x (n * d * 4 bytes) once at the card's memory rate. At Buckshot's
// phase-1 shape (3,536 x 2,048, k = 50) that is 29 MB, a few microseconds,
// so launch overhead matters as much as the fold itself.
//
// What the design does about it: the TPU kernel kept one (k, 512) accumulator
// resident in VMEM across the whole row sweep, which relies on its grid
// running in order. Hopper blocks run in no order and hold at most 227 KB,
// so the output is cut into (64 labels, 128 columns) tiles, the rows into
// chunks, and each block folds one chunk into a shared-memory accumulator
// (each thread owns one column: no races, rows added in order). A second
// launch adds the chunk partials in chunk order (label_stats.cuh). x is read
// once, in 512-byte row segments.

#include "label_stats.cuh"

extern "C" int label_stats_chunks(int n, int k, int d) {
  return repro::stats_chunks(n, k, d);
}

// Scratch: part holds chunks * k * d floats, part_k chunks * 3 * k.
extern "C" int label_stats(const float* x, const int* idx, const float* w,
                           int n, int d, int k, int chunks, float* part,
                           float* part_k, float* sums, float* counts,
                           void* stream) {
  return repro::launch_stats<false>(x, idx, w, nullptr, nullptr, n, d, k,
                                    chunks, part, part_k, sums, counts, nullptr,
                                    nullptr, static_cast<cudaStream_t>(stream));
}
