// flash_decode: one-token grouped-query attention against a KV cache.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_pallas, body _kernel). Contract of ref.flash_decode: q (h, dh),
// k and v (s, hk, dh), f32 or bf16; query head i reads kv head i / (h / hk);
// logits are q . k / sqrt(dh) in f32 over the positions below `length`
// (length > s means s); the output is the softmax-weighted sum of v, in q's
// type. At length <= 0 every position gets the same weight (the plain
// version masks every logit to f32.min, whose softmax is uniform), so the
// output is the mean of v over all s positions of the kv head.
//
// What bounds it on an H100: bytes. Each valid position of k and v is read
// once, 2 * length * hk * dh * bytes: 268 MB at the kernel bench's shape
// (h = 32, hk = 8, dh = 128, s = length = 32,768, f32), 80 us at 3.35 TB/s;
// the work is ~2 * g flops per byte read.
//
// What the design does about it: the Pallas grid is (hk, s tiles) with the s
// sweep carried in scratch, which on the card would be 8 blocks for 132 SMs.
// Here the positions are split across blocks: block (kv head, split) owns
// kSplit positions and its four warps take 32 positions at a time each,
// one a lane, so each query head's dot products need no shuffles and the
// online softmax (max, sum, weighted v) costs one warp max and one warp
// sum per head for 32 positions; the weighted v sum splits dh over the
// lanes (see flash_decode_split). The warps merge in shared memory in warp
// order, and the block writes one partial
// (m, l, acc[g][dh]). A split that starts at or past `length` writes the
// empty partial and reads nothing. A second launch merges the splits of
// each query head in a fixed order, one block per head and 32 indices of
// dh. No atomics: every run gives the same bits.
// `length` is read from device memory when given as a tensor, so the host
// never waits for it. The group g = h / hk need not be a power of two: a
// block serves up to kHeads query heads of its kv head, more are spread
// over further blocks.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kPos = 4;        // v rows a warp loads at once
constexpr int kSplit = 256;    // positions per block
constexpr int kHeads = 8;      // query heads per block
constexpr int kMergeThreads = 128;
constexpr int kMaxDh = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ int effective_length(const int* len_ptr, int len_val,
                                                int s, bool& uniform) {
  const int length = len_ptr != nullptr ? *len_ptr : len_val;
  uniform = length <= 0;
  return uniform ? s : min(length, s);
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {  // every lane ends with the same bits
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A warp takes 32 positions at a time, one a lane: each lane reads its
// position's k row (VEC: 4 values a load) and computes the dot products of
// all the block's query heads with it (q staged in shared memory, read as a
// broadcast); one max and one sum over the warp per head update the online
// softmax; then the lanes split dh for the weighted sum of the 32 v rows,
// each weight taken from its lane by a shuffle. EPL = elements of dh per
// lane in that sum (dh <= 32 * EPL).
template <typename T, int EPL, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* len_ptr, int len_val,
                       int s, int hk, int g, int dh, int nhc,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc) {
  __shared__ __align__(16) float sq[kHeads][kMaxDh];
  __shared__ float sm[kWarpsPerBlock][kHeads], sl[kWarpsPerBlock][kHeads];
  __shared__ float sacc[kWarpsPerBlock][kHeads][EPL * 32];
  const int hb = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int kvh = hb / nhc, i0 = (hb % nhc) * kHeads;
  const int gn = min(kHeads, g - i0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bool uniform;
  const int L = effective_length(len_ptr, len_val, s, uniform);
  const int p0 = split * kSplit, p1 = min(p0 + kSplit, L);
  const float sqrt_dh = sqrtf((float)dh);
  for (int idx = threadIdx.x; idx < gn * dh; idx += kWarpsPerBlock * 32)
    sq[idx / dh][idx % dh] = to_f32(q[(size_t)(kvh * g + i0) * dh + idx]);
  __syncthreads();

  float acc[kHeads][EPL], m[kHeads], l[kHeads];
#pragma unroll
  for (int gi = 0; gi < kHeads; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
  }

  for (int base = p0 + 32 * warp; base < p1; base += 32 * kWarpsPerBlock) {
    const int pos = base + lane;
    const bool valid = pos < p1;
    const T* krow = k + ((size_t)pos * hk + kvh) * dh;
    float dot[kHeads];
#pragma unroll
    for (int gi = 0; gi < kHeads; ++gi) dot[gi] = 0.f;
    if (valid) {
      if (VEC) {
#pragma unroll 4
        for (int d = 0; d < dh; d += 4) {
          const float4 kv = load4(krow + d);
#pragma unroll
          for (int gi = 0; gi < kHeads; ++gi) {
            if (gi >= gn) break;
            const float4 qv = *reinterpret_cast<const float4*>(&sq[gi][d]);
            dot[gi] = fmaf(qv.x, kv.x, dot[gi]);
            dot[gi] = fmaf(qv.y, kv.y, dot[gi]);
            dot[gi] = fmaf(qv.z, kv.z, dot[gi]);
            dot[gi] = fmaf(qv.w, kv.w, dot[gi]);
          }
        }
      } else {
        for (int d = 0; d < dh; ++d) {
          const float kv = to_f32(krow[d]);
#pragma unroll
          for (int gi = 0; gi < kHeads; ++gi) {
            if (gi >= gn) break;
            dot[gi] = fmaf(sq[gi][d], kv, dot[gi]);
          }
        }
      }
    }
    float p[kHeads];
#pragma unroll
    for (int gi = 0; gi < kHeads; ++gi) {
      if (gi >= gn) break;
      const float x = valid ? (uniform ? 0.f : dot[gi] / sqrt_dh) : -INFINITY;
      const float m_new = fmaxf(m[gi], warp_max(x));  // lane 0's position is valid
      const float corr = expf(m[gi] - m_new);
      p[gi] = expf(x - m_new);  // exp(-inf) = 0 past p1
      l[gi] = l[gi] * corr + warp_sum(p[gi]);
      m[gi] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[gi][e] *= corr;
    }
    const int nv = min(32, p1 - base);
    for (int j0 = 0; j0 < nv; j0 += kPos) {
      float vr[kPos][EPL];  // kPos rows of v in flight
#pragma unroll
      for (int jj = 0; jj < kPos; ++jj)
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int j = j0 + jj, d = lane + 32 * e;
          vr[jj][e] = (j < nv && d < dh)
                          ? to_f32(v[((size_t)(base + j) * hk + kvh) * dh + d]) : 0.f;
        }
#pragma unroll
      for (int jj = 0; jj < kPos; ++jj) {
        if (j0 + jj >= nv) break;
#pragma unroll
        for (int gi = 0; gi < kHeads; ++gi) {
          if (gi >= gn) break;
          const float pj = __shfl_sync(0xffffffffu, p[gi], j0 + jj);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[gi][e] = fmaf(pj, vr[jj][e], acc[gi][e]);
        }
      }
    }
  }

  // merge the four warps in warp order
#pragma unroll
  for (int gi = 0; gi < kHeads; ++gi) {
    if (lane == 0) {
      sm[warp][gi] = m[gi];
      sl[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sacc[warp][gi][lane + 32 * e] = acc[gi][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * dh; idx += kWarpsPerBlock * 32) {
    const int gi = idx / dh, d = idx % dh;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) mm = fmaxf(mm, sm[w][gi]);
    float ll = 0.f, a = 0.f;
    if (mm != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarpsPerBlock; ++w) {
        const float f = expf(sm[w][gi] - mm);
        ll = fmaf(sl[w][gi], f, ll);
        a = fmaf(sacc[w][gi][d], f, a);
      }
    }
    const size_t slot = ((size_t)hb * nsplit + split) * kHeads + gi;
    part_acc[slot * dh + d] = a;
    if (d == 0) {
      part_m[slot] = mm;
      part_l[slot] = ll;
    }
  }
}

// One block per (kv-head block, query head, 32 indices of dh): the splits'
// largest m by a block reduction (a max: any order gives the same value);
// then warp w folds splits w, w + 4, ... in order, a lane per dh index, each
// partial weighted by exp(m_split - m); the four warps' sums are added in
// warp order, so the result is the same every run.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    flash_decode_merge(const float* __restrict__ part_m,
                       const float* __restrict__ part_l,
                       const float* __restrict__ part_acc, int nsplit, int g,
                       int dh, int nhc, T* __restrict__ out) {
  constexpr int kWarps = kMergeThreads / 32;
  __shared__ float red[kWarps], sl[kWarps], sa[kWarps][32];
  const int hb = blockIdx.x, gi = blockIdx.y;
  const int kvh = hb / nhc, i0 = (hb % nhc) * kHeads;
  if (gi >= min(kHeads, g - i0)) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = 32 * blockIdx.z + lane;
  const size_t base = (size_t)hb * nsplit * kHeads + gi;  // slot of split 0
  float mm = -INFINITY;
  for (int sp = threadIdx.x; sp < nsplit; sp += kMergeThreads)
    mm = fmaxf(mm, part_m[base + (size_t)sp * kHeads]);
  mm = warp_max(mm);
  if (lane == 0) red[warp] = mm;
  __syncthreads();
  mm = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, red[w]);
  float ll = 0.f, a = 0.f;
  if (mm != -INFINITY) {
#pragma unroll 4
    for (int sp = warp; sp < nsplit; sp += kWarps) {
      const size_t slot = base + (size_t)sp * kHeads;
      const float ms = part_m[slot];
      const float f = ms == -INFINITY ? 0.f : expf(ms - mm);
      ll = fmaf(part_l[slot], f, ll);
      if (d < dh) a = fmaf(part_acc[slot * dh + d], f, a);
    }
  }
  if (lane == 0) sl[warp] = ll;
  sa[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && d < dh) {
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lt += sl[w];
      at += sa[w][lane];
    }
    store(&out[(size_t)(kvh * g + i0 + gi) * dh + d], at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int EPL, bool VEC>
int launch(const void* q, const void* k, const void* v, const int* len_ptr,
           int len_val, int s, int hk, int g, int dh, float* part_m,
           float* part_l, float* part_acc, void* out, cudaStream_t st) {
  const int nhc = (g + kHeads - 1) / kHeads;
  const int nsplit = (s + kSplit - 1) / kSplit;
  const dim3 grid(hk * nhc, nsplit);
  flash_decode_split<T, EPL, VEC><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len_ptr, len_val, s, hk, g, dh, nhc, part_m,
      part_l, part_acc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_merge<T><<<dim3(hk * nhc, kHeads, (dh + 31) / 32), kMergeThreads, 0, st>>>(
      part_m, part_l, part_acc, nsplit, g, dh, nhc, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int dispatch_dh(const void* q, const void* k, const void* v, const int* len_ptr,
                int len_val, int s, int hk, int g, int dh, float* pm, float* pl,
                float* pa, void* out, cudaStream_t st) {
  if (dh <= 32) return launch<T, 1, VEC>(q, k, v, len_ptr, len_val, s, hk, g, dh, pm, pl, pa, out, st);
  if (dh <= 64) return launch<T, 2, VEC>(q, k, v, len_ptr, len_val, s, hk, g, dh, pm, pl, pa, out, st);
  if (dh <= 128) return launch<T, 4, VEC>(q, k, v, len_ptr, len_val, s, hk, g, dh, pm, pl, pa, out, st);
  return launch<T, 8, VEC>(q, k, v, len_ptr, len_val, s, hk, g, dh, pm, pl, pa, out, st);
}

// Four values a load when every k row starts on a 4-value boundary.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* len_ptr,
             int len_val, int s, int hk, int g, int dh, float* pm, float* pl,
             float* pa, void* out, cudaStream_t st) {
  const bool vec = dh % 4 == 0 && reinterpret_cast<uintptr_t>(k) % (4 * sizeof(T)) == 0;
  if (vec) return dispatch_dh<T, true>(q, k, v, len_ptr, len_val, s, hk, g, dh, pm, pl, pa, out, st);
  return dispatch_dh<T, false>(q, k, v, len_ptr, len_val, s, hk, g, dh, pm, pl, pa, out, st);
}

}  // namespace

extern "C" int flash_decode_split_len() { return kSplit; }
extern "C" int flash_decode_heads_per_block() { return kHeads; }
extern "C" int flash_decode_max_dh() { return 256; }

// dtype 0 = f32, 1 = bf16. s > 0, 0 < dh <= 256, g = h / hk. Scratch:
// part_m and part_l hold hk * ceil(g / kHeads) * ceil(s / kSplit) * kHeads
// floats, part_acc dh times as many. len_ptr (a device int32) wins over
// len_val when it is not null.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* len_ptr, int len_val, int s, int hk,
                            int g, int dh, int dtype, float* part_m,
                            float* part_l, float* part_acc, void* out,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, len_ptr, len_val, s, hk, g, dh, part_m,
                           part_l, part_acc, out, st);
  return dispatch<__nv_bfloat16>(q, k, v, len_ptr, len_val, s, hk, g, dh,
                                 part_m, part_l, part_acc, out, st);
}
