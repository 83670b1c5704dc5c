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
// 82 MB for llama3.2-3b's heads (h = 24, hk = 8, bf16, length 20,000), 24.5
// us. The work is ~2 * g flops per byte read.
//
// What the design does about it: the Pallas grid is (hk, s tiles) with the s
// sweep carried in scratch, which on the card would be 8 blocks for 132 SMs.
// Here block (kv head, split) owns one contiguous range of positions, the
// splits sized from the length on the device so that about one block lands
// on each SM and every block has work. One producer warp streams tiles of k
// and v (128 positions in bf16, 64 in f32, 32 for f32 rows past 512 bytes)
// through a ring of shared-memory stages with the copy engine (3-D tensor
// maps over (s, hk, dh), boxes of 128-byte rows, 128-byte swizzle, an
// mbarrier per stage); a cache whose rows are not 128-byte multiples or
// whose base is not 16-byte aligned is loaded by the same warp with plain
// loads into the same swizzled layout, so the arithmetic, and the bits, are
// the same. Eight consumer warps then, per tile: compute the logits of the
// block's <= 8 query heads by an fmaf chain over d in f32 on the CUDA cores,
// one position a thread (bf16 products are exact in f32 either way, but
// mma.sync on the tensor cores sums them in another order and rounding,
// which on an H100 moved one near-zero output of chip_smoke.py's parity
// check past one bf16 ulp of the plain value; these FLOPs hide under the
// bytes); update the online softmax (max, rescale, sum), one warp per head,
// writing the weights p as [position][head]; and add p * v in f32 on the
// CUDA cores, each warp over an eighth of the tile's positions, four
// positions' v (16-byte f32 or 8-byte bf16 reads) and all eight heads' p
// (two 16-byte reads) in flight at once.
// Each block writes its partial (m, l, acc), takes a ticket from a
// per-kv-head counter (atomicInc, which wraps to 0 on the last ticket, so
// the counter is ready for the next call), and the block that draws the
// last ticket merges the partials in split order: no second launch, and the
// bits do not depend on which block finished last. No floating-point
// atomics. `length` is read from device memory when given as a tensor, so
// the host never waits for it. A block serves up to kHeads query heads of
// its kv head; more are spread over further blocks.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

using repro::mbar_arrive;
using repro::mbar_arrive_expect_tx;
using repro::mbar_wait;

constexpr int kHeads = 8;       // query heads per block
constexpr int kWarps = 8;       // consumer warps: one a query head in the softmax
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kMaxDh = 256;
constexpr int kMaxStages = 6;
constexpr int kMaxSplits = 128;  // the merge's weights fit the first stage
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");
}

// Byte offset of element (pos, d) in a k or v tile: dh is cut into boxes of
// 128-byte rows (TP rows a box); the 16-byte chunks of row pos are permuted
// by pos % 8, as the copy engine's 128-byte swizzle lays them out.
template <int E, int TP>
__device__ __forceinline__ int swz(int pos, int d) {
  const int b = d * E;
  return (b >> 7) * (TP * 128) + pos * 128 + ((((b & 127) >> 4) ^ (pos & 7)) << 4) + (b & 15);
}

__device__ __forceinline__ float4 load4(const unsigned char* p, float) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const unsigned char* p, __nv_bfloat16) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Shared memory of a block: the ring, then the logits [2][kHeads][TP], the
// weights p [2][TP][kHeads], the rescale factors [2][kHeads], q as f32
// [kHeads][dh_pad], the block's (m, l) [2][kHeads], the barriers and the
// last-block flag.
struct Layout {
  int stage, logits, pt, corr, q, ml, bars, total;
};

__host__ __device__ inline Layout layout(int E, int TP, int dh_pad, int stages) {
  Layout o;
  o.stage = 2 * (dh_pad * E / 128) * TP * 128;
  o.logits = stages * o.stage;
  o.pt = o.logits + 2 * kHeads * TP * 4;  // p as [2][TP][kHeads]
  o.corr = o.pt + 2 * kHeads * TP * 4;
  o.q = o.corr + 2 * kHeads * 4;
  o.ml = o.q + kHeads * dh_pad * 4;
  o.bars = o.ml + 2 * kHeads * 4;
  o.total = o.bars + 2 * stages * 8 + 16 + 1024;  // + base alignment
  return o;
}

// Partials per (kv-head block, split) slot: m[kHeads], l[kHeads],
// acc[kHeads][dh].
template <typename T, int TP, int UPL, int NH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, int tma,
                        const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* len_ptr, int len_val,
                        int s, int hk, int g, int dh, int dh_pad, int nhc,
                        int stages, float* __restrict__ part,
                        unsigned* __restrict__ tickets, T* __restrict__ out) {
  constexpr int E = sizeof(T);
  constexpr int kRow = 128 / E;       // elements of a 128-byte box row
  constexpr int kPart = TP / kWarps;  // positions a warp adds into p . v
  extern __shared__ unsigned char raw[];
  // aligned by an offset from raw, not through an integer, so the compiler
  // keeps every access below a shared-memory one (LDS/STS, not generic)
  unsigned char* base = raw + ((1024u - (repro::smem_addr(raw) & 1023u)) & 1023u);
  const Layout lay = layout(E, TP, dh_pad, stages);
  const int nbox = dh_pad / kRow;
  float* sp = reinterpret_cast<float*>(base + lay.logits);
  float* spt = reinterpret_cast<float*>(base + lay.pt);
  float* corr = reinterpret_cast<float*>(base + lay.corr);
  float* sq = reinterpret_cast<float*>(base + lay.q);
  float* ml = reinterpret_cast<float*>(base + lay.ml);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* empty = full + stages;
  int* last = reinterpret_cast<int*>(empty + stages);

  const int hb = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int kvh = hb / nhc, i0 = (hb % nhc) * kHeads;
  const int gn = min(kHeads, g - i0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int length = len_ptr != nullptr ? *len_ptr : len_val;
  const bool uniform = length <= 0;
  const int L = uniform ? s : min(length, s);
  int span = (L + nsplit - 1) / nsplit;
  span = (span + TP - 1) / TP * TP;
  const int p0 = min(L, split * span), p1 = min(L, p0 + span);
  const int ntiles = (p1 - p0 + TP - 1) / TP;
  const float sqrt_dh = sqrtf((float)dh);
  const T* qh = q + (size_t)(kvh * g + i0) * dh;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      repro::mbar_init(&full[st], 32);  // the producer warp's lanes
      repro::mbar_init(&empty[st], kWarps);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {  // producer
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % stages;
      mbar_wait(&empty[st], ((i / stages) & 1) ^ 1);
      unsigned char* kt = base + st * lay.stage;
      unsigned char* vt = kt + lay.stage / 2;
      const int pos0 = p0 + i * TP;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], lay.stage);
          for (int b = 0; b < nbox; ++b) {
            repro::tma_load_3d(kt + b * TP * 128, &kmap, b * kRow, kvh, pos0, &full[st]);
            repro::tma_load_3d(vt + b * TP * 128, &vmap, b * kRow, kvh, pos0, &full[st]);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      } else {
        for (int e = lane; e < TP * dh_pad; e += 32) {
          const int pos = e / dh_pad, d = e % dh_pad;
          const bool in = pos0 + pos < s && d < dh;
          const size_t at = ((size_t)(pos0 + pos) * hk + kvh) * dh + d;
          *reinterpret_cast<T*>(kt + swz<E, TP>(pos, d)) = in ? k[at] : zero<T>();
          *reinterpret_cast<T*>(vt + swz<E, TP>(pos, d)) = in ? v[at] : zero<T>();
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {  // consumers; q is staged while the first copies are in flight
    for (int e = tid; e < kHeads * dh_pad; e += kWarps * 32) {
      const int gi = e / dh_pad, d = e % dh_pad;
      sq[e] = (gi < gn && d < dh) ? to_f32(qh[(size_t)gi * dh + d]) : 0.f;
    }
    consumers_sync();
    float m = -INFINITY, l = 0.f;  // the softmax of head `warp`
    float acc[NH][UPL][4];
#pragma unroll
    for (int gi = 0; gi < NH; ++gi)
#pragma unroll
      for (int u = 0; u < UPL; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][u][e] = 0.f;
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % stages, buf = i & 1;
      const int pos0 = p0 + i * TP;
      mbar_wait(&full[st], (i / stages) & 1);
      const unsigned char* kt = base + st * lay.stage;
      const unsigned char* vt = kt + lay.stage / 2;
      float* lg = sp + buf * kHeads * TP;
      float* pt = spt + buf * kHeads * TP;

      // (1) raw dot products q . k of the tile's positions -> lg[head][pos],
      // one position a thread, d in order
      {
        constexpr int kGroups = kWarps * 32 / TP;  // head groups
        constexpr int kPer = NH / kGroups;         // heads a thread
        const int pos = tid % TP, hg = tid / TP;
        float dot[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) dot[j] = 0.f;
#pragma unroll 4
        for (int c4 = 0; c4 < dh_pad; c4 += 4) {
          const float4 kv = load4(kt + swz<E, TP>(pos, c4), T());
#pragma unroll
          for (int j = 0; j < kPer; ++j) {  // q is 0 past the block's heads
            const float4 qv = *reinterpret_cast<const float4*>(sq + (hg + kGroups * j) * dh_pad + c4);
            dot[j] = fmaf(qv.x, kv.x, dot[j]);
            dot[j] = fmaf(qv.y, kv.y, dot[j]);
            dot[j] = fmaf(qv.z, kv.z, dot[j]);
            dot[j] = fmaf(qv.w, kv.w, dot[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int gi = hg + kGroups * j;
          if (gi < gn) lg[gi * TP + pos] = dot[j];
        }
      }
      consumers_sync();

      // (2) online softmax, warp w for head w: p goes to pt[pos][w]
      if (warp < gn) {
        float x[TP / 32];
        float tmax = -INFINITY;
#pragma unroll
        for (int r = 0; r < TP / 32; ++r) {
          const int pos = lane + 32 * r;
          x[r] = pos0 + pos < p1 ? (uniform ? 0.f : lg[warp * TP + pos] / sqrt_dh) : -INFINITY;
          tmax = fmaxf(tmax, x[r]);
        }
        const float m_new = fmaxf(m, warp_max(tmax));  // the tile's first position is valid
        const float cr = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int r = 0; r < TP / 32; ++r) {
          const float p = expf(x[r] - m_new);  // exp(-inf) = 0 past p1
          pt[(lane + 32 * r) * kHeads + warp] = p;
          psum += p;
        }
        l = l * cr + warp_sum(psum);
        m = m_new;
        if (lane == 0) corr[buf * kHeads + warp] = cr;
      } else if (warp < NH) {  // a head past the block's: p = 0, factor 1
#pragma unroll
        for (int r = 0; r < TP / 32; ++r) pt[(lane + 32 * r) * kHeads + warp] = 0.f;
        if (lane == 0) corr[buf * kHeads + warp] = 1.f;
      }
      consumers_sync();

      // (3) acc = acc * corr + p . v for the first NH heads over this warp's
      // eighth of the tile, four positions' loads at once
#pragma unroll
      for (int gi = 0; gi < NH; ++gi) {
        const float cr = corr[buf * kHeads + gi];
#pragma unroll
        for (int u = 0; u < UPL; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gi][u][e] *= cr;
      }
      const int q0 = warp * kPart;
      const int q1 = min(q0 + kPart, p1 - pos0);  // positions past p1 weigh nothing
#pragma unroll
      for (int j0 = 0; j0 < kPart; j0 += 4) {
        float4 vv[4][UPL], pa[4], pb[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int pos = q0 + j0 + jj;
          const bool in = pos < q1;
          const float4* pp = reinterpret_cast<const float4*>(pt + pos * kHeads);
          pa[jj] = in ? pp[0] : make_float4(0.f, 0.f, 0.f, 0.f);
          pb[jj] = in && NH > 4 ? pp[1] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < UPL; ++u) {
            const int d = 4 * (lane + 32 * u);
            vv[jj][u] = in && d < dh_pad ? load4(vt + swz<E, TP>(pos, d), T())
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float p[8] = {pa[jj].x, pa[jj].y, pa[jj].z, pa[jj].w,
                              pb[jj].x, pb[jj].y, pb[jj].z, pb[jj].w};
#pragma unroll
          for (int gi = 0; gi < NH; ++gi)
#pragma unroll
            for (int u = 0; u < UPL; ++u) {
              acc[gi][u][0] = fmaf(p[gi], vv[jj][u].x, acc[gi][u][0]);
              acc[gi][u][1] = fmaf(p[gi], vv[jj][u].y, acc[gi][u][1]);
              acc[gi][u][2] = fmaf(p[gi], vv[jj][u].z, acc[gi][u][2]);
              acc[gi][u][3] = fmaf(p[gi], vv[jj][u].w, acc[gi][u][3]);
            }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    if (lane == 0 && warp < gn) {
      ml[warp] = m;
      ml[kHeads + warp] = l;
    }
    consumers_sync();  // every load of the ring has landed and been read
    // the warps' sums, in the ring's first stage: red[warp][head][dh_pad]
    float* red = reinterpret_cast<float*>(base);
#pragma unroll
    for (int gi = 0; gi < NH; ++gi) {
      if (gi >= gn) break;
#pragma unroll
      for (int u = 0; u < UPL; ++u) {
        const int d = 4 * (lane + 32 * u);
        if (d < dh_pad)
          *reinterpret_cast<float4*>(red + (warp * kHeads + gi) * dh_pad + d) =
              make_float4(acc[gi][u][0], acc[gi][u][1], acc[gi][u][2], acc[gi][u][3]);
      }
    }
  }
  __syncthreads();

  // this block's partial, the warps added in warp order
  const size_t stride = 2 * kHeads + (size_t)kHeads * dh;
  float* slot = part + ((size_t)hb * nsplit + split) * stride;
  const float* red = reinterpret_cast<const float*>(base);
  for (int e = tid; e < gn * dh; e += kThreads) {
    const int gi = e / dh, d = e % dh;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[(w * kHeads + gi) * dh_pad + d];
    slot[2 * kHeads + gi * dh + d] = a;
  }
  if (tid < gn) {
    slot[tid] = ntiles > 0 ? ml[tid] : -INFINITY;
    slot[kHeads + tid] = ntiles > 0 ? ml[kHeads + tid] : 0.f;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicInc(&tickets[hb], nsplit - 1) == (unsigned)(nsplit - 1);
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // the last block of this kv-head block merges every split in split order:
  // the splits' m and l come in together, then one weight per (split, head)
  const float* slots = part + (size_t)hb * nsplit * stride;
  float* f = reinterpret_cast<float*>(base);  // [nsplit][kHeads]: m, then weights
  float* lv = f + nsplit * kHeads;             // [nsplit][kHeads]
  float* lt = lv + nsplit * kHeads;            // [kHeads] totals
  for (int e = tid; e < nsplit * gn; e += kThreads) {
    const int sp2 = e / gn, gi = e % gn;
    f[sp2 * kHeads + gi] = __ldcg(slots + sp2 * stride + gi);
    lv[sp2 * kHeads + gi] = __ldcg(slots + sp2 * stride + kHeads + gi);
  }
  __syncthreads();
  if (tid < gn) {
    float mm = -INFINITY;
    for (int sp2 = 0; sp2 < nsplit; ++sp2) mm = fmaxf(mm, f[sp2 * kHeads + tid]);
    float ll = 0.f;
    for (int sp2 = 0; sp2 < nsplit; ++sp2) {
      const float ms = f[sp2 * kHeads + tid];
      const float fw = ms == -INFINITY ? 0.f : expf(ms - mm);
      f[sp2 * kHeads + tid] = fw;
      ll = fmaf(lv[sp2 * kHeads + tid], fw, ll);
    }
    lt[tid] = fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < gn * dh; e += kThreads) {
    const int gi = e / dh, d = e % dh;
    float a = 0.f;
#pragma unroll 16
    for (int sp2 = 0; sp2 < nsplit; ++sp2)
      a = fmaf(__ldcg(slots + sp2 * stride + 2 * kHeads + gi * dh + d), f[sp2 * kHeads + gi], a);
    store(&out[(size_t)(kvh * g + i0 + gi) * dh + d], a / lt[gi]);
  }
}

int splits(int s, int hk, int nhc, int tp) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int n = sms / (hk * nhc);
  const int tiles = (s + tp - 1) / tp;
  if (n > tiles) n = tiles;
  if (n > kMaxSplits) n = kMaxSplits;
  return n > 1 ? n : 1;
}

template <typename T>
constexpr int row_elems() { return 128 / (int)sizeof(T); }

// Positions a tile: 128 for bf16 rows up to 256 bytes, else 64, and 32 for
// f32 rows past 512 bytes (a stage of k and v stays at 64 KB or less).
template <typename T>
int tile_of(int dh) {
  const int dh_pad = (dh + row_elems<T>() - 1) / row_elems<T>() * row_elems<T>();
  if (sizeof(T) == 2) return dh_pad <= 128 ? 128 : 64;
  return dh_pad <= 128 ? 64 : 32;
}

template <typename T, int TP, int UPL, int NH>
int launch(const void* q, const void* k, const void* v, const int* len_ptr,
           int len_val, int s, int hk, int g, int dh, int nsplit, float* part,
           unsigned* tickets, void* out, cudaStream_t st) {
  constexpr int E = sizeof(T);
  const int dh_pad = (dh + row_elems<T>() - 1) / row_elems<T>() * row_elems<T>();
  const int nhc = (g + kHeads - 1) / kHeads;
  const int one = layout(E, TP, dh_pad, 1).stage;
  int stages = (kMaxSmem - layout(E, TP, dh_pad, 0).total - 2 * 8 * kMaxStages) / one;
  if (stages > kMaxStages) stages = kMaxStages;
  const int smem = layout(E, TP, dh_pad, stages).total;
  static unsigned smem_set = 0;  // this instantiation, this library
  int err = repro::allow_smem(flash_decode_kernel<T, TP, UPL, NH>, kMaxSmem, smem_set);
  if (err != 0) return err;
  CUtensorMap kmap{}, vmap{};
  const int tma = dh % row_elems<T>() == 0 && s >= TP &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (tma) {
    const CUtensorMapDataType type =
        E == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)hk, (cuuint64_t)s};
    const cuuint64_t strides[2] = {(cuuint64_t)dh * E, (cuuint64_t)hk * dh * E};
    const cuuint32_t box[3] = {(cuuint32_t)row_elems<T>(), 1, (cuuint32_t)TP};
    err = repro::make_tensor_map(&kmap, type, 3, k, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = repro::make_tensor_map(&vmap, type, 3, v, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != 0) return err;
  }
  flash_decode_kernel<T, TP, UPL, NH><<<dim3(hk * nhc, nsplit), kThreads, smem, st>>>(
      kmap, vmap, tma, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len_ptr, len_val, s, hk, g, dh, dh_pad, nhc,
      stages, part, tickets, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* len_ptr,
             int len_val, int s, int hk, int g, int dh, int nsplit, float* part,
             unsigned* tickets, void* out, cudaStream_t st) {
  const int dh_pad = (dh + row_elems<T>() - 1) / row_elems<T>() * row_elems<T>();
  // the heads a block computes: 4 when the group fits (half the work), else 8
  const bool four = g <= 4;
  if constexpr (sizeof(T) == 4) {  // tiles of 64 positions, 32 past 512-byte rows
    if (dh_pad > 128)
      return launch<T, 32, 2, 8>(q, k, v, len_ptr, len_val, s, hk, g, dh, nsplit, part, tickets, out, st);
    return four ? launch<T, 64, 1, 4>(q, k, v, len_ptr, len_val, s, hk, g, dh, nsplit, part, tickets, out, st)
                : launch<T, 64, 1, 8>(q, k, v, len_ptr, len_val, s, hk, g, dh, nsplit, part, tickets, out, st);
  } else {  // tiles of 128 positions, 64 past 256-byte rows
    if (dh_pad > 128)
      return four ? launch<T, 64, 2, 4>(q, k, v, len_ptr, len_val, s, hk, g, dh, nsplit, part, tickets, out, st)
                  : launch<T, 64, 2, 8>(q, k, v, len_ptr, len_val, s, hk, g, dh, nsplit, part, tickets, out, st);
    return four ? launch<T, 128, 1, 4>(q, k, v, len_ptr, len_val, s, hk, g, dh, nsplit, part, tickets, out, st)
                : launch<T, 128, 1, 8>(q, k, v, len_ptr, len_val, s, hk, g, dh, nsplit, part, tickets, out, st);
  }
}

}  // namespace

extern "C" int flash_decode_heads_per_block() { return kHeads; }
extern "C" int flash_decode_max_dh() { return kMaxDh; }

// Position splits per kv-head block for this card and shape (dtype 0 = f32,
// 1 = bf16); the scratch sizes follow from it.
extern "C" int flash_decode_splits(int s, int hk, int g, int dh, int dtype) {
  const int tp = dtype == 0 ? tile_of<float>(dh) : tile_of<__nv_bfloat16>(dh);
  return splits(s, hk, (g + kHeads - 1) / kHeads, tp);
}

// dtype 0 = f32, 1 = bf16. s > 0, 0 < dh <= 256, g = h / hk, nsplit from
// flash_decode_splits. Scratch: part holds hk * ceil(g / kHeads) * nsplit *
// kHeads * (dh + 2) floats; tickets hk * ceil(g / kHeads) unsigned ints, all
// 0 before the first call (each call leaves them 0). len_ptr (a device
// int32) wins over len_val when it is not null.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* len_ptr, int len_val, int s, int hk,
                            int g, int dh, int dtype, int nsplit, float* part,
                            unsigned* tickets, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, len_ptr, len_val, s, hk, g, dh, nsplit,
                           part, tickets, out, st);
  return dispatch<__nv_bfloat16>(q, k, v, len_ptr, len_val, s, hk, g, dh,
                                 nsplit, part, tickets, out, st);
}
