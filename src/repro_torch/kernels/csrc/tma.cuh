// Hopper's asynchronous copy engine (TMA) and shared-memory barriers
// (mbarrier), as used by label_stats.cuh, assign_pipe.cuh and flash_decode.cu.
//
// A tensor map describes a tiled view of a tensor in device memory; one
// thread asks for a whole box to be copied into shared memory, and the copy
// reports its bytes to an mbarrier there. The map is built on the host by
// the driver's cuTensorMapEncodeTiled, fetched through the runtime
// (cudaGetDriverEntryPoint) so the libraries link against cudart alone, and
// passed to the kernel by value as a __grid_constant__ parameter.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace repro {

// Element type codes of the C entries' matrices (document rows f32 or bf16;
// kElemSplit3: f32 centers as three bf16 parts, the bf16 mode of
// assign_argmax, assign_stats and assign_stats_bounded).
constexpr int kElemF32 = 0, kElemBf16 = 1, kElemSplit3 = 2;

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map of `rank` dims (innermost first) of elements of `type`
// (FLOAT32, or BFLOAT16 for bf16 document rows): dims[i] elements, strides
// in bytes of dims 1.. (each a multiple of 16), box[i] elements a copy.
// Positions outside the tensor arrive as zeros. Returns 0 or a CUDA error.
inline int make_tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                           int rank, const void* base, const cuuint64_t* dims,
                           const cuuint64_t* strides, const cuuint32_t* box,
                           CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  // cuTensorMapEncodeTiled needs a context current in this thread. A thread whose
  // CUDA work so far only reused cached memory has none yet (the runtime
  // binds one at its first launch), so bind the current device's primary
  // context here, as that launch would.
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Allow `kernel` up to `bytes` of dynamic shared memory on the current
// device (past 48 KB it must be asked for), once per device: `done` holds a
// bit per device and must live in the calling library (a variable of an
// inline function here would be one variable for every library loaded).
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && (done >> dev & 1u)) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32) done |= 1u << dev;
  return 0;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the copy engine.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Add `bytes` to the transactions the current phase waits for, without
// arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// 4-byte asynchronous copy into shared memory (zeros where src_bytes is 0),
// and an arrival on `bar` once this thread's earlier such copies have landed
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 16-byte asynchronous copy (zeros where src_bytes is 0), bypassing L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait until this thread's asynchronous copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A producer lane's arrival on a stage's barrier: once its asynchronous
// copies land (cp_async_arrive), or, where the lane also wrote the stage
// with plain stores (rows of 2-byte bf16 elements that no asynchronous copy
// takes), after waiting for those copies, by an arrival whose release
// publishes the stores with them.
__device__ __forceinline__ void producer_arrive(uint64_t* bar, bool stored) {
  if (stored) {
    cp_async_wait_all();
    mbar_arrive(bar);
  } else {
    cp_async_arrive(bar);
  }
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// One contiguous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) by the copy engine, reported to `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

}  // namespace repro
