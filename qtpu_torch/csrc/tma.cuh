// mbarrier, TMA and wgmma-operand helpers shared by the Hopper routes:
// dq_wgmma.cuh (K1, K7 and K9 at M > 8) and w8a8_matmul.cu (K6 at M > 8).
//
// Device side: the mbarrier waits and arrivals of a producer / consumer ring,
// the bulk and tensor (TMA) copies that complete on an mbarrier, and the
// wgmma descriptor of a K-major operand in 128-byte swizzled rows. Host
// side: cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint (the
// libraries are built without -lcuda), 2D tensor maps, and the SM count of
// a persistent grid. Everything has internal linkage (an anonymous
// namespace), so each library keeps its own copy and its own statics.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtpu {
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one arrival for the calling warp once all its lanes are here (the
// barriers count warps)
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte swizzled rows: 8-row
// core matrices 1024 bytes apart (SBO 64 x 16 B), LBO unused (1), layout 1
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// keeps the compiler from moving or reusing registers an asynchronous wgmma
// still reads (its A fragments) or writes (its accumulators)
template <int N>
__device__ __forceinline__ void wg_fence_u32(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ------------------------------------------------------------------ host

typedef CUresult (*TmapEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// An encode error is returned as 0x10000 | CUresult (a driver error, not a
// cudaError_t); 0x1ffff when the driver has no cuTensorMapEncodeTiled.
constexpr int kWgEncodeError = 0x10000;

TmapEncodeFn tmap_encoder() {
  static TmapEncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<TmapEncodeFn>(p);
  }
  return fn;
}

// The current device's SM count (the persistent grid), read once.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// A 2D row-major [outer, inner] tensor map with box [box_outer, box_inner].
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner,
              uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
              CUtensorMapSwizzle swizzle) {
  const TmapEncodeFn enc = tmap_encoder();
  if (enc == nullptr) return kWgEncodeError | 0xffff;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (kWgEncodeError | (int)r);
}

}  // namespace
}  // namespace qtpu
