// Hopper (sm_90a) building blocks shared by the kernels that run a TMA ring
// into wgmma (flash_fwd_sm90.cu, bf16; flash_int8_sm90.cu, int8): mbarrier
// phases, 4-D TMA tile loads, wgmma shared-memory descriptors, fences and
// groups, named barriers, setmaxnreg, and the driver entry point that
// encodes tensor maps.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// [fences] blocks until the phase of parity `parity` has completed: a fresh
// barrier is in phase 0, so waiting on parity 0 waits for its first
// completion and waiting on parity 1 passes (the producer's first pass over
// the empty barriers). Each side flips its parity when its stage index wraps.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
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

// One box of a 4-D map into shared memory, coordinates innermost first (the
// bf16 kernel's maps: column, head, row, batch); the barrier counts its
// bytes, zero-filled ones included.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
// K-major (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO);
// LBO unused. A k16 step inside a box adds 32 bytes to the start address
// (the box is 1024-aligned, so the swizzle phase stays 0).
// MN-major (V): LBO = bytes between 64-column boxes, SBO = 1024 bytes
// between 8-key groups; a k16 step adds 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// K-major descriptor for rows of 64 or 128 bytes under the TMA swizzle of the
// same width (layout type 2: 64-byte, 1: 128-byte): 8-row groups 8 *
// row_bytes apart (SBO), LBO unused. A 32-byte k step inside a row adds 32
// to the start address (tiles are 1024-aligned: the swizzle phase stays 0).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr, uint32_t row_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * row_bytes) >> 4) << 32) |
         (static_cast<uint64_t>(row_bytes == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Named barriers over the 256 consumer threads of two warpgroups: one
// warpgroup syncs, the other arrives, or both sync (never id 0:
// __syncthreads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// [tensor maps] cuTensorMapEncodeTiled is a driver-API call; the runtime
// hands out its entry point, so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace sm90
