// Building blocks shared by the bf16 flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): cp.async tile loads into padded
// shared-memory tiles, ldmatrix fragment loads and the mma.sync m16n8k16
// bf16 product with fp32 accumulation. Both sources run 128 threads (4 warps
// of 16 rows) a block.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int THREADS = 128;
constexpr int DVT = 256;    // v columns one block accumulates
constexpr int PAD = 8;      // bf16 row padding in shared memory (bank spread)
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination (rows past N).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows x COLS bf16 tile from global (row stride `stride`) into shared memory
// (row stride COLS + PAD); rows at or past `rows_valid` are zero-filled.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int stride, int rows_valid) {
  constexpr int CHUNKS = COLS / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool valid = r < rows_valid;
    cp_async16(dst + r * (COLS + PAD) + c, src + (valid ? (long long)r * stride : 0) + c,
               valid);
  }
}

// rows x COLS bf16 tile from global into shared memory (row stride
// COLS + PAD), reading only columns [0, cols_valid) of rows [0, rows_valid);
// the rest is zero-filled. cols_valid is a multiple of 8.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile_cols(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int stride, int rows_valid, int cols_valid) {
  constexpr int CHUNKS = COLS / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool valid = r < rows_valid && c < cols_valid;
    cp_async16(dst + r * (COLS + PAD) + c, src + (valid ? (long long)r * stride + c : 0),
               valid);
  }
}

}  // namespace flash
