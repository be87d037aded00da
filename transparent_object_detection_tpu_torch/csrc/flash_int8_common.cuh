// Building blocks of the int8 flash-attention kernel (flash_int8_sm90.cu):
// the constants of the function and the q quantize pass that flash_mha_int8
// and flash_mha_int8_qout run before the attention kernel.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8attn {

constexpr float LOG2_127 = 6.988684686772166f;
constexpr float INV127 = (float)(1.0 / 127.0);

enum Out { OUT_BF16 = 0, OUT_F32 = 1, OUT_I8 = 2 };

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

// 16 bytes of q as floats: 8 bf16 or 4 fp32
__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

// q (bf16 or fp32, row stride q_row, head h at column h * dq) -> int8
// (B * N, heads * dq) and f32 scales (B * N, heads): one warp per (row,
// head), amax over the head's dq columns floored at 1e-12, rint(q * (127 /
// amax)), amax / 127; 16-byte loads (dq and q_row multiples of 16 bytes'
// worth of T).
template <typename T>
__global__ void __launch_bounds__(256) quant_q_kernel(const T* __restrict__ q, int q_row,
                                                      int rows, int heads, int dq,
                                                      int8_t* __restrict__ qq,
                                                      float* __restrict__ qs) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (item >= (long long)rows * heads) return;
  const long long row = item / heads;
  const int head = static_cast<int>(item % heads);
  const uint4* src = reinterpret_cast<const uint4*>(q + row * q_row + head * dq);
  const int nv = dq / VEC;
  float amax = 0.f;
  for (int c = lane; c < nv; c += 32) {
    float f[VEC];
    unpack16(src[c], f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
  amax = fmaxf(warp_max(amax), 1e-12f);
  const float inv = 127.f / amax;
  int8_t* dst = qq + row * heads * dq + head * dq;
  for (int c = lane; c < nv; c += 32) {
    float f[VEC];
    unpack16(src[c], f);
    __align__(8) int8_t o[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = static_cast<int8_t>(__float2int_rn(f[i] * inv));
    if (VEC == 8) {
      *reinterpret_cast<uint2*>(dst + c * VEC) = *reinterpret_cast<const uint2*>(o);
    } else {
      *reinterpret_cast<uint32_t*>(dst + c * VEC) = *reinterpret_cast<const uint32_t*>(o);
    }
  }
  if (lane == 0) qs[item] = amax * INV127;
}

inline cudaError_t quant_q(const void* q, int q_f32, int q_row, int rows, int heads, int dq,
                           void* qq, void* qs, cudaStream_t stream) {
  if (q_row % (q_f32 ? 4 : 8) || dq % 32) return cudaErrorInvalidValue;  // 16-byte loads
  const long long items = (long long)rows * heads;
  const unsigned blocks = static_cast<unsigned>((items + 7) / 8);
  if (q_f32)
    quant_q_kernel<float><<<blocks, 256, 0, stream>>>(static_cast<const float*>(q), q_row, rows,
                                                      heads, dq, static_cast<int8_t*>(qq),
                                                      static_cast<float*>(qs));
  else
    quant_q_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), q_row, rows, heads, dq, static_cast<int8_t*>(qq),
        static_cast<float*>(qs));
  return cudaGetLastError();
}

}  // namespace int8attn
