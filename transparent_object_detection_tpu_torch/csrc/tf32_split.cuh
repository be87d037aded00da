// The pre-pass and tensor maps shared by the two fp32 kernels that take each
// fp32 product as three tf32 products on the tensor cores
// (flash_fwd_f32_sm90.cu, flash_bwd_f32_sm90.cu): x_hi is x with its 13 low
// mantissa bits cleared (a tf32 value), stored explicitly so that nothing
// rests on what the tensor core does with an operand's low bits, and x_lo =
// x - x_hi (exact in fp32).
//   * split_rows_kernel: hi and lo of a (B, N, w) view in its own layout;
//   * split_vt_kernel: hi and lo of a (B, N, heads * w) view transposed,
//     (B, heads, w, n_pad) with the tokens contiguous and the tokens of each
//     group of 8 in the order [0, 2, 4, 6, 1, 3, 5, 7] [token order], zero
//     past N;
//   * make_map_f32: a 4-D fp32 TMA map over either copy.
// [token order] The accumulator of a tf32 wgmma m64nNk8 gives a thread
// columns 2c and 2c + 1 of each 8-column chunk (c = lane % 4); the A
// fragment of the next product (registers, m64nNk8) wants columns c and
// c + 4. Stored in that order, the transposed copy (the product's B, whose
// contraction runs over the tokens) matches the accumulator as it stands:
// P or dS goes from registers into the product with no shuffle.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace tf32 {

constexpr uint32_t TF32_MASK = 0xffffe000u;  // clears the 13 low mantissa bits
constexpr int PRE_THREADS = 256;

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & TF32_MASK);
}

// hi and lo of a (B, N, w) view (row and batch strides in elements, multiples
// of 4, base 16-byte aligned) into contiguous (B, N, w); w % 4 == 0.
// Grid (ceil(w / 4 / PRE_THREADS), N, B).
__global__ void __launch_bounds__(PRE_THREADS) split_rows_kernel(
    const float* __restrict__ src, float* __restrict__ hi, float* __restrict__ lo, int n, int w,
    long long src_batch, long long src_row) {
  const int i = blockIdx.x * PRE_THREADS + threadIdx.x;
  if (4 * i >= w) return;
  const int row = blockIdx.y, b = blockIdx.z;
  const float4 x = *reinterpret_cast<const float4*>(src + b * src_batch + row * src_row + 4 * i);
  const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
  const long long at = (static_cast<long long>(b) * n + row) * w + 4 * i;
  *reinterpret_cast<float4*>(hi + at) = h;
  *reinterpret_cast<float4*>(lo + at) = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
}

// [token order] x (B, N, heads * w view) -> x^T hi and lo, (B, heads, w,
// n_pad) contiguous: row d of head h holds x[token][h * w + d] with the
// tokens of each group of 8 in the order [0, 2, 4, 6, 1, 3, 5, 7]; tokens at
// or past N are 0. Grid (n_pad / 32, ceil(w / 32), B * heads), block (32,
// 8): a 32-token x 32-column tile through shared memory.
__global__ void __launch_bounds__(256) split_vt_kernel(
    const float* __restrict__ v, float* __restrict__ vt_hi, float* __restrict__ vt_lo, int n,
    int n_pad, int heads, int dv, long long v_batch, long long v_row) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int bh = blockIdx.z, b = bh / heads, h = bh % heads;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* src = v + b * v_batch + static_cast<long long>(h) * dv;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int key = k0 + r, d = d0 + tx;
    tile[r][tx] = (key < n && d < dv) ? src[key * v_row + d] : 0.f;
  }
  __syncthreads();
  // position tx of a group of 8 holds key 2 tx (tx < 4) or 2 (tx - 4) + 1
  const int p = tx & 7;
  const int key = (tx & ~7) + (p < 4 ? 2 * p : 2 * p - 7);
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int d = d0 + r;
    if (d >= dv) continue;
    const float x = tile[key][r];
    const float xh = tf32_hi(x);
    const long long at = (static_cast<long long>(bh) * dv + d) * n_pad + k0 + tx;
    vt_hi[at] = xh;
    vt_lo[at] = x - xh;
  }
}

// Launchers of the two on `stream` (the caller checks cudaGetLastError).
inline void split_rows(const float* src, float* hi, float* lo, int batch, int n, int w,
                       long long src_batch, long long src_row, cudaStream_t stream) {
  const dim3 grid((w / 4 + PRE_THREADS - 1) / PRE_THREADS, n, batch);
  split_rows_kernel<<<grid, PRE_THREADS, 0, stream>>>(src, hi, lo, n, w, src_batch, src_row);
}
inline void split_vt(const float* src, float* hi, float* lo, int batch, int n, int n_pad,
                     int heads, int w, long long src_batch, long long src_row,
                     cudaStream_t stream) {
  split_vt_kernel<<<dim3(n_pad / 32, (w + 31) / 32, batch * heads), dim3(32, 8), 0, stream>>>(
      src, hi, lo, n, n_pad, heads, w, src_batch, src_row);
}

// [tensor maps] a 4-D fp32 map, dims innermost first with strides in
// elements (each a multiple of 4: 16 bytes), boxes of box0 x box1 x box2 x 1
// under the swizzle of the box row's width (64 or 128 bytes); TMA
// zero-fills what lies outside the dims.
inline bool make_map_f32(CUtensorMap* map, const void* base, const long long (&dims)[4],
                         const long long (&strides)[3], int box0, int box1, int box2) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  cuuint64_t d[4], s[3];
  for (int i = 0; i < 4; ++i) d[i] = static_cast<cuuint64_t>(dims[i]);
  for (int i = 0; i < 3; ++i) {
    if (strides[i] % 4) return false;
    s[i] = static_cast<cuuint64_t>(strides[i]) * 4;
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1),
                             static_cast<cuuint32_t>(box2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), d, s, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box0 * 4 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tf32
