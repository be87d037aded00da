// int8 projections for Hopper (sm_90a): per-row int8 quantize and the row pass
// of the int8 GEMM's quantized outputs.
//
//   * quant_rows replaces the TPU kernel
//     transparent_object_detection_tpu/ops/quant_matmul.py::_quant_rows_kernel
//     in both its launches: qmax 127 (via _pquant_call) and qmax 7, the
//     int4-range activations of the w4a4 mlp1 (via _w4a4_call). bf16 or
//     fp32 (M, K) -> int8 (M, K) + f32 (M, 1), optionally
//     LayerNorm-normalized first (d = x - mean, var = max(E[x^2] - mean^2,
//     0), rsqrt folded into the scale). One warp per row; bf16 rows whose K
//     is a multiple of 8 in 16-byte loads, any other row (K = 849, fp32)
//     element by element.
//   * the int8 GEMM itself (ops/quant_matmul.py::_qmm_kernel) is
//     csrc/qmm_sm90.cu; it writes the quantized outputs' fp32 workspace.
//   * qmm_rows_out is the quantized outputs' row pass over that workspace:
//     quant_out (int8 + one scale per (row, group of `group` columns)) or
//     ln_out (bf16 value + LN-normalized int8 + per-row scale). Their
//     statistics span a whole row or group, wider than one GEMM block's tile,
//     and must come from the fp32 value: the GEMM writes fp32 (M, N) and one
//     block per row reduces and quantizes it (the row in registers up to
//     8,192 columns, else read again from the workspace). At batch 32 the
//     largest phi='s' workspace is h2's mlp1, 204,800 x 6,144 fp32 = 5.0 GB.
// Rounding is half to even (rintf), as jnp.round; activations, outputs and q
// are quantized by a reciprocal multiply d * (qmax / amax), as in JAX.
//
// Bound: both kernels move bytes (each row read once, or twice where it does
// not fit in registers, and written once as int8).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INV127 = (float)(1.0 / 127.0);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

__device__ __forceinline__ int8_t q8(float v) { return static_cast<int8_t>(__float2int_rn(v)); }

// ---------------------------------------------------------------------------
// quant_rows: one warp per row, 8 rows per block; 8 bf16 per 16-byte load.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) quant_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                                         int8_t* __restrict__ xq,
                                                         float* __restrict__ xs, int m, int k,
                                                         int ln, float eps, float qmax,
                                                         float inv_qmax) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= m) return;
  const __nv_bfloat16* xr = x + (long long)row * k;
  const int chunks = k / 8;
  auto load8 = [&](int c, float (&f)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  };
  float mu = 0.f, rstd = 1.f, amax = 0.f;
  if (ln) {
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      float f[8];
      load8(c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s += f[i];
        s2 += f[i] * f[i];
      }
    }
    mu = warp_sum(s) / k;
    const float m2 = warp_sum(s2) / k;
    rstd = rsqrtf(fmaxf(m2 - __fmul_rn(mu, mu), 0.f) + eps);
  }
  for (int c = lane; c < chunks; c += 32) {
    float f[8];
    load8(c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i] - mu));
  }
  amax = fmaxf(warp_max(amax), 1e-12f);
  const float inv = qmax / amax;
  for (int c = lane; c < chunks; c += 32) {
    float f[8];
    load8(c, f);
    char4 lo, hi;
    lo.x = q8((f[0] - mu) * inv); lo.y = q8((f[1] - mu) * inv);
    lo.z = q8((f[2] - mu) * inv); lo.w = q8((f[3] - mu) * inv);
    hi.x = q8((f[4] - mu) * inv); hi.y = q8((f[5] - mu) * inv);
    hi.z = q8((f[6] - mu) * inv); hi.w = q8((f[7] - mu) * inv);
    char4* dst = reinterpret_cast<char4*>(xq + (long long)row * k + c * 8);
    dst[0] = lo;
    dst[1] = hi;
  }
  if (lane == 0) xs[row] = amax * inv_qmax * rstd;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// quant_rows on any row: element by element, bf16 or fp32.
template <typename T>
__global__ void __launch_bounds__(256) quant_rows_any_kernel(const T* __restrict__ x,
                                                             int8_t* __restrict__ xq,
                                                             float* __restrict__ xs, int m,
                                                             int k, int ln, float eps,
                                                             float qmax, float inv_qmax) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* xr = x + (long long)row * k;
  float mu = 0.f, rstd = 1.f, amax = 0.f;
  if (ln) {
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float f = to_f32(xr[c]);
      s += f;
      s2 += f * f;
    }
    mu = warp_sum(s) / k;
    const float m2 = warp_sum(s2) / k;
    rstd = rsqrtf(fmaxf(m2 - __fmul_rn(mu, mu), 0.f) + eps);
  }
  for (int c = lane; c < k; c += 32) amax = fmaxf(amax, fabsf(to_f32(xr[c]) - mu));
  amax = fmaxf(warp_max(amax), 1e-12f);
  const float inv = qmax / amax;
  int8_t* dst = xq + (long long)row * k;
  for (int c = lane; c < k; c += 32) dst[c] = q8((to_f32(xr[c]) - mu) * inv);
  if (lane == 0) xs[row] = amax * inv_qmax * rstd;
}

// ---------------------------------------------------------------------------
// row pass of the quantized outputs: one block of 256 threads per row, the
// row's float4 chunks in registers (N <= 8,192).
// ---------------------------------------------------------------------------
constexpr int ROW_THREADS = 256;
constexpr int ROW_CHUNKS = 8;   // float4 chunks a thread holds: N <= 8 * 4 * 256
constexpr int MAX_GROUPS = 64;

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < ROW_THREADS / 32; ++w) t += red[w];
  return t;
}
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < ROW_THREADS / 32; ++w) t = fmaxf(t, red[w]);
  return t;
}

__global__ void __launch_bounds__(ROW_THREADS) rows_out_kernel(
    const float* __restrict__ val, int8_t* __restrict__ payload, float* __restrict__ scales,
    __nv_bfloat16* __restrict__ value, int n, int group, int ln, float eps) {
  __shared__ float red[ROW_THREADS / 32];
  __shared__ int gmax[MAX_GROUPS];
  const long long row = blockIdx.x;
  const int nch = n / 4;
  const float4* src = reinterpret_cast<const float4*>(val + row * n);
  float4 v[ROW_CHUNKS];
#pragma unroll
  for (int i = 0; i < ROW_CHUNKS; ++i) {
    const int c = threadIdx.x + i * ROW_THREADS;
    v[i] = c < nch ? src[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  char4* dst = reinterpret_cast<char4*>(payload + row * n);
  if (ln) {
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < ROW_CHUNKS; ++i) {
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
      s2 += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
    }
    const float mu = block_sum(s, red) / n;
    const float m2 = block_sum(s2, red) / n;
    const float rstd = rsqrtf(fmaxf(m2 - __fmul_rn(mu, mu), 0.f) + eps);
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < ROW_CHUNKS; ++i) {
      if (threadIdx.x + i * ROW_THREADS < nch) {
        a = fmaxf(a, fmaxf(fmaxf(fabsf(v[i].x - mu), fabsf(v[i].y - mu)),
                           fmaxf(fabsf(v[i].z - mu), fabsf(v[i].w - mu))));
      }
    }
    const float amax = fmaxf(block_max(a, red), 1e-12f);
    const float inv = 127.f / amax;
    __nv_bfloat162* vo = reinterpret_cast<__nv_bfloat162*>(value + row * n);
#pragma unroll
    for (int i = 0; i < ROW_CHUNKS; ++i) {
      const int c = threadIdx.x + i * ROW_THREADS;
      if (c < nch) {
        dst[c] = make_char4(q8((v[i].x - mu) * inv), q8((v[i].y - mu) * inv),
                            q8((v[i].z - mu) * inv), q8((v[i].w - mu) * inv));
        if (value) {
          vo[2 * c] = __floats2bfloat162_rn(v[i].x, v[i].y);
          vo[2 * c + 1] = __floats2bfloat162_rn(v[i].z, v[i].w);
        }
      }
    }
    if (threadIdx.x == 0) scales[row] = amax * INV127 * rstd;
    return;
  }
  const int groups = n / group;
  for (int g = threadIdx.x; g < groups; g += ROW_THREADS) gmax[g] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ROW_CHUNKS; ++i) {
    const int c = threadIdx.x + i * ROW_THREADS;
    if (c < nch) {
      const float a = fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                            fmaxf(fabsf(v[i].z), fabsf(v[i].w)));
      atomicMax(&gmax[(c * 4) / group], __float_as_int(a));  // a >= 0: int order = float order
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ROW_CHUNKS; ++i) {
    const int c = threadIdx.x + i * ROW_THREADS;
    if (c < nch) {
      const float amax = fmaxf(__int_as_float(gmax[(c * 4) / group]), 1e-30f);
      const float inv = 127.f / amax;
      dst[c] = make_char4(q8(v[i].x * inv), q8(v[i].y * inv), q8(v[i].z * inv),
                          q8(v[i].w * inv));
    }
  }
  for (int g = threadIdx.x; g < groups; g += ROW_THREADS)
    scales[row * groups + g] = fmaxf(__int_as_float(gmax[g]), 1e-30f) * INV127;
}

// The row pass on any row: the row read again from the workspace for each
// statistic, groups one after another.
__global__ void __launch_bounds__(ROW_THREADS) rows_out_any_kernel(
    const float* __restrict__ val, int8_t* __restrict__ payload, float* __restrict__ scales,
    __nv_bfloat16* __restrict__ value, int n, int group, int ln, float eps) {
  __shared__ float red[ROW_THREADS / 32];
  const long long row = blockIdx.x;
  const float* src = val + row * n;
  int8_t* dst = payload + row * n;
  if (ln) {
    float s = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < n; c += ROW_THREADS) {
      s += src[c];
      s2 += src[c] * src[c];
    }
    const float mu = block_sum(s, red) / n;
    const float m2 = block_sum(s2, red) / n;
    const float rstd = rsqrtf(fmaxf(m2 - __fmul_rn(mu, mu), 0.f) + eps);
    float a = 0.f;
    for (int c = threadIdx.x; c < n; c += ROW_THREADS) a = fmaxf(a, fabsf(src[c] - mu));
    const float amax = fmaxf(block_max(a, red), 1e-12f);
    const float inv = 127.f / amax;
    for (int c = threadIdx.x; c < n; c += ROW_THREADS) {
      dst[c] = q8((src[c] - mu) * inv);
      if (value) value[row * n + c] = __float2bfloat16_rn(src[c]);
    }
    if (threadIdx.x == 0) scales[row] = amax * INV127 * rstd;
    return;
  }
  const int groups = n / group;
  for (int g = 0; g < groups; ++g) {
    float a = 0.f;
    for (int c = g * group + threadIdx.x; c < (g + 1) * group; c += ROW_THREADS)
      a = fmaxf(a, fabsf(src[c]));
    const float amax = fmaxf(block_max(a, red), 1e-30f);
    const float inv = 127.f / amax;
    for (int c = g * group + threadIdx.x; c < (g + 1) * group; c += ROW_THREADS)
      dst[c] = q8(src[c] * inv);
    if (threadIdx.x == 0) scales[row * groups + g] = amax * INV127;
  }
}

}  // namespace

extern "C" {

// bf16 (x_f32 = 0) or fp32 (m, k) -> int8 (m, k) on [-qmax, qmax], f32
// (m, 1). qmax 127 (int8) or 7 (the int4 range of w4a4), inv_qmax = 1 /
// qmax rounded to f32 from double, as JAX rounds its weakly typed constant.
int quant_rows(const void* x, void* xq, void* xs, int m, int k, int ln, float eps, float qmax,
               float inv_qmax, int x_f32, void* stream) {
  if (k <= 0 || !(qmax == 127.f || qmax == 7.f)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  if (x_f32) {
    quant_rows_any_kernel<float><<<(m + 7) / 8, 256, 0, st>>>(
        static_cast<const float*>(x), q, s, m, k, ln, eps, qmax, inv_qmax);
  } else if (k % 8 == 0) {
    quant_rows_kernel<<<(m + 7) / 8, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x), q, s,
                                                   m, k, ln, eps, qmax, inv_qmax);
  } else {
    quant_rows_any_kernel<__nv_bfloat16><<<(m + 7) / 8, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q, s, m, k, ln, eps, qmax, inv_qmax);
  }
  return static_cast<int>(cudaGetLastError());
}

// Row pass over the fp32 (m, n) GEMM output: ln = 0, quant_out (int8 payload,
// scales (m, n / group)); ln = 1, ln_out (bf16 value, or none when value is
// null, LN-normalized payload, scales (m, 1)).
int qmm_rows_out(const void* val, void* payload, void* scales, void* value, int m, int n,
                 int group, int ln, float eps, void* stream) {
  if (n <= 0 || group <= 0 || n % group) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(val);
  int8_t* q = static_cast<int8_t*>(payload);
  float* s = static_cast<float*>(scales);
  __nv_bfloat16* vo = static_cast<__nv_bfloat16*>(value);
  if (n % 4 == 0 && group % 4 == 0 && n <= ROW_CHUNKS * 4 * ROW_THREADS &&
      n / group <= MAX_GROUPS) {
    rows_out_kernel<<<m, ROW_THREADS, 0, st>>>(v, q, s, vo, n, group, ln, eps);
  } else {
    rows_out_any_kernel<<<m, ROW_THREADS, 0, st>>>(v, q, s, vo, n, group, ln, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
