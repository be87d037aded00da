// int8 projections for Hopper (sm_90a): per-row int8 quantize, int8 GEMM with
// the dequant epilogue, and the row pass of the quantized outputs.
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
//   * qmm replaces ops/quant_matmul.py::_qmm_kernel (via _qmm_call): int8 x
//     with G >= 1 scale groups per row (G > 1: the JAX prologue, each group
//     requantized onto the row's largest scale, round(x * s_g / s_max)), int8
//     weights (N, K) with per-column scales, int32 accumulation over all of K,
//     then out = acc * row_scale * w_scale (+ bias) (gelu tanh | silu)
//     (+ bf16 or fp32 residual, in fp32), stored as bf16 or fp32 (the fp32
//     models' output, and the quantized outputs' workspace). Any M and N:
//     rows and columns past the edge are zero-filled and not stored; K is a
//     multiple of 16 (16-byte rows; the wrapper zero-pads other K in a copy,
//     which leaves every dot product unchanged), its last slab masked.
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
// Bound. The serving path's GEMMs (M = B * {1,600, 6,400}, K x N = C x 3C,
// C x C, C x 4C, 4C x C at C = 1,536 / 2,048) do 2*M*K*N int8 operations and
// move ~M*(K + 2N) bytes: at batch 32 h2's mlp1 is 3.87 T operations
// (1.96 ms at the H100 SXM data sheet's 1,979 int8 TOPS) against ~1.6 GB
// (0.5 ms at 3.35 TB/s), bound by operations. quant_rows and the row pass
// are bound by bytes.
//
// Design. A GEMM block owns a 128 x 128 output tile, 8 warps of 64 x 32,
// and walks K in 64-byte slabs through a 3-stage cp.async ring; the products
// run on the tensor cores as mma.sync m16n8k32 s8 x s8 -> s32, fragments
// loaded with ldmatrix (an int8 row of 16 bytes is a b16 row of 8). The
// accumulator stays int32 across K, exact, so the kernel matches its plain
// version to the last bit up to the epilogue's own float ops. wgmma/TMA and
// a fused quantized epilogue are for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // tile; BK in int8 bytes
constexpr int STAGES = 3;
constexpr int THREADS = 256;                // 8 warps: 2 (M) x 4 (N)
constexpr int WM = 64, WN = 32;             // warp tile
constexpr int LDS = BK + 16;                // smem row stride, bytes
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr float INV127 = (float)(1.0 / 127.0);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a (16 x 32, row) * b (32 x 8, col); s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
// qmm: 128 x 128 tile per block, int32 accumulation over all of K.
// ---------------------------------------------------------------------------
struct QmmParams {
  const int8_t* xq;
  const float* xs;      // (M, G)
  const int8_t* wq;     // (N, K)
  const float* ws;      // (N,)
  const float* bias;    // (N,) or null
  const void* residual; // (M, N) bf16, or fp32 when res_f32; or null
  void* out;            // (M, N) bf16, or fp32 when out_f32
  int m, n, k, groups, act, out_f32, res_f32;
};

// EDGE: N or K is not a multiple of the tile (N % 128, K % 64): columns past
// N and bytes past K are zero-filled and not stored. Without it, the kernel
// is the aligned one (only rows past M are masked).
template <bool EDGE>
__device__ __forceinline__ void load_stage(unsigned char* st, const QmmParams& p, int m0,
                                           int n0, int kt) {
  // A: 128 rows x 64 bytes = 512 chunks of 16 bytes; B the same: 2 + 2 a thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c >> 2, col = (c & 3) * 16;
    if (EDGE) {
      const int kc = kt * BK + col;
      const bool a_ok = m0 + r < p.m && kc < p.k;
      const bool b_ok = n0 + r < p.n && kc < p.k;
      cp_async16(st + r * LDS + col, p.xq + (a_ok ? (long long)(m0 + r) * p.k + kc : 0), a_ok);
      cp_async16(st + (BM + r) * LDS + col,
                 p.wq + (b_ok ? (long long)(n0 + r) * p.k + kc : 0), b_ok);
    } else {
      const bool valid = m0 + r < p.m;
      cp_async16(st + r * LDS + col,
                 p.xq + (valid ? (long long)(m0 + r) * p.k : 0) + kt * BK + col, valid);
      cp_async16(st + (BM + r) * LDS + col, p.wq + (long long)(n0 + r) * p.k + kt * BK + col,
                 true);
    }
  }
}

template <bool EDGE>
__global__ void __launch_bounds__(THREADS) qmm_kernel(const QmmParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_row = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);  // BM row scales
  float* s_ratio = s_row + BM;  // G > 1: (BM, G) group scale / row scale
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int ktiles = (p.k + BK - 1) / BK;
  const int gwidth = p.k / p.groups;

  // row scale: the row's scale (G = 1) or its largest group scale (G > 1)
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    float s = 0.f;
    if (m0 + r < p.m) {
      const float* xs = p.xs + (long long)(m0 + r) * p.groups;
      s = xs[0];
      if (p.groups > 1) {
        for (int g = 1; g < p.groups; ++g) s = fmaxf(s, xs[g]);
        s = fmaxf(s, 1e-30f);
      }
    }
    s_row[r] = s;
    if (p.groups > 1)
      for (int g = 0; g < p.groups; ++g)
        s_ratio[r * p.groups + g] =
            m0 + r < p.m ? p.xs[(long long)(m0 + r) * p.groups + g] / s : 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage<EDGE>(smem + s * STAGE_BYTES, p, m0, n0, s);
    cp_async_commit();
  }

  int acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < ktiles)
      load_stage<EDGE>(smem + ((kt + STAGES - 1) % STAGES) * STAGE_BYTES, p, m0, n0,
                       kt + STAGES - 1);
    cp_async_commit();
    unsigned char* st = smem + (kt % STAGES) * STAGE_BYTES;

    if (p.groups > 1) {
      // requantize this slab's groups onto the row's largest scale, in place
      // (group widths are multiples of 4; bytes past K are 0 and stay 0)
#pragma unroll
      for (int i = 0; i < (BM * BK / 4) / THREADS; ++i) {
        const int w = threadIdx.x + i * THREADS;
        const int r = w / (BK / 4), c = (w % (BK / 4)) * 4;
        const int g = min((kt * BK + c) / gwidth, p.groups - 1);
        if (m0 + r < p.m) {
          const float ratio = s_ratio[r * p.groups + g];
          char4 v = *reinterpret_cast<char4*>(st + r * LDS + c);
          v.x = q8(static_cast<float>(v.x) * ratio);
          v.y = q8(static_cast<float>(v.y) * ratio);
          v.z = q8(static_cast<float>(v.z) * ratio);
          v.w = q8(static_cast<float>(v.w) * ratio);
          *reinterpret_cast<char4*>(st + r * LDS + c) = v;
        }
      }
      __syncthreads();
    }

    const unsigned char* sA = st + (wm * WM) * LDS;
    const unsigned char* sB = st + (BM + wn * WN) * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t a[WM / 16][4];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        ldsm_x4(a[i], sA + (i * 16 + (lane & 15)) * LDS + kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        uint32_t b[4];
        ldsm_x4(b, sB + (j * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDS + kk * 32 +
                       ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int i = 0; i < WM / 16; ++i) {
          mma_s8(acc[i][2 * j], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: rank-1 dequant, bias, activation, residual, store
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * WM + i * 16 + (lane >> 2) + h * 8;
      const int row = m0 + rl;
      if (row >= p.m) continue;
      const float rs = s_row[rl];
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = n0 + wn * WN + j * 8 + 2 * (lane & 3);
        if (EDGE && col >= p.n) continue;
        const int width = !EDGE || col + 1 < p.n ? 2 : 1;  // columns of the pair inside N
        float v[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (e >= width) break;
          // _rn intrinsics: no FMA contraction, the plain version's roundings
          float o = __fmul_rn(__fmul_rn(static_cast<float>(acc[i][j][2 * h + e]), rs),
                              p.ws[col + e]);
          if (p.bias) o = __fadd_rn(o, p.bias[col + e]);
          if (p.act == 1) {
            o = o * (0.5f * (1.f + tanhf(0.7978845608028654f * (o + 0.044715f * (o * o * o)))));
          } else if (p.act == 2) {
            o = o * (1.f / (1.f + expf(-o)));
          }
          v[e] = o;
        }
        const long long idx = (long long)row * p.n + col;
        // an even N keeps every pair aligned for one vector access
        const bool vec = width == 2 && (p.n & 1) == 0;
        if (p.residual && vec) {
          const float2 r =
              p.res_f32 ? *reinterpret_cast<const float2*>(static_cast<const float*>(p.residual) +
                                                            idx)
                        : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                              static_cast<const __nv_bfloat16*>(p.residual) + idx));
          v[0] = __fadd_rn(v[0], r.x);
          v[1] = __fadd_rn(v[1], r.y);
        } else if (p.residual) {
          for (int e = 0; e < width; ++e) {
            const float r = p.res_f32
                                ? static_cast<const float*>(p.residual)[idx + e]
                                : __bfloat162float(
                                      static_cast<const __nv_bfloat16*>(p.residual)[idx + e]);
            v[e] = __fadd_rn(v[e], r);
          }
        }
        if (p.out_f32) {
          float* o = static_cast<float*>(p.out) + idx;
          if (vec) {
            *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
          } else {
            for (int e = 0; e < width; ++e) o[e] = v[e];
          }
        } else {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + idx;
          if (vec) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
          } else {
            for (int e = 0; e < width; ++e) o[e] = __float2bfloat16_rn(v[e]);
          }
        }
      }
    }
  }
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

// int8 GEMM with the dequant epilogue. Any m, n; k % 16 == 0; groups == 1
// or k % groups == 0 with (k / groups) % 4 == 0; act 0 none, 1 gelu (tanh),
// 2 silu; out_f32 selects the fp32 output (the fp32 models', and the
// quantized modes' workspace); res_f32 an fp32 residual.
int qmm(const void* xq, const void* xs, const void* wq, const void* ws, const void* bias,
        const void* residual, void* out, int m, int n, int k, int groups, int act, int out_f32,
        int res_f32, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || groups < 1 ||
      (groups > 1 && (k % groups || (k / groups) % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  QmmParams p;
  p.xq = static_cast<const int8_t*>(xq);
  p.xs = static_cast<const float*>(xs);
  p.wq = static_cast<const int8_t*>(wq);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.residual = residual;
  p.out = out;
  p.m = m; p.n = n; p.k = k; p.groups = groups; p.act = act; p.out_f32 = out_f32;
  p.res_f32 = res_f32;
  const int smem = STAGES * STAGE_BYTES + BM * 4 * (1 + (groups > 1 ? groups : 0));
  auto kernel = (n % BN || k % BK) ? qmm_kernel<true> : qmm_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
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
