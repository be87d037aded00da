// int8 projections for Hopper (sm_90a): per-row int8 quantize and the row pass
// of the int8 GEMM's quantized outputs.
//
//   * quant_rows replaces the TPU kernel
//     transparent_object_detection_tpu/ops/quant_matmul.py::_quant_rows_kernel
//     in both its launches: qmax 127 (via _pquant_call) and qmax 7, the
//     int4-range activations of the w4a4 mlp1 (via _w4a4_call). bf16 or
//     fp32 (M, K) -> int8 (M, K) + f32 (M, 1), optionally
//     LayerNorm-normalized first (d = x - mean, var = max(E[x^2] - mean^2,
//     0), rsqrt folded into the scale). One kernel for both input types:
//     a team of threads a row, the row read once into registers in 16-byte
//     loads and written in 16-byte stores whatever K is (below): at parity
//     with the first kernels at phi 'n' and 's' in device time, 21% faster
//     at phi='m' (PERF.md).
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
// not fit in registers, and written once as int8). quant_rows' first kernels
// (one warp a row, the row read two or three times, L1 serving the re-reads;
// fp32 and K off the 8 grid element by element) ran at 65-87% of that
// bound in device time at the phi 'n' and 's' shapes and 49-60% at phi='m';
// the 14-20% once read on CUDA events was the host's time to enqueue a
// launch (PERF.md).
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
// quant_rows: a team of 8 to 256 threads a row, the row read once.
//
// The row's elements are taken in units of 16 (32 bytes of bf16, 64 of
// fp32: two or four 16-byte loads; one 16-byte int8 store), aligned in the
// flattened (m, k) array rather than in the row, so that every load and
// store is aligned whatever k is (k = 849 at phi='n': rows start at any
// byte). A unit that straddles two rows is read by both teams, each masking
// the other row's elements, and written byte by byte. Thread `tid` of a
// team holds units tid, tid + team, ... of its row in registers (UPT of
// them): the LN statistics, the amax and the payload all come from that
// one copy; rows of a multiple of 16 (every route's but phi='n''s 849)
// take a form with no masks. Team and units are the caller's
// (ops/quant_matmul.py::quant_rows_team), picked by measurement at every
// launch shape of the phi n/s/m int8 forwards: 4 units a thread in bf16, 2
// in fp32, on the smallest team that covers the row (PERF.md). Rows too
// wide for 8 (bf16) or 4 (fp32) units a thread of a 256-thread team (k past
// 32,768 bf16 or 16,384 fp32, beyond every route) are streamed from memory
// once per statistic (UPT = 0). One block of 256 threads a QR_THREADS /
// team rows.
// ---------------------------------------------------------------------------
constexpr int QR_THREADS = 256;
constexpr int UNIT = 16;  // elements of a unit: one 16-byte int8 store

template <typename T>
__device__ __forceinline__ void unit_floats(const uint4 (&raw)[sizeof(T)], float (&f)[UNIT]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      f[4 * p] = __uint_as_float(raw[p].x);
      f[4 * p + 1] = __uint_as_float(raw[p].y);
      f[4 * p + 2] = __uint_as_float(raw[p].z);
      f[4 * p + 3] = __uint_as_float(raw[p].w);
    }
  } else {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[p]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[8 * p + 2 * i] = t.x;
        f[8 * p + 2 * i + 1] = t.y;
      }
    }
  }
}

// Rows of k elements, team threads a row (8 to 256, a power of two), UPT
// units a thread held in registers (0: streamed). d = x - mean (LN) or x;
// amax = max(max |d|, 1e-12); payload rint(d * (qmax / amax)); scale amax *
// inv_qmax * rstd (rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps), else 1).
// ALIGNED: k a multiple of UNIT, so that every unit lies whole in one row
// and no element is masked.
template <typename T, int UPT, bool ALIGNED>
__global__ void __launch_bounds__(QR_THREADS) quant_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, long long m,
    int k, int team, int ln, float eps, float qmax, float inv_qmax) {
  constexpr int P = sizeof(T);          // 16-byte pieces a unit
  constexpr int PER = UNIT / P;         // elements a piece
  __shared__ float red[2][QR_THREADS / 32];
  const int rpb = QR_THREADS / team;    // rows a block takes at a time
  const int slot = threadIdx.x / team, tid = threadIdx.x % team;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int team_warps = team / 32, first_warp = slot * team_warps;
  const int width = min(team, 32);      // lanes of a team within a warp
  const uint4* xv = reinterpret_cast<const uint4*>(x);

  // within a warp: the team's lanes (a team of 8 or 16 is an aligned group
  // of lanes, which xor offsets below its width never leave)
  auto lanes_sum = [&](float v) {
    for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
    return v;
  };
  auto lanes_max = [&](float v) {
    for (int o = width / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
    return v;
  };
  // the team's sum of a and of b (team > 32: through shared memory, in
  // warp order, the same bits every run)
  auto team_sum2 = [&](float& a, float& b) {
    a = lanes_sum(a);
    b = lanes_sum(b);
    if (team > 32) {
      __syncthreads();
      if (lane == 0) {
        red[0][warp] = a;
        red[1][warp] = b;
      }
      __syncthreads();
      a = b = 0.f;
      for (int w = 0; w < team_warps; ++w) {
        a += red[0][first_warp + w];
        b += red[1][first_warp + w];
      }
    }
  };
  auto team_max = [&](float a) {
    a = lanes_max(a);
    if (team > 32) {
      __syncthreads();
      if (lane == 0) red[0][warp] = a;
      __syncthreads();
      a = 0.f;
      for (int w = 0; w < team_warps; ++w) a = fmaxf(a, red[0][first_warp + w]);
    }
    return a;
  };

  // the loop runs the same number of turns in every thread of the block
  // (the team reductions synchronise it)
  for (long long base = (long long)blockIdx.x * rpb; base < m; base += (long long)gridDim.x * rpb) {
    const long long row = base + slot;
    const bool live = row < m;
    const long long lo = row * k, hi = lo + k;  // the row's elements in the flat array
    const long long u0 = lo / UNIT, u1 = live ? (hi - 1) / UNIT : u0 - 1;  // its units
    // a unit's elements [a, b) that are the row's
    auto span = [&](long long u, int& a, int& b) {
      if constexpr (ALIGNED) {
        a = 0;
        b = UNIT;
      } else {
        a = static_cast<int>(max(lo - u * UNIT, 0ll));
        b = static_cast<int>(min(hi - u * UNIT, (long long)UNIT));
      }
    };
    // a unit's pieces, those that hold an element of the row (a piece that
    // holds one lies in the tensor's 16-byte granules)
    auto load = [&](long long u, uint4 (&r)[P]) {
      int a, b;
      span(u, a, b);
#pragma unroll
      for (int p = 0; p < P; ++p)
        r[p] = ((p + 1) * PER > a && p * PER < b) ? xv[u * P + p] : make_uint4(0, 0, 0, 0);
    };
    uint4 raw[UPT > 0 ? UPT : 1][P];
    if constexpr (UPT > 0) {
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const long long u = u0 + tid + (long long)j * team;
        if (u <= u1) load(u, raw[j]);
      }
    }
    // fn(u, values, a, b) over this thread's units of the row
    auto visit = [&](auto&& fn) {
      if constexpr (UPT > 0) {
#pragma unroll
        for (int j = 0; j < UPT; ++j) {
          const long long u = u0 + tid + (long long)j * team;
          if (u > u1) break;
          float f[UNIT];
          unit_floats<T>(raw[j], f);
          int a, b;
          span(u, a, b);
          fn(u, f, a, b);
        }
      } else {
        for (long long u = u0 + tid; u <= u1; u += team) {
          uint4 r[P];
          load(u, r);
          float f[UNIT];
          unit_floats<T>(r, f);
          int a, b;
          span(u, a, b);
          fn(u, f, a, b);
        }
      }
    };

    float mu = 0.f, rstd = 1.f;
    if (ln) {
      float s = 0.f, s2 = 0.f;
      visit([&](long long, const float (&f)[UNIT], int a, int b) {
#pragma unroll
        for (int e = 0; e < UNIT; ++e)
          if (e >= a && e < b) {
            s += f[e];
            s2 += f[e] * f[e];
          }
      });
      team_sum2(s, s2);
      mu = s / k;
      rstd = rsqrtf(fmaxf(s2 / k - __fmul_rn(mu, mu), 0.f) + eps);
    }
    float amax = 0.f;
    visit([&](long long, const float (&f)[UNIT], int a, int b) {
#pragma unroll
      for (int e = 0; e < UNIT; ++e)
        if (e >= a && e < b) amax = fmaxf(amax, fabsf(f[e] - mu));
    });
    amax = fmaxf(team_max(amax), 1e-12f);
    const float inv = qmax / amax;
    visit([&](long long u, const float (&f)[UNIT], int a, int b) {
      uint32_t w[UNIT / 4] = {0u, 0u, 0u, 0u};  // the unit's payload, 4 bytes a word
#pragma unroll
      for (int e = 0; e < UNIT; ++e)
        w[e / 4] |= (static_cast<uint32_t>(q8((f[e] - mu) * inv)) & 0xFFu) << (8 * (e % 4));
      if (a == 0 && b == UNIT) {
        *reinterpret_cast<uint4*>(xq + u * UNIT) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int e = 0; e < UNIT; ++e)
          if (e >= a && e < b) xq[u * UNIT + e] = static_cast<int8_t>(w[e / 4] >> (8 * (e % 4)));
      }
    });
    if (live && tid == 0) xs[row] = amax * inv_qmax * rstd;
  }
}

template <typename T, int UPT>
cudaError_t launch_quant_rows(const T* x, int8_t* q, float* s, long long m, int k, int team,
                              int ln, float eps, float qmax, float inv_qmax, cudaStream_t st) {
  const auto kernel = k % UNIT ? quant_rows_kernel<T, UPT, false> : quant_rows_kernel<T, UPT, true>;
  // one block a QR_THREADS / team rows: the hardware keeps as many resident
  // as fit and starts the next as one ends (a grid of the SMs' resident
  // blocks walking the rows measured the same)
  const long long rpb = QR_THREADS / team;
  const long long blocks = (m + rpb - 1) / rpb;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), QR_THREADS, 0, st>>>(x, q, s, m, k, team, ln, eps,
                                                               qmax, inv_qmax);
  return cudaGetLastError();
}

template <typename T>
cudaError_t quant_rows_of(const T* x, int8_t* q, float* s, long long m, int k, int team, int upt,
                          int ln, float eps, float qmax, float inv_qmax, cudaStream_t st) {
  switch (upt) {
    case 1: return launch_quant_rows<T, 1>(x, q, s, m, k, team, ln, eps, qmax, inv_qmax, st);
    case 2: return launch_quant_rows<T, 2>(x, q, s, m, k, team, ln, eps, qmax, inv_qmax, st);
    case 4: return launch_quant_rows<T, 4>(x, q, s, m, k, team, ln, eps, qmax, inv_qmax, st);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_quant_rows<T, 8>(x, q, s, m, k, team, ln, eps, qmax, inv_qmax, st);
      return cudaErrorInvalidValue;
    default: return launch_quant_rows<T, 0>(x, q, s, m, k, team, ln, eps, qmax, inv_qmax, st);
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

// bf16 (x_f32 = 0) or fp32 (m, k), any k, 16-byte aligned -> int8 (m, k) on
// [-qmax, qmax], f32 (m, 1). qmax 127 (int8) or 7 (the int4 range of w4a4),
// inv_qmax = 1 / qmax rounded to f32 from double, as JAX rounds its weakly
// typed constant. `team` threads a row holding `upt` units each
// (ops/quant_matmul.py::quant_rows_team: 8 to 256 threads, 1 to 8 units,
// 4 at most for fp32, covering the units a row spans; upt 0 streams the row
// from memory once per statistic). Anything else returns
// cudaErrorInvalidValue.
int quant_rows(const void* x, void* xq, void* xs, long long m, int k, int team, int upt, int ln,
               float eps, float qmax, float inv_qmax, int x_f32, void* stream) {
  const long long units = (k + UNIT - 1) / UNIT + (k % UNIT ? 1 : 0);  // a row spans at most
  const bool team_ok = team >= 8 && team <= QR_THREADS && (team & (team - 1)) == 0;
  const bool upt_ok = upt == 0 ||
                      ((upt == 1 || upt == 2 || upt == 4 || (upt == 8 && !x_f32)) &&
                       (long long)team * upt >= units);
  if (k <= 0 || m < 0 || !team_ok || !upt_ok || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16 || !(qmax == 127.f || qmax == 7.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  return static_cast<int>(
      x_f32 ? quant_rows_of(static_cast<const float*>(x), q, s, m, k, team, upt, ln, eps, qmax,
                            inv_qmax, st)
            : quant_rows_of(static_cast<const __nv_bfloat16*>(x), q, s, m, k, team, upt, ln, eps,
                            qmax, inv_qmax, st));
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
