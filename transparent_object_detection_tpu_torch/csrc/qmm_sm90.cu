// int8 GEMM with the dequant epilogue for Hopper (sm_90a): int8 wgmma fed by
// a TMA ring; a block of two consumer warpgroups, two epilogue warpgroups and
// one producer warpgroup.
//
// Replaces the TPU kernel
// transparent_object_detection_tpu/ops/quant_matmul.py::_qmm_kernel (launched
// by _qmm_call) at every call: every int8 TEB projection of the int8, A, B
// and fp32-int8 serving paths (qkv C x 3C, attn_out C x C, mlp1 C x 4C, mlp2
// 4C x C at h1, h2, h4, h6) and any M, N, K the wrapper admits
// (ops/quant_matmul.py::kernel_supports).
//
// The function (ops/quant_matmul.py::qmm_plain computes the same):
//   * x int8 (M, K) with f32 scales (M, G); G > 1: each group of K / G
//     columns is first requantized onto the row's largest scale,
//     rint(x * (s_g / s_max)), s_max = max(max_g s_g, 1e-30) (_requant);
//   * acc = sum over all of K of x * w, exact in int32 (|acc| <= K * 127^2);
//   * out = acc * row_scale * w_scale[n] (+ bias[n]) (gelu tanh | silu)
//     (+ residual, bf16 or fp32, added in fp32), each product and sum
//     rounded on its own (_rn: no FMA contraction), stored as bf16 or fp32
//     (the fp32 models' output, and the workspace of the quantized outputs,
//     whose row pass is csrc/quant_matmul.cu::qmm_rows_out).
//
// Bound. 2 * M * K * N int8 operations at the data sheet's 1,979 TOPS
// against ~M * (K + 2N) bytes at 3.35 TB/s: bound by operations at every
// serving site (phi='m' h2 mlp1 at batch 2: 0.97 T operations, 0.49 ms,
// against 0.40 GB, 0.12 ms).
//
// Design, point by point against the mma.sync kernel it replaces:
//   * Products. wgmma.mma_async m64nBNk32 .s32.s8.s8 (wgmma_s8.cuh), both
//     operands K-major in shared memory under the 128-byte TMA swizzle:
//     consumer warpgroup w owns rows 64w .. 64w + 63 of a 128-row tile and
//     all BN columns (BN 128 or 64: 64 or 32 int32 registers a thread).
//     setmaxnreg shares the block's 640 x 96 registers: 136 a consumer
//     thread, 80 an epilogue thread, 40 a producer thread.
//   * Loads. One producer thread keeps a ring of `stages` (4 at BN 128, 7
//     at 64) K slabs of 128 bytes in flight, A (128 rows) and B (BN rows)
//     of a slab in one stage, each stage a full/empty mbarrier pair: no
//     __syncthreads in the K loop; a slab's wgmma group stays in flight
//     while the next is issued, and its stage is released as it retires.
//     TMA zero-fills rows past M, columns past N and bytes past K, so the
//     kernel has no edge variant: rows and columns past the edge are not
//     stored. With the epilogue left out, loads and products ran near the
//     operations bound in bring-up runs (PERF.md).
//   * [requant] G > 1: a pre-pass, one block a row, requantizes x onto
//     the row's largest scale into an (M, kp) workspace, which the GEMM
//     reads as its A (two launches, one call). Done inside the GEMM (each
//     consumer warpgroup rewriting its rows of the A stage, then
//     fence.proxy.async and a warpgroup barrier), every column tile
//     requantizes the same rows again, N / BN times (12 to 96 at the
//     serving sites), with arithmetic as long as the products' issue: it
//     ran well below the G = 1 rate in bring-up. The pre-pass moves ~2 M K
//     bytes once.
//   * [grid] The plan (ops/quant_matmul.py::qmm_sm90_plan) picks BN by the
//     waves of 132 SMs it leaves: 128 at the large launches (M = 12,800 to
//     204,800), 64 where 128 would leave most SMs idle (phi='s' h6
//     attn_out at batch 1, M = 400, N = 2,048: 64 tiles of 128 columns, 128
//     of 64). Tiles of 256 columns ran slower at every serving shape in
//     bring-up: their epilogue holds 128 accumulators a thread, which spill
//     or, unrolled, outgrow the instruction cache. With more tiles
//     than SMs the grid is persistent: one block an SM walks tiles t, t +
//     grid, ... in [raster] order: the producer loads the next tile's
//     slabs, and the consumers run its products, while the epilogue
//     warpgroup finishes this one.
//   * [raster] Tile t walks groups of 8 row tiles column by column, so the
//     ~132 tiles in flight share ~8 A row bands and ~17 B column bands.
//   * [epilogue] Two warpgroups of its own, a tile behind the products. In
//     bring-up the epilogue, run by the consumers after each tile's
//     products, took several times as long as the products, fully unrolled
//     in the accumulator layout or restaged through shared memory; one
//     epilogue warpgroup still held them back, two about hid it, four do
//     not fit the registers (PERF.md). Each
//     consumer thread writes __fmul_rn(float(acc), row_scale), the plain
//     version's first rounding, into a staging tile of 128 x (BN + 8)
//     floats (no bank conflicts), arrives on `staged` and goes on to the
//     next tile's products; epilogue warpgroup e takes rows 64e .. 64e + 63
//     of it: x w_scale (+ bias) (activation) (+ residual), stored, 4
//     consecutive columns a thread (their w_scale and bias in registers for
//     the tile), 4 rows' residual loads in flight together, a warp's rows
//     contiguous in 16-byte (fp32) or 8-byte (bf16) pieces; then it arrives
//     on `drained`, which the consumers wait for before they stage the next
//     tile. The body is compiled once an activation: with the activation a
//     runtime branch per element, the inlined tanhf and expf issued for
//     every element, predicated off, doubling the epilogue's time.
//   * Quantized outputs. quant_out and ln_out still go through the fp32
//     workspace and the row pass: their groups are 512 to 19,168 columns,
//     most often a whole row, wider than any tile.
//   * Unaligned K. TMA needs 16-byte row strides: the weights are padded to
//     K % 16 = 0 once, where they are prepared (prepare_weights), and the
//     wrapper pads the activations (G > 1: the pre-pass writes them
//     padded); `kp` is that row stride. The zero bytes add nothing to a sum.
//   * [bits] acc is exact and the epilogue takes qmm_plain's operations in
//     its order, so the kernel equals qmm_plain up to the activation's and
//     the row pass's own float functions (tanhf, expf, their roundings). A
//     dropped mbarrier wait or a wgmma group read early shows as a
//     run-to-run difference, which chip_smoke.py checks (each case twice).
//   * [fences] No wgmma group is in flight across writes to the
//     accumulator registers (the epilogue only reads them, after the last
//     wait; C7513 otherwise serializes every wgmma).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"
#include "wgmma_s8.cuh"

namespace {

using namespace s8;
using namespace sm90;

constexpr int BM = 128;             // rows a tile: 64 a consumer warpgroup
constexpr int SLAB = 128;           // K bytes a stage: the 128-byte swizzle's row
constexpr int CONSUMERS = 2;        // warpgroups 0 and 1
constexpr int EPILOGUES = 2;        // warpgroups 2 and 3: the [epilogue]'s, 64 rows each
constexpr int PRODUCER = CONSUMERS + EPILOGUES;  // the last warpgroup
constexpr int THREADS = 128 * (PRODUCER + 1);
// setmaxnreg: the producer's, the epilogue's and the consumers' registers a
// thread. They share the block's pool, THREADS x the launch's per-thread
// count (65536 / THREADS, in steps of 8): the consumers' increase waits for
// what the others release, forever if the pool falls short.
constexpr int REGS_LAUNCH = 65536 / THREADS / 8 * 8;
constexpr int REGS_PRODUCER = 40;
constexpr int REGS_EPILOGUE = 80;
constexpr int REGS_CONSUMER =
    ((PRODUCER + 1) * REGS_LAUNCH - REGS_PRODUCER - EPILOGUES * REGS_EPILOGUE) / CONSUMERS / 8 * 8;
static_assert(REGS_PRODUCER <= REGS_LAUNCH && REGS_EPILOGUE <= REGS_LAUNCH &&
                  REGS_CONSUMER >= REGS_LAUNCH && REGS_CONSUMER <= 256,
              "setmaxnreg outside the block's register pool");
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
constexpr int ALIGN = 1024;         // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr int BARRIER_BYTES = 256;  // full and empty of up to 8 stages, staged, drained
constexpr int GROUP_M = 8;          // [raster] row tiles a group
constexpr int REQUANT_THREADS = 256;

struct Params {
  const float* xs;        // (M, G)
  const float* ws;        // (N,)
  const float* bias;      // (N,) or null
  const void* residual;   // (M, N) bf16, or fp32 when res_f32; or null
  void* out;              // (M, N) bf16, or fp32 when out_f32
  int m, n, groups, act, out_f32, res_f32;
  int slabs;              // ceil(kp / SLAB)
  int stages;
  int tiles_m, tiles_n;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// [raster] tile t -> (row tile, column tile)
__device__ __forceinline__ void tile_of(int t, const Params& p, int& mt, int& nt) {
  const int per_group = GROUP_M * p.tiles_n;
  const int first = (t / per_group) * GROUP_M;
  const int rows = min(p.tiles_m - first, GROUP_M);
  const int r = t % per_group;
  mt = first + r % rows;
  nt = r / rows;
}

// the row's scale: its only one (G = 1) or its largest group scale (G > 1)
__device__ __forceinline__ float row_scale(const Params& p, int row) {
  const float* xs = p.xs + static_cast<long long>(row) * p.groups;
  if (p.groups == 1) return xs[0];
  float s = xs[0];
  for (int g = 1; g < p.groups; ++g) s = fmaxf(s, xs[g]);
  return fmaxf(s, 1e-30f);
}

// [requant] four int8 (one word) times `ratio`, each rounded half to even
// to int8: rint(__fmul_rn(float(x), ratio)), as _requant computes it, with
// no conversion instruction (I2F and F2I issue at a quarter of the FP32
// rate). float(x): x + 128 in the mantissa of 2^23, less 2^23 + 128
// (exact). Rounding: adding 1.5 * 2^23 leaves the integer's low bits in the
// mantissa, rounded half to even, for |v| < 2^22 (here |v| <= 127).
__device__ __forceinline__ uint32_t requant4(uint32_t word, float ratio) {
  const uint32_t biased = word ^ 0x80808080u;  // x + 128 in each byte
  uint32_t r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = __fadd_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + e)),
                              -8388736.f);
    r[e] = __float_as_uint(__fadd_rn(__fmul_rn(x, ratio), 12582912.f));
  }
  return __byte_perm(__byte_perm(r[0], r[1], 0x0040), __byte_perm(r[2], r[3], 0x0040), 0x5410);
}

// [requant] G > 1: one block a row. x (m, k) int8 in groups of k / G
// columns (a multiple of 4: whole words) onto the row's largest scale,
// written into xr (m, kp), zeros past k: the A operand the GEMM's TMA reads.
__global__ void __launch_bounds__(REQUANT_THREADS) requant_rows_kernel(
    const int8_t* __restrict__ x, const float* __restrict__ xs, int8_t* __restrict__ xr, int k,
    int kp, int groups) {
  __shared__ float red[REQUANT_THREADS / 32];
  const long long row = blockIdx.x;
  const float* s = xs + row * groups;
  float smax = 0.f;
  for (int g = threadIdx.x; g < groups; g += REQUANT_THREADS) smax = fmaxf(smax, s[g]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) smax = fmaxf(smax, __shfl_xor_sync(0xffffffff, smax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = smax;
  __syncthreads();
  smax = red[0];
#pragma unroll
  for (int w = 1; w < REQUANT_THREADS / 32; ++w) smax = fmaxf(smax, red[w]);
  smax = fmaxf(smax, 1e-30f);
  const int gwidth = k / groups;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(x + row * k);
  uint32_t* dst = reinterpret_cast<uint32_t*>(xr + row * kp);
  for (int w = threadIdx.x; w < kp / 4; w += REQUANT_THREADS) {
    const int col = 4 * w;
    dst[w] = col < k ? requant4(src[w], s[col / gwidth] / smax) : 0u;
  }
}

// [epilogue] phase 2 of one staged tile: x w_scale (+ bias) (activation
// ACT: 0 none, 1 gelu tanh, 2 silu) (+ residual), stored; 4 consecutive
// columns a thread (w, bb: its w_scale and bias), a warp's rows contiguous.
template <int BN, int ACT>
__device__ __forceinline__ void epilogue_rows(const Params& p, const float* staging, int m0,
                                              int rows0, int col, int lc, int width, bool vec,
                                              const float (&w)[4], const float (&bb)[4],
                                              int tid) {
  constexpr int LD = BN + 8;
  constexpr int CPR = BN / 4;       // threads a row
  constexpr int RPI = 128 / CPR;    // rows an iteration
  constexpr int UNROLL = 4;         // rows whose residual loads are in flight together
#pragma unroll 1
  for (int j0 = 0; j0 < BM / EPILOGUES / RPI; j0 += UNROLL) {
    float4 tv[UNROLL];
    uint4 res[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int lr = rows0 + (j0 + u) * RPI + tid / CPR;
      tv[u] = *reinterpret_cast<const float4*>(staging + lr * LD + lc);
      const long long idx = static_cast<long long>(m0 + lr) * p.n + col;
      if (p.residual && vec && m0 + lr < p.m) {
        if (p.res_f32) {
          res[u] = *reinterpret_cast<const uint4*>(static_cast<const float*>(p.residual) + idx);
        } else {
          const uint2 q = *reinterpret_cast<const uint2*>(
              static_cast<const __nv_bfloat16*>(p.residual) + idx);
          res[u] = make_uint4(q.x, q.y, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = m0 + rows0 + (j0 + u) * RPI + tid / CPR;
      if (row >= p.m || width <= 0) continue;
      float v[4] = {tv[u].x, tv[u].y, tv[u].z, tv[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // _rn intrinsics: no FMA contraction, the plain version's roundings
        float o = __fmul_rn(v[e], w[e]);
        if (p.bias) o = __fadd_rn(o, bb[e]);
        if constexpr (ACT == 1) {
          o = o * (0.5f * (1.f + tanhf(0.7978845608028654f * (o + 0.044715f * (o * o * o)))));
        } else if constexpr (ACT == 2) {
          o = o * (1.f / (1.f + expf(-o)));
        }
        v[e] = o;
      }
      const long long idx = static_cast<long long>(row) * p.n + col;
      if (p.residual && vec) {
        float rv[4];
        if (p.res_f32) {
          rv[0] = __uint_as_float(res[u].x);
          rv[1] = __uint_as_float(res[u].y);
          rv[2] = __uint_as_float(res[u].z);
          rv[3] = __uint_as_float(res[u].w);
        } else {
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[u].x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[u].y));
          rv[0] = lo.x; rv[1] = lo.y; rv[2] = hi.x; rv[3] = hi.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(v[e], rv[e]);
      } else if (p.residual) {
        for (int e = 0; e < width; ++e) {
          const float rv =
              p.res_f32 ? static_cast<const float*>(p.residual)[idx + e]
                        : __bfloat162float(static_cast<const __nv_bfloat16*>(p.residual)[idx + e]);
          v[e] = __fadd_rn(v[e], rv);
        }
      }
      if (p.out_f32) {
        float* o = static_cast<float*>(p.out) + idx;
        if (vec) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
          for (int e = 0; e < width; ++e) o[e] = v[e];
        }
      } else {
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + idx;
        if (vec) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(o) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                    *reinterpret_cast<const uint32_t*>(&hi));
        } else {
          for (int e = 0; e < width; ++e) o[e] = __float2bfloat16_rn(v[e]);
        }
      }
    }
  }
}

// Grid: min(tiles, SMs) blocks walking the tiles ([grid]); block: consumer
// warpgroups 0 and 1, the epilogue warpgroups 2 and 3, the producer 4.
// Shared memory, from a 1024-aligned base: ring of `stages` x (A 128 x 128
// | B BN x 128) | the [epilogue] staging tile, 128 x (BN + 8) floats |
// barriers.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    qmm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t A_BYTES = BM * SLAB;
  constexpr uint32_t STAGE = A_BYTES + BN * SLAB;
  constexpr int LD = BN + 8;  // floats a staging row: conflict-free, 16-byte rows
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  unsigned char* gbase = smem_raw + (base - raw);  // generic pointer to base
  const uint32_t ring = base;
  float* staging = reinterpret_cast<float*>(gbase + p.stages * STAGE);
  const uint32_t bar_full = base + p.stages * STAGE + BM * LD * 4;
  const uint32_t bar_empty = bar_full + 8 * MAX_STAGES;
  const uint32_t bar_staged = bar_empty + 8 * MAX_STAGES;  // consumers -> epilogue
  const uint32_t bar_drained = bar_staged + 8;             // epilogue -> consumers
  const int tiles = p.tiles_m * p.tiles_n;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * 4);  // one arrival a reading warp
    }
    mbar_init(bar_staged, CONSUMERS * 4);
    mbar_init(bar_drained, EPILOGUES * 4);
    // the initialised barriers visible to the async proxy (TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // one arrival a warp, after the warp's reads or writes (its wgmma wait,
  // or __syncwarp's ordering of the lanes' shared-memory accesses)
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  // One if/else chain for the whole kernel: the roles never reconverge, so
  // ptxas honours setmaxnreg.
  if (wg == PRODUCER) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<REGS_PRODUCER>();
    if (tid == 0) {
      int st = 0, ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt;
        tile_of(t, p, mt, nt);
        for (int s = 0; s < p.slabs; ++s) {
          mbar_wait(bar_empty + 8 * st, ph ^ 1);
          mbar_expect_tx(bar_full + 8 * st, STAGE);  // zero-filled bytes count too
          tma_load_2d(ring + st * STAGE, &ta, bar_full + 8 * st, s * SLAB, mt * BM);
          tma_load_2d(ring + st * STAGE + A_BYTES, &tb, bar_full + 8 * st, s * SLAB, nt * BN);
          if (++st == p.stages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else if (wg >= CONSUMERS) {
    // ---------------- [epilogue] phase 2, a tile behind -------------------
    setmaxnreg_dec<REGS_EPILOGUE>();
    const int rows0 = (wg - CONSUMERS) * (BM / EPILOGUES);  // this warpgroup's rows
    const int lc = (tid % (BN / 4)) * 4;  // 4 consecutive columns a thread
    int i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      int mt, nt;
      tile_of(t, p, mt, nt);
      const int m0 = mt * BM, col = nt * BN + lc;
      const int width = min(4, p.n - col);
      // 4 columns whole inside N, at a 4-element boundary of the row
      const bool vec = width == 4 && (p.n & 3) == 0;
      float w[4], bb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[e] = e < width ? p.ws[col + e] : 0.f;
        bb[e] = e < width && p.bias ? p.bias[col + e] : 0.f;
      }
      mbar_wait(bar_staged, i & 1);
      // one body an activation ([epilogue])
      if (p.act == 1) {
        epilogue_rows<BN, 1>(p, staging, m0, rows0, col, lc, width, vec, w, bb, tid);
      } else if (p.act == 2) {
        epilogue_rows<BN, 2>(p, staging, m0, rows0, col, lc, width, vec, w, bb, tid);
      } else {
        epilogue_rows<BN, 0>(p, staging, m0, rows0, col, lc, width, vec, w, bb, tid);
      }
      release(bar_drained);  // the staging tile read: the consumers may write the next
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<REGS_CONSUMER>();
    const int warp = tid / 32;
    const int t4 = lane & 3;
    const int r0 = warp * 16 + (lane >> 2);  // accumulator rows r0, r0 + 8 of the 64
    int acc[BN / 2];
    int st = 0, ph = 0;
    int i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      int mt, nt;
      tile_of(t, p, mt, nt);
      const int m0 = mt * BM + wg * 64;  // this warpgroup's rows
      int prev = -1;
      for (int s = 0; s < p.slabs; ++s) {
        const int cur = st;
        mbar_wait(bar_full + 8 * st, ph);
        const uint32_t a = ring + st * STAGE + wg * 64 * SLAB;
        const uint32_t b = ring + st * STAGE + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SLAB / 32; ++kk)
          wgmma_ss<BN>(acc, desc_k_major(a + kk * 32, SLAB), desc_k_major(b + kk * 32, SLAB),
                       s > 0 || kk > 0);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(bar_empty + 8 * prev);
        }
        prev = cur;
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      release(bar_empty + 8 * prev);

      // [epilogue] phase 1: the plain version's first rounding,
      // __fmul_rn(float(acc), row_scale), into the staging tile once the
      // epilogue warpgroup has read the previous one
      float rs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) rs[r] = m0 + r0 + 8 * r < p.m ? row_scale(p, m0 + r0 + 8 * r) : 0.f;
      mbar_wait(bar_drained, (i & 1) ^ 1);
      float* my = staging + (wg * 64 + r0) * LD + 2 * t4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(my + 8 * r * LD + 8 * j) =
              make_float2(__fmul_rn(static_cast<float>(acc[4 * j + 2 * r]), rs[r]),
                          __fmul_rn(static_cast<float>(acc[4 * j + 2 * r + 1]), rs[r]));
      release(bar_staged);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A 2-D int8 map over a (rows, kp) K-major matrix: boxes of 128 bytes (the
// swizzle's width) x box_rows rows; TMA zero-fills what lies outside. The
// base and the row stride kp must be multiples of 16 bytes; the map travels
// by value as a __grid_constant__ kernel parameter.
bool make_map_2d(CUtensorMap* map, const void* base, int kp, int rows, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 || kp % 16) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t box[2] = {SLAB, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory of a plan: alignment slack, the ring, the staging
// tile, the barriers. ops/quant_matmul.py::qmm_sm90_smem_bytes computes the
// same.
int plan_smem(int bn, int stages) {
  return ALIGN + stages * (BM + bn) * SLAB + BM * (bn + 8) * 4 + BARRIER_BYTES;
}

template <int BN>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, const Params& p, int grid,
                   int smem, cudaStream_t stream) {
  // per call, not cached: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(qmm_sm90_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  qmm_sm90_kernel<BN><<<grid, THREADS, smem, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Indices of the launch plan, ops/quant_matmul.py::qmm_sm90_plan.
enum { PLAN_BM, PLAN_BN, PLAN_STAGES, PLAN_GRID, PLAN_SMEM, PLAN_LEN };

// int8 GEMM with the dequant epilogue on Hopper. wq (n, kp) int8, rows of
// kp bytes (a multiple of 16: the k true columns, then zeros); xs (m,
// groups) f32. groups == 1: xq (m, kp) int8 like wq, xr null. groups > 1
// (k % groups == 0, (k / groups) % 4 == 0): xq (m, k) int8 and xr an (m,
// kp) int8 workspace the [requant] pre-pass writes first (two launches).
// ws (n,), bias (n,) or null; residual (m, n) bf16 (res_f32 = 0) or fp32,
// or null; act 0 none, 1 gelu (tanh), 2 silu; out (m, n) bf16 or, with
// out_f32, fp32. `plan` (PLAN_LEN ints) must be one this library was built
// for: 128 rows a tile, BN 64 or 128, 1-8 stages, a grid of 1 to tiles
// blocks, the shared memory it needs within the card's 227 KB. Anything
// else returns cudaErrorInvalidValue, as does a failed tensor-map encode.
// Returns the cudaError_t of the launches.
int qmm_sm90(const void* xq, const void* xs, const void* wq, const void* ws, const void* bias,
             const void* residual, void* out, void* xr, int m, int n, int k, int kp, int groups,
             int act, int out_f32, int res_f32, const int* plan, void* stream) {
  const int bm = plan[PLAN_BM], bn = plan[PLAN_BN], stages = plan[PLAN_STAGES];
  const int grid = plan[PLAN_GRID], smem = plan[PLAN_SMEM];
  const long long tiles_m = (m + BM - 1) / BM, tiles_n = bn > 0 ? (n + bn - 1) / bn : 0;
  if (m <= 0 || n <= 0 || k <= 0 || kp % 16 || kp < k || kp - k >= 16 || groups < 1 ||
      (groups > 1 && (k % groups || (k / groups) % 4 || xr == nullptr)) || act < 0 || act > 2 ||
      bm != BM || !(bn == 64 || bn == 128) || stages < 1 || stages > MAX_STAGES || grid < 1 ||
      grid > tiles_m * tiles_n || tiles_m * tiles_n > 0x7fffffffLL ||
      smem != plan_smem(bn, stages) || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* a = xq;
  if (groups > 1) {
    requant_rows_kernel<<<m, REQUANT_THREADS, 0, st>>>(static_cast<const int8_t*>(xq),
                                                      static_cast<const float*>(xs),
                                                      static_cast<int8_t*>(xr), k, kp, groups);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    a = xr;
  }
  CUtensorMap ta, tb;
  if (!make_map_2d(&ta, a, kp, m, BM) || !make_map_2d(&tb, wq, kp, n, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.residual = residual;
  p.out = out;
  p.m = m;
  p.n = n;
  p.groups = groups;
  p.act = act;
  p.out_f32 = out_f32;
  p.res_f32 = res_f32;
  p.slabs = (kp + SLAB - 1) / SLAB;
  p.stages = stages;
  p.tiles_m = static_cast<int>(tiles_m);
  p.tiles_n = static_cast<int>(tiles_n);
  // the instantiations, one a width the plan picks
  if (bn == 128) return static_cast<int>(launch<128>(ta, tb, p, grid, smem, st));
  return static_cast<int>(launch<64>(ta, tb, p, grid, smem, st));
}

}  // extern "C"
