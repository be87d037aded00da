// Flash-attention backward for Hopper (sm_90a), bf16, the packed multi-head
// form: wgmma fed by a TMA ring, one producer warpgroup and two consumer
// warpgroups a block, two kernels and no atomics.
//
// Replaces, for bf16 packed heads (num_heads > 1) whose q/k and v widths are
// equal multiples of 64 up to 384 (every packed training site of phi 'n',
// 's' and 'm': heads of 128, 256 and 384), the two TPU kernels of
// transparent_object_detection_tpu/ops/attention_vjp.py (flash_bwd):
//   * _bwd_dq_kernel  -> flash_bwd_dq_sm90_kernel:  dq = sum_k dS K
//   * _bwd_dkv_kernel -> flash_bwd_dkv_sm90_kernel: dk = sum_q dS^T Q,
//                                                   dv = sum_q P^T dO
// csrc/flash_bwd_single_sm90.cu takes one head (dark3 of phi 'n' to 'm',
// the folded heads), csrc/flash_bwd_f32_sm90.cu fp32,
// csrc/flash_bwd_wide_sm90.cu packed heads of 448 and wider, phi 'l'/'x'
// dark3 and other widths; ops/attention_vjp.py::bwd_form states the rule.
//
// Arithmetic, that of the plain versions and of the Pallas kernels
// (_recompute_p_ds and its two callers), per (query, key) tile: S = Q K^T in
// fp32; P = exp2(S * scale * log2 e - lse * log2 e); dP = dO V^T; dS = P *
// (dP - D) * scale with D = rowsum(dO * O) (computed in PyTorch); P and dS
// rounded to bf16 before their products; dq, dk and dv summed in fp32 and
// stored in bf16. The tile sizes only change the order of the fp32 sums.
//
// Bound. 2 * N^2 * (4 * dqk + 3 * dv) operations a (batch, head), the
// Pallas count, which already holds the dq kernel's recompute of S and dP,
// against a few tens of MB of inputs and outputs: the tensor cores bound it
// (phi='s' 640x640 batch 2, h1 + h2 + h4: 2.04 ms at the data sheet's 989
// TFLOP/s bf16). Against it: the serial chain S -> P -> dS -> product in
// each tile, and the softmax-like elementwise work between the products.
//
// Design.
//   * No atomics: the gradient has the same bits from run to run. dq is a
//     kernel of its own that walks the keys (the Pallas backward's two
//     pallas_calls), at the cost the Pallas count already holds.
//   * What streams moves as whole operand tiles, 64 rows by the head's
//     width in 64-column slabs (8 KB each, 128-byte swizzle, the layout
//     wgmma reads), through one ring of full and empty mbarriers, one pair
//     an operand tile, filled by one thread of the producer warpgroup. S
//     and dP are wgmma m64n64k16 SS products (both operands in shared
//     memory, K-major), slab by slab; the gradient products are RS (P or dS
//     from registers) with N the warpgroup's whole output width (64 to
//     256), their other operand the ring's tile read MN-major (the
//     transpose bit, so dO, Q and K serve as they lie). A consumer
//     warpgroup waits for every operand tile and releases each once,
//     whether it read it or not.
//   * dk/dv (a block: 64 keys of one (batch, head), K and V resident; the
//     ring carries the Q and dO tiles of each 64-query tile). Keys are the
//     wgmma M dimension: S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come
//     out of the accumulator already in the A layout of dV += P^T dO and dK
//     += dS^T Q. Heads up to 256, one launch (FUSED): warpgroup 0 computes
//     S^T, P^T and dV, warpgroup 1 dP^T, dS^T and dK, P^T handed over in
//     fp32 through shared memory behind named barriers; nothing is
//     recomputed and q and dO are read once. Heads of 320 and 384: dV and
//     dK of 64 x 384 in fp32 are 192 registers a thread each, more than a
//     warpgroup holds beside S, so two launches (DV and DK), each splitting
//     the output columns between the warpgroups (three slabs each):
//     DV: warpgroup 0 computes P^T and hands it over; DK: warpgroup 0
//     computes S^T, warpgroup 1 dP^T, they trade P^T and dP^T and both form
//     dS^T. The DV launch recomputes S^T: 2 * N^2 * dqk operations beyond the
//     Pallas count (1/7 of it at 384).
//   * dq (a block: 64 queries a warpgroup, Q and dO resident; the ring
//     carries the V and K tiles of each 64-key tile). Heads up to 256 (ROWS):
//     128 rows a block, each warpgroup its own 64, S = Q K^T and dP = dO V^T
//     issued together, dS in registers, dQ += dS K. Heads of 320 and 384
//     (SPLIT): 64 rows a block, warpgroup 0 computes S, warpgroup 1 dP, they
//     trade P and dP and each accumulates three slabs of dQ's columns.
//   * setmaxnreg: 240 registers for the consumers (dQ, dV or dK of heads of
//     256: 128 a thread, S and dP 32 each), 24 for the producer.
//   Tried and dropped, slower on the H100 at the phi='s' and 'm' neck
//   (PERF.md): a ring of single 8 KB slabs, each with its own barriers, and
//   the gradient products issued slab by slab (n64); the product of tile t
//   issued with tile t + 1's S and dP in one group; dk/dv on 128-key blocks
//   in two passes (dv, then dk with S recomputed) with no hand-over.
//
// Trouble spots, each handled where its tag appears below:
//   [ragged N]   keys and queries past N (TMA zero-fills them: a key scores
//                0, not -inf, so P is set to 0 there explicitly; lse and D
//                are never read past N; rows past N are never stored)
//   [exchange]   the fp32 hand-over between the warpgroups
//   [fences]     wgmma fences, groups and mbarrier phases
//   [ring]       tile order and release, no deadlock at the plan's stages
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int SLAB = 64;                 // columns of a slab, rows of a tile
constexpr int SLAB_BYTES = 64 * 64 * 2;  // one slab, bf16
constexpr int THREADS_SM90 = 384;        // consumer warpgroups 0 and 1, producer 2
constexpr int MAX_STAGES = 24;           // ring stages, one operand tile each
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block may use
constexpr int ALIGN = 1024;              // a swizzle atom: 8 rows of 128 bytes
constexpr int BARRIER_BYTES = 1024;
constexpr int XCHG_BYTES = 64 * 64 * 4;  // one fp32 64 x 64 tile handed over
constexpr int SPLIT_SLABS = 3;           // output slabs a warpgroup owns, split forms
constexpr int MAX_SLABS = 6;             // heads up to 384; a split form's ring tile

// [exchange] named barriers (never 0: __syncthreads)
enum { BAR_P_FULL = 1, BAR_P_EMPTY = 2, BAR_DP_FULL = 3, BAR_DP_EMPTY = 4 };
enum { DKV_FUSED = 0, DKV_DV = 1, DKV_DK = 2 };

struct BwdSm90Params {
  const float* lse;   // (B, heads, N)
  const float* dcap;  // (B, heads, N)
  __nv_bfloat16* dq;  // dq kernel
  __nv_bfloat16* dk;  // dk/dv kernel
  __nv_bfloat16* dv;
  long long dq_batch, dq_row, dk_batch, dk_row, dv_batch, dv_row;
  int n, heads, d;  // d: the head width of q/k and of v
  int stages;       // ring stages (operand tiles)
  float scale, scale_log2;
};

// bf16 A fragments (m64k16 register layout) of a 64 x 64 fp32 accumulator:
// s[4i + e] is row r0 + 8 * (e / 2), column 8i + 2 * (lane % 4) + e % 2;
// k-block kk is the accumulator's 8-column chunks 2kk and 2kk + 1
__device__ __forceinline__ void to_frags(const float (&s)[32], uint32_t (&xa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    xa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    xa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    xa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    xa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// acc += A (64 x 64, shared, K-major, rows of 128 bytes) B^T (B: 64 x 64,
// shared, K-major): four k16 steps; the first overwrites acc when `fresh`
__device__ __forceinline__ void ss_slab(float (&acc)[32], uint32_t a, uint32_t bslab, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(acc, desc_sw128(a + kk * 32, 16, 1024), desc_sw128(bslab + kk * 32, 16, 1024),
                 !(fresh && kk == 0));
}

// acc (64 x N) += X (64 x 64 bf16, registers) Y (64 rows x N columns of
// 64-column slabs from `y`, shared, MN-major: the contraction runs over Y's
// rows): four k16 steps of one m64nNk16 each
template <int N>
__device__ __forceinline__ void rs_tile(float (&acc)[N / 2], const uint32_t (&xa)[4][4],
                                        uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = desc_sw128(y + kk * 16 * 128, SLAB_BYTES, 1024);
    if constexpr (N == 64) wgmma_rs_n64(acc, xa[kk], desc);
    if constexpr (N == 128) wgmma_rs_n128(acc, xa[kk], desc);
    if constexpr (N == 192) wgmma_rs_n192(acc, xa[kk], desc);
    if constexpr (N == 256) wgmma_rs_n256(acc, xa[kk], desc);
  }
}

// one arrival a warp, after the warp's wgmma.wait_group covered its reads
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// 64 x (64 * ACC) fp32 accumulator (the m64nN layout: element 32c + 4i + e
// is column 64c + 8i + 2 * (lane % 4) + e % 2) -> bf16 rows of `out` (row
// stride `row`) at columns from c0 * 64; slabs at or past `slabs` and rows
// at or past n skipped
template <int ACC>
__device__ __forceinline__ void store_rows(const float (&acc)[ACC * 32], __nv_bfloat16* out,
                                           long long row, int row0, int n, int c0, int slabs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    if (c0 + a >= slabs) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = (c0 + a) * SLAB + 8 * i + 2 * (lane & 3);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = row0 + 8 * r;
        if (rr < n)  // [ragged N]
          *reinterpret_cast<__nv_bfloat162*>(out + rr * row + col) = __floats2bfloat162_rn(
              acc[32 * a + 4 * i + 2 * r], acc[32 * a + 4 * i + 2 * r + 1]);
      }
    }
  }
}

// [exchange] a 64 x 64 fp32 accumulator into shared memory as [element][thread]:
// the thread of the same index in the other warpgroup holds the same (row,
// column) positions, and consecutive threads hit consecutive banks
__device__ __forceinline__ void publish(float* x, const float (&s)[32], int t, int bar_full,
                                        int bar_empty) {
  if (t > 0) named_sync(bar_empty);  // the reader is done with tile t - 1
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i * 128 + (threadIdx.x & 127)] = s[i];
  named_arrive(bar_full);
}
// the reader's side: this thread's column of the tile once it is full;
// `done` frees the buffer for the next tile
__device__ __forceinline__ const float* take(const float* x, int bar_full) {
  named_sync(bar_full);
  return x + (threadIdx.x & 127);
}
__device__ __forceinline__ void done(int t, int n_tiles, int bar_empty) {
  if (t + 1 < n_tiles) named_arrive(bar_empty);
}

// The ring of operand tiles: stage g % stages, its phase (g / stages) & 1.
struct Ring {
  uint32_t full, empty, data, unit;
  int stages;
  // [fences] waits until operand tile g has landed
  __device__ __forceinline__ uint32_t at(int g) const {
    const int st = g % stages;
    mbar_wait(full + 8 * st, (g / stages) & 1);
    return data + st * unit;
  }
  __device__ __forceinline__ void free(int g) const { release(empty + 8 * (g % stages)); }
};

__device__ __forceinline__ void init_barriers(uint32_t bar_res, const Ring& ring) {
  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < ring.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 8);  // one arrival a consumer warp
    }
    // [fences] the initialised barriers visible to the async proxy (TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------

// Grid (ceil(N / 64), heads, B). Shared memory from a 1024-aligned base:
// barriers | K (NS slabs) | V (NS slabs; not in DV) | P^T handed over |
// dP^T handed over (split forms; used by DK) | ring. [ring] A query tile is
// two operand tiles, Q then dO (DK: dO, then Q, which is held longer), each
// NS slabs (split forms: 6, the sixth zero-filled at 320); the plan's
// stages hold at least one query tile.
template <int NS, int MODE>
__global__ void __launch_bounds__(THREADS_SM90, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo, const BwdSm90Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr bool SPLIT = MODE != DKV_FUSED;
  constexpr int US = SPLIT ? MAX_SLABS : NS;     // slabs an operand tile
  constexpr int ACC = SPLIT ? SPLIT_SLABS : NS;  // output slabs a warpgroup accumulates
  constexpr bool WITH_V = MODE != DKV_DV;
  constexpr bool DO_FIRST = MODE == DKV_DK;
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t bar_res = base;
  const uint32_t k_smem = base + BARRIER_BYTES;
  const uint32_t v_smem = k_smem + NS * SLAB_BYTES;
  const uint32_t xp_smem = v_smem + (WITH_V ? NS * SLAB_BYTES : 0);
  const uint32_t xdp_smem = xp_smem + XCHG_BYTES;  // DK
  const Ring ring{base + 8, base + 8 + 8 * MAX_STAGES, xp_smem + (SPLIT ? 2 : 1) * XCHG_BYTES,
                  US * SLAB_BYTES, p.stages};
  float* xp = reinterpret_cast<float*>(smem_raw + (xp_smem - smem_u32(smem_raw)));
  float* xdp = reinterpret_cast<float*>(smem_raw + (xdp_smem - smem_u32(smem_raw)));

  const int k0 = blockIdx.x * SLAB;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (p.n + SLAB - 1) / SLAB;
  const int wg = threadIdx.x / 128;
  init_barriers(bar_res, ring);

  // One if/else for the whole kernel: the roles never reconverge, so ptxas
  // honours setmaxnreg.
  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_res, (WITH_V ? 2 : 1) * NS * SLAB_BYTES);
      for (int c = 0; c < NS; ++c) {
        tma_load(k_smem + c * SLAB_BYTES, &tk, bar_res, c * SLAB, head, k0, b);
        if (WITH_V) tma_load(v_smem + c * SLAB_BYTES, &tv, bar_res, c * SLAB, head, k0, b);
      }
      int st = 0, ph = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int j = 0; j < 2; ++j) {
          mbar_wait(ring.empty + 8 * st, ph ^ 1);
          mbar_expect_tx(ring.full + 8 * st, US * SLAB_BYTES);
          const CUtensorMap* map = (j == 0) != DO_FIRST ? &tq : &tdo;
          // [ragged N] rows past N, and the columns past a head of 320,
          // land zero-filled
          for (int c = 0; c < US; ++c)
            tma_load(ring.data + st * ring.unit + c * SLAB_BYTES, map, ring.full + 8 * st,
                     c * SLAB, head, t * SLAB, b);
          if (++st == p.stages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<240>();
    const int lane = threadIdx.x % 32;
    const int r0 = (threadIdx.x % 128) / 32 * 16 + (lane >> 2);  // keys r0, r0 + 8 of the 64
    // roles: warpgroup 0 computes S^T and P^T; warpgroup 1 dP^T (not in DV).
    // The product's X is P^T (dV) or dS^T (dK); its Y the dO or Q tile's
    // slabs [o0, o0 + ACC).
    const bool x_is_p = MODE == DKV_DV || (MODE == DKV_FUSED && wg == 0);
    const bool needs_d = !x_is_p;
    const int o0 = SPLIT ? wg * SPLIT_SLABS : 0;
    // the operand tile the product does not read, and whether phase A read it
    const bool read_other = x_is_p ? wg == 0 : (wg == 1 && MODE != DKV_DV);
    const float* lse_g = p.lse + (static_cast<long long>(b) * p.heads + head) * p.n;
    const float* d_g = p.dcap + (static_cast<long long>(b) * p.heads + head) * p.n;
    // [ragged N] per-column statistics of tile t, never read past N: lse *
    // log2 e (warpgroup 0, for P^T) or D (the warpgroups that form dS^T);
    // entry 2i + e is column 8i + 2 * (lane % 4) + e of the tile. Loaded
    // before the products are issued, read after they retire.
    auto load_cols = [&](float(&x)[16], const float* src, int t, float mul) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = t * SLAB + 8 * i + 2 * (lane & 3) + e;
          x[2 * i + e] = q < p.n ? src[q] * mul : 0.f;
        }
    };

    float acc[ACC * 32];
#pragma unroll
    for (int i = 0; i < ACC * 32; ++i) acc[i] = 0.f;
    mbar_wait(bar_res, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int q_g = 2 * t + (DO_FIRST ? 1 : 0), do_g = 2 * t + (DO_FIRST ? 0 : 1);
      float cd[16];
      if (needs_d) load_cols(cd, d_g, t, 1.f);

      float s[32];
      if (wg == 0) {  // S^T = K Q^T, then P^T
        float cl[16];
        load_cols(cl, lse_g, t, LOG2E);
        wgmma_fence();
        const uint32_t qb = ring.at(q_g);
#pragma unroll
        for (int c = 0; c < NS; ++c)
          ss_slab(s, k_smem + c * SLAB_BYTES, qb + c * SLAB_BYTES, c == 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int q = t * SLAB + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          // [ragged N] a zero-filled query scores 0: its P is set to 0
          s[i] = q < p.n ? fast_exp2(s[i] * p.scale_log2 - cl[2 * (i >> 2) + (i & 1)]) : 0.f;
        }
      } else if (MODE != DKV_DV) {  // dP^T = V dO^T
        wgmma_fence();
        const uint32_t db = ring.at(do_g);
#pragma unroll
        for (int c = 0; c < NS; ++c)
          ss_slab(s, v_smem + c * SLAB_BYTES, db + c * SLAB_BYTES, c == 0);
        wgmma_commit();
        wgmma_wait<0>();
      }
      // [ring] the tile the product does not read is released now
      const int other = x_is_p ? q_g : do_g;
      if (!read_other) ring.at(other);
      ring.free(other);

      // [exchange] P^T from warpgroup 0 (and, DK, dP^T from warpgroup 1);
      // dS^T = P^T * (dP^T - D) * scale from the same fp32 values in either
      if (wg == 0) publish(xp, s, t, BAR_P_FULL, BAR_P_EMPTY);
      if (MODE == DKV_DK && wg == 1) publish(xdp, s, t, BAR_DP_FULL, BAR_DP_EMPTY);
      if (MODE == DKV_DK && wg == 0) {
        const float* dpt = take(xdp, BAR_DP_FULL);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = s[i] * (dpt[i * 128] - cd[2 * (i >> 2) + (i & 1)]) * p.scale;
        done(t, n_tiles, BAR_DP_EMPTY);
      } else if (wg == 1) {
        const float* pt = take(xp, BAR_P_FULL);
        if (MODE == DKV_DV) {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = pt[i * 128];
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            s[i] = pt[i * 128] * (s[i] - cd[2 * (i >> 2) + (i & 1)]) * p.scale;
        }
        done(t, n_tiles, BAR_P_EMPTY);
      }

      // dV += P^T dO or dK += dS^T Q on this warpgroup's output slabs
      uint32_t xa[4][4];
      to_frags(s, xa);
      const int y_g = x_is_p ? do_g : q_g;
      const uint32_t yb = ring.at(y_g);
      wgmma_fence();  // [fences] xa was written by ordinary instructions
      rs_tile<ACC * 64>(acc, xa, yb + o0 * SLAB_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      ring.free(y_g);
    }

    __nv_bfloat16* out = x_is_p ? p.dv : p.dk;
    const long long row = x_is_p ? p.dv_row : p.dk_row;
    out += static_cast<long long>(b) * (x_is_p ? p.dv_batch : p.dk_batch) +
           static_cast<long long>(head) * p.d;
    store_rows<ACC>(acc, out, row, k0 + r0, p.n, o0, NS);
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// Grid (ceil(N / rows), heads, B): ROWS (SPLIT false) 128 rows, warpgroup w
// on rows 64w..64w+63; SPLIT 64 rows, both warpgroups on them. Shared memory
// from a 1024-aligned base: barriers | Q (NS slabs x row blocks) | dO (same)
// | P and dP handed over (SPLIT) | ring. [ring] A key tile is two operand
// tiles: V (released after dP) then K (held through dQ += dS K), NS slabs
// each (split: 6).
template <int NS, bool SPLIT>
__global__ void __launch_bounds__(THREADS_SM90, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo, const BwdSm90Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int RB = SPLIT ? 1 : 2;  // 64-row blocks of the block's rows
  constexpr int US = SPLIT ? MAX_SLABS : NS;
  constexpr int ACC = SPLIT ? SPLIT_SLABS : NS;
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t bar_res = base;
  const uint32_t q_smem = base + BARRIER_BYTES;
  const uint32_t do_smem = q_smem + NS * RB * SLAB_BYTES;
  const uint32_t xp_smem = do_smem + NS * RB * SLAB_BYTES;
  const uint32_t xdp_smem = xp_smem + XCHG_BYTES;
  const Ring ring{base + 8, base + 8 + 8 * MAX_STAGES,
                  xp_smem + (SPLIT ? 2 * XCHG_BYTES : 0), US * SLAB_BYTES, p.stages};
  float* xp = reinterpret_cast<float*>(smem_raw + (xp_smem - smem_u32(smem_raw)));
  float* xdp = reinterpret_cast<float*>(smem_raw + (xdp_smem - smem_u32(smem_raw)));

  const int m0 = blockIdx.x * 64 * RB;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (p.n + SLAB - 1) / SLAB;
  const int wg = threadIdx.x / 128;
  init_barriers(bar_res, ring);

  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_res, 2 * NS * RB * SLAB_BYTES);
      for (int c = 0; c < NS; ++c)
        for (int rb = 0; rb < RB; ++rb) {
          const uint32_t off = (c * RB + rb) * SLAB_BYTES;
          tma_load(q_smem + off, &tq, bar_res, c * SLAB, head, m0 + 64 * rb, b);
          tma_load(do_smem + off, &tdo, bar_res, c * SLAB, head, m0 + 64 * rb, b);
        }
      int st = 0, ph = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int j = 0; j < 2; ++j) {
          mbar_wait(ring.empty + 8 * st, ph ^ 1);
          mbar_expect_tx(ring.full + 8 * st, US * SLAB_BYTES);
          for (int c = 0; c < US; ++c)
            tma_load(ring.data + st * ring.unit + c * SLAB_BYTES, j == 0 ? &tv : &tk,
                     ring.full + 8 * st, c * SLAB, head, t * SLAB, b);
          if (++st == p.stages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<240>();
    const int lane = threadIdx.x % 32;
    const int r0 = (threadIdx.x % 128) / 32 * 16 + (lane >> 2);
    const int rb = SPLIT ? 0 : wg;  // this warpgroup's row block
    const int row0 = m0 + 64 * rb + r0;
    const int o0 = SPLIT ? wg * SPLIT_SLABS : 0;
    const long long stat = (static_cast<long long>(b) * p.heads + head) * p.n;
    // [ragged N] per-row statistics, never read past N
    float rl[2], rd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      rl[r] = row < p.n ? p.lse[stat + row] * LOG2E : 0.f;
      rd[r] = row < p.n ? p.dcap[stat + row] : 0.f;
    }
    auto q_res = [&](int c) { return q_smem + (c * RB + rb) * SLAB_BYTES; };
    auto do_res = [&](int c) { return do_smem + (c * RB + rb) * SLAB_BYTES; };
    // P of tile t at this thread's elements, keys past N set to 0 [ragged N]
    auto probs = [&](float(&x)[32], int t) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = t * SLAB + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        x[i] = key < p.n ? fast_exp2(x[i] * p.scale_log2 - rl[(i >> 1) & 1]) : 0.f;
      }
    };

    float acc[ACC * 32];
#pragma unroll
    for (int i = 0; i < ACC * 32; ++i) acc[i] = 0.f;
    mbar_wait(bar_res, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int v_g = 2 * t, k_g = 2 * t + 1;
      float s[32];
      if (!SPLIT) {  // dP = dO V^T and S = Q K^T, one group; dS in registers
        float dp[32];
        wgmma_fence();
        const uint32_t vb = ring.at(v_g);
#pragma unroll
        for (int c = 0; c < NS; ++c) ss_slab(dp, do_res(c), vb + c * SLAB_BYTES, c == 0);
        const uint32_t kb = ring.at(k_g);
#pragma unroll
        for (int c = 0; c < NS; ++c) ss_slab(s, q_res(c), kb + c * SLAB_BYTES, c == 0);
        wgmma_commit();
        wgmma_wait<0>();
        ring.free(v_g);
        probs(s, t);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = s[i] * (dp[i] - rd[(i >> 1) & 1]) * p.scale;
      } else if (wg == 0) {  // S = Q K^T, P; the V tile not read
        ring.at(v_g);
        ring.free(v_g);
        wgmma_fence();
        const uint32_t kb = ring.at(k_g);
#pragma unroll
        for (int c = 0; c < NS; ++c) ss_slab(s, q_res(c), kb + c * SLAB_BYTES, c == 0);
        wgmma_commit();
        wgmma_wait<0>();
        probs(s, t);
        publish(xp, s, t, BAR_P_FULL, BAR_P_EMPTY);
        const float* dpt = take(xdp, BAR_DP_FULL);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = s[i] * (dpt[i * 128] - rd[(i >> 1) & 1]) * p.scale;
        done(t, n_tiles, BAR_DP_EMPTY);
      } else {  // dP = dO V^T
        wgmma_fence();
        const uint32_t vb = ring.at(v_g);
#pragma unroll
        for (int c = 0; c < NS; ++c) ss_slab(s, do_res(c), vb + c * SLAB_BYTES, c == 0);
        wgmma_commit();
        wgmma_wait<0>();
        ring.free(v_g);
        publish(xdp, s, t, BAR_DP_FULL, BAR_DP_EMPTY);
        const float* pt = take(xp, BAR_P_FULL);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = pt[i * 128] * (s[i] - rd[(i >> 1) & 1]) * p.scale;
        done(t, n_tiles, BAR_P_EMPTY);
      }

      // dQ += dS K on this warpgroup's output slabs
      uint32_t xa[4][4];
      to_frags(s, xa);
      const uint32_t kb = ring.at(k_g);
      wgmma_fence();
      rs_tile<ACC * 64>(acc, xa, kb + o0 * SLAB_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      ring.free(k_g);
    }

    __nv_bfloat16* out = p.dq + static_cast<long long>(b) * p.dq_batch +
                         static_cast<long long>(head) * p.d;
    store_rows<ACC>(acc, out, p.dq_row, row0, p.n, o0, NS);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Dynamic shared memory of a plan (ops/attention_vjp.py::bwd_sm90_smem_bytes
// computes the same): alignment slack, barriers, the resident slabs, the
// fp32 tiles handed over, the ring's operand tiles (split forms: 6 slabs).
int ring_tile(int slabs, int split) { return (split ? MAX_SLABS : slabs) * SLAB_BYTES; }
int dq_smem(int slabs, int split, int stages) {
  return ALIGN + BARRIER_BYTES + 2 * slabs * (split ? 1 : 2) * SLAB_BYTES +
         (split ? 2 * XCHG_BYTES : 0) + stages * ring_tile(slabs, split);
}
int dkv_smem(int slabs, int split, int stages) {
  // K, V, P^T and (split) dP^T: the DK launch's; the DV launch (no V) uses less
  return ALIGN + BARRIER_BYTES + 2 * slabs * SLAB_BYTES + (split ? 2 : 1) * XCHG_BYTES +
         stages * ring_tile(slabs, split);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const CUtensorMap (&maps)[4], const BwdSm90Params& p,
                   dim3 grid, int smem, cudaStream_t stream) {
  // per call, not cached: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS_SM90, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

// The instantiations, one a plan the rule picks: heads of 64 to 256 (1-4
// slabs) on the ROWS / FUSED forms, 320 and 384 (5, 6) on the split ones.
cudaError_t run_dq(int slabs, const CUtensorMap (&m)[4], const BwdSm90Params& p, dim3 g,
                   int smem, cudaStream_t s) {
  switch (slabs) {
    case 1: return launch(flash_bwd_dq_sm90_kernel<1, false>, m, p, g, smem, s);
    case 2: return launch(flash_bwd_dq_sm90_kernel<2, false>, m, p, g, smem, s);
    case 3: return launch(flash_bwd_dq_sm90_kernel<3, false>, m, p, g, smem, s);
    case 4: return launch(flash_bwd_dq_sm90_kernel<4, false>, m, p, g, smem, s);
    case 5: return launch(flash_bwd_dq_sm90_kernel<5, true>, m, p, g, smem, s);
    default: return launch(flash_bwd_dq_sm90_kernel<6, true>, m, p, g, smem, s);
  }
}

cudaError_t run_dkv(int slabs, const CUtensorMap (&m)[4], const BwdSm90Params& p, dim3 g,
                    int smem, cudaStream_t s) {
  switch (slabs) {
    case 1: return launch(flash_bwd_dkv_sm90_kernel<1, DKV_FUSED>, m, p, g, smem, s);
    case 2: return launch(flash_bwd_dkv_sm90_kernel<2, DKV_FUSED>, m, p, g, smem, s);
    case 3: return launch(flash_bwd_dkv_sm90_kernel<3, DKV_FUSED>, m, p, g, smem, s);
    case 4: return launch(flash_bwd_dkv_sm90_kernel<4, DKV_FUSED>, m, p, g, smem, s);
    default: break;
  }
  // split: the DV launch, then the DK launch (each within the DK launch's
  // shared memory)
  cudaError_t err = slabs == 5
                        ? launch(flash_bwd_dkv_sm90_kernel<5, DKV_DV>, m, p, g, smem, s)
                        : launch(flash_bwd_dkv_sm90_kernel<6, DKV_DV>, m, p, g, smem, s);
  if (err != cudaSuccess) return err;
  return slabs == 5 ? launch(flash_bwd_dkv_sm90_kernel<5, DKV_DK>, m, p, g, smem, s)
                    : launch(flash_bwd_dkv_sm90_kernel<6, DKV_DK>, m, p, g, smem, s);
}

}  // namespace

extern "C" {

// Indices of a launch plan, ops/attention_vjp.py::bwd_sm90_plan.
enum { PLAN_ROWS, PLAN_SLAB, PLAN_STAGES, PLAN_SPLIT, PLAN_SMEM, PLAN_LEN };

// The plan check both entry points share: 64-column slabs; heads of d (a
// multiple of 64 up to 384) on the form d picks (split from 320); rows a
// block as the kernel has them; ring stages that hold at least one whole
// tile (two operand tiles: [ring] every tile a warpgroup waits for can
// land) and at most MAX_STAGES; the shared memory the plan names, as
// computed here, within the card's 227 KB.
static bool plan_ok(const int* plan, int d, int rows, int smem) {
  const int slabs = d / SLAB, stages = plan[PLAN_STAGES];
  return plan[PLAN_SLAB] == SLAB && plan[PLAN_ROWS] == rows &&
         plan[PLAN_SPLIT] == (slabs > 4 ? 1 : 0) && stages >= 2 &&
         stages <= MAX_STAGES && plan[PLAN_SMEM] == smem && smem <= SMEM_LIMIT;
}

static bool shape_ok(int batch, int n, int heads, int d) {
  return batch >= 1 && n >= 1 && heads >= 1 && d >= SLAB && d % SLAB == 0 &&
         d <= MAX_SLABS * SLAB;
}

// Four 4-D maps (q, k, v, dO as (B, N, heads * d) views, head h at column h
// * d; the packed qkv's sections and a contiguous dO are such views) with
// 64 x 64 boxes.
static bool make_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                      const void* dO, int batch, int n, int heads, int d, long long q_batch,
                      long long q_row, long long k_batch, long long k_row, long long v_batch,
                      long long v_row, long long do_batch, long long do_row) {
  return make_map(&m[0], q, d, heads, n, batch, q_row, q_batch, SLAB) &&
         make_map(&m[1], k, d, heads, n, batch, k_row, k_batch, SLAB) &&
         make_map(&m[2], v, d, heads, n, batch, v_row, v_batch, SLAB) &&
         make_map(&m[3], dO, d, heads, n, batch, do_row, do_batch, SLAB);
}

// dq of the bf16 flash backward of `heads` packed heads of width d (q/k and
// v alike): q, k, v, dO by pointer, batch and row strides in elements
// (16-byte aligned), lse and dcap (B, heads, N) fp32 contiguous, dq written
// through its batch and row strides (a column view of a packed dqkv is
// fine). `plan` (PLAN_LEN ints) must be the one this library was built for;
// anything else returns cudaErrorInvalidValue, as does a failed tensor-map
// encode. Returns the cudaError_t of the launch.
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dO,
                      const float* lse, const float* dcap, void* dq, int batch, int n, int heads,
                      int d, long long q_batch, long long q_row, long long k_batch,
                      long long k_row, long long v_batch, long long v_row, long long do_batch,
                      long long do_row, long long dq_batch, long long dq_row, float scale,
                      const int* plan, void* stream) {
  if (!shape_ok(batch, n, heads, d)) return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = d / SLAB, split = slabs > 4 ? 1 : 0;
  const int smem = dq_smem(slabs, split, plan[PLAN_STAGES]);
  if (!plan_ok(plan, d, split ? 64 : 128, smem)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  if (!make_maps(m, q, k, v, dO, batch, n, heads, d, q_batch, q_row, k_batch, k_row, v_batch,
                 v_row, do_batch, do_row))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdSm90Params p = {};
  p.lse = lse;
  p.dcap = dcap;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_batch = dq_batch;
  p.dq_row = dq_row;
  p.n = n;
  p.heads = heads;
  p.d = d;
  p.stages = plan[PLAN_STAGES];
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  const int rows = plan[PLAN_ROWS];
  const dim3 grid((n + rows - 1) / rows, heads, batch);
  return static_cast<int>(run_dq(slabs, m, p, grid, smem, static_cast<cudaStream_t>(stream)));
}

// dk and dv of the same backward, written through their strides; heads up
// to 256 in one launch, 320 and 384 in two (the DV launch, then the DK
// launch). Arguments and plan as flash_bwd_dq_sm90.
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dO,
                       const float* lse, const float* dcap, void* dk, void* dv, int batch, int n,
                       int heads, int d, long long q_batch, long long q_row, long long k_batch,
                       long long k_row, long long v_batch, long long v_row, long long do_batch,
                       long long do_row, long long dk_batch, long long dk_row,
                       long long dv_batch, long long dv_row, float scale, const int* plan,
                       void* stream) {
  if (!shape_ok(batch, n, heads, d)) return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = d / SLAB, split = slabs > 4 ? 1 : 0;
  const int smem = dkv_smem(slabs, split, plan[PLAN_STAGES]);
  if (!plan_ok(plan, d, SLAB, smem)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  if (!make_maps(m, q, k, v, dO, batch, n, heads, d, q_batch, q_row, k_batch, k_row, v_batch,
                 v_row, do_batch, do_row))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdSm90Params p = {};
  p.lse = lse;
  p.dcap = dcap;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dk_batch = dk_batch;
  p.dk_row = dk_row;
  p.dv_batch = dv_batch;
  p.dv_row = dv_row;
  p.n = n;
  p.heads = heads;
  p.d = d;
  p.stages = plan[PLAN_STAGES];
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  const dim3 grid((n + SLAB - 1) / SLAB, heads, batch);
  return static_cast<int>(run_dkv(slabs, m, p, grid, smem, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
