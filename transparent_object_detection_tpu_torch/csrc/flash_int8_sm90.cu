// int8 flash attention for Hopper (sm_90a): int8 wgmma fed by a TMA ring, one
// producer warpgroup and two consumer warpgroups a block.
//
// Replaces, at every int8 attention shape of the port (ops/attention_int8.py
// ::int8_fwd_form: q/k widths multiples of 32, v multiples of 128, any N and
// key block; every int8 site of phi 'n' to 'x'), the three TPU kernels of
// transparent_object_detection_tpu/ops/attention_int8.py:
//   * _mha_flash_int8_kernel (flash_attention_mha_int8): entry flash_mha_int8,
//     q bf16 or fp32 quantized per (row, head) first (quant_q_kernel,
//     flash_int8_common.cuh; the two launches count as one), out in q's type;
//   * _mha_flash_int8_qout_kernel: entry flash_mha_int8_qout, the same with
//     the output quantized per (row, head) in the kernel's epilogue;
//   * _mha_flash_int8_handoff_kernel: entry flash_int8_handoff, q the int8
//     qkv payload read in place (row stride 3C) with its per-(row, head)
//     scales from a table; out int8 per (row, head), bf16 or fp32.
// No other kernel serves these entry points.
//
// The function (the Pallas kernels compute the same):
// per query row and key block j of bk keys, with rs = qs * (ks_j * scale *
// log2 e):
//   s = float(qq . kq) * rs                          (the int32 dot is exact)
//   m_new = max(m, max of s over the WHOLE block)    (m starts at -1e30)
//   p127 = exp2(s - (m_new - log2 127)); l = l * exp2(m - m_new) + sum p127
//   (unrounded); pv = int32 sum over the block of rint(p127) * vq;
//   acc = acc * exp2(m - m_new) + float(pv) * vs_j;   out = acc * (1 / l).
// Two properties of this function shape the design:
//   [max pass] p is rounded against the block's maximum, not a running one,
//     so each block needs its row max before any p is formed: a one-pass
//     online softmax computes another function. Pass 1 is therefore a wgmma
//     into s32 followed by an INTEGER row max: rs is one positive number a
//     row within a block, and int-to-float conversion and a round-to-nearest
//     multiply by a positive number are both monotone, so the largest
//     __fmul_rn(float(S), rs) over a block is __fmul_rn(float(max S), rs),
//     the float the plain version takes its max of (at q/k past 1,040 float(S)
//     rounds, monotonically too). No float work and no exp in pass 1.
//     The function costs three int8 products (S twice, P.V) where a
//     bf16 flash costs two.
//   [exact pv] pv is an exact int32 sum: any key order gives the same bits,
//     so the keys of a 32-key group may sit in any order in V's layout (the
//     P layout below uses that).
//
// Bound. 2 * N^2 * (2 dq + dv) int8 operations a (batch, head) against
// inputs and outputs of tens of MB: the tensor cores bound it (phi='s'
// 640x640 batch 2, h1 + h2 + h4: 0.44 ms at the data sheet's 1,979 int8
// TOPS; the two-product count 0.29 ms). With v in `slices` slices ([v
// slices]) the kernel runs 2 N^2 (2 slices dq + dv) a head: at the phi 'l'
// neck heads (768 in 3 slices, 1,536 in 3) 7/3 and 13/3 of the bound's
// operations, at phi='x' h1 (3,584 in 7) 29/3.
//
// Design.
//   * Warpgroups. One thread of the producer warpgroup loads the int8 Q tile
//     once, then, per key block, pass 1 and pass 2 as one sequence of key
//     tiles: K (pass 1 and 2) in slabs of 64 or 128 columns through a ring
//     of `stages` slabs, and V (pass 2) through a ring of 1 or 2 stages,
//     each stage guarded by a full and an empty mbarrier.
//   * [q stream] Where the resident Q tile leaves no room (q/k 768 at 128
//     rows beside several key blocks' acc, 1,536 and 3,584 at 64 rows: the
//     phi 'l'/'x' neck heads), each ring stage carries the Q slab beside
//     the K slab it multiplies, both on the stage's barrier: Q is read from
//     L2 once per key tile and pass instead of once, and S is summed over
//     the q/k slabs in the accumulator (exact: |S| <= 3,584 * 127^2 <
//     2^31).
//   * S = Q K^T: wgmma m64nKTk32 .s32.s8.s8, both operands K-major in
//     shared memory under the TMA swizzle of their row: 128 bytes where dq
//     >= 128, 64 bytes at dq 64. Each slab's group stays in flight while the
//     next is issued; its stage is released as it retires. In pass 2 the
//     next tile's S is issued right behind this tile's P V, one wait for
//     both.
//   * P V: 8-bit wgmma cannot transpose an operand, so V must reach shared
//     memory with keys contiguous per v column. The wrapper makes a
//     key-major copy of vq, (B, H, dv, N), before the kernel
//     (ops/attention_int8.py::vq_key_major: one pass over B * N * Cv bytes);
//     TMA loads its (KT keys x v columns) boxes, swizzled by KT bytes.
//     O_int32 += P V is the RS form: A = rint(p127) as int8 from registers.
//   * [P layout] The s32 accumulator of m64nKT holds, for rows g and g + 8
//     of a warp's 16, keys {8c + 2t, 8c + 2t + 1} of each 8-key chunk c (t
//     = lane % 4); the k32 A fragment wants positions {4t .. 4t + 3} and
//     {16 + 4t .. 16 + 4t + 3} of a 32-key group. vq_key_major puts key
//     16h + 8c + 2t + e of each 32-key group at position 16h + 4t + 2c + e
//     (h, c, e in {0, 1}, t in 0..3), so the accumulator IS the A fragment:
//     register 2h + (row g + 8), byte 2c + e, keys 32kk + 16h + 8c + 2t + e;
//     exact by [exact pv] (N and bk are multiples of 32: no group straddles
//     a block).
//   * Forms (ops/attention_int8.py::int8_sm90_plan): dv up to 256, the rows
//     form: 128 query rows a block, each consumer warpgroup on 64 of them
//     with all of v (key tiles of 128 at dv 128, 64 at dv 256: pv is dv / 2
//     registers a thread beside the S accumulator). dv 384 and 512, the
//     split form: 64 rows a block, both warpgroups on the same rows, v
//     split between them (192 or 256 columns each), each computing its own
//     S and softmax. Measured against one S shared through shared memory
//     (warpgroup 0 computing it and handing rint(p127) over): 10-26% faster
//     at phi='m' h2, h4 and phi='s' dark3 (PERF.md), the second
//     warpgroup otherwise idling through both passes of q.k^T. Key tiles
//     of 128 at dv 256 were measured too: their accumulators spill.
//   * [v slices] v wider than 512 (dark3: 1,024 at phi='m', 2,048 and 4,096
//     at phi 'l'/'x'; the phi 'l'/'x' neck heads of 768 to 3,584): the
//     grid's second dimension runs over heads x v slices; each block takes
//     one slice of the plan's width (512 in the split form where 512
//     divides v: 4% faster than 256 in the rows form at phi='m', PERF.md;
//     else 256 in the rows form) in one of the forms above, recomputes S
//     (both passes) for its query tile and writes its slice of O. S is
//     cheap beside P V where q/k is narrow (128 against 1,024 at phi='m');
//     at the neck heads, where q/k equals v, it is most of the work (Bound).
//   * [cluster] An int8 output takes one amax over the head's whole v. With
//     v in slices, the head's slices run as one thread-block cluster (at
//     most 8 blocks): each block writes its rows' slice amax into its
//     shared memory, the cluster barrier publishes it, each block reads
//     every block's entries over distributed shared memory (mapa), and a
//     second cluster barrier keeps each block's shared memory alive until
//     its peers have read it. No fp32 workspace, no row pass.
//   * [narrow q/k] q/k of 32 (phi='n' dark3) is one k32 step: Q and K load
//     in 64-byte boxes of which TMA zero-fills the 32 bytes past the width,
//     and S issues one k step on the real 32 (a q/k width that is not a
//     multiple of the box issues only the steps that hold real columns).
//   * Accumulators. pv stays int32 in wgmma registers over a block. With one
//     key block (every phi 'n' and 's' site) acc = float(pv) * vs at the
//     end; with several (phi='m' h2) the fp32 acc lives in shared memory,
//     touched once per block. setmaxnreg gives the consumers 240 registers
//     and the producer 24.
//   * p127 = exp2 by ex2.approx (one MUFU instruction); exp2f's range
//     handling for results below the normal floats cost 10-20% of the
//     kernel (measured) and changes nothing that rounds to a nonzero p.
//   * [conversions] pass 2 converts each int32 score to float and each p
//     to an int: I2F and F2I run at a quarter of the fp32 rate, beside the
//     one MUFU ex2 an element. rint(p) goes through the fp32 adder (a
//     magic-number add, exact), and so does float(s) where q/k is at most
//     256 (|s| <= 256 * 128^2 = 2^22: phi 'n', 's' and 'm' dark3, the neck
//     heads of phi 'n' and 's'): the same bits, two quarter-rate
//     instructions fewer an element.
//   * Epilogues, all in the kernel: bf16 or fp32 values (o = acc * (1 / l)
//     with _rn products); or int8 per (row, head), amax over the head's
//     whole dv (a quad's reduction, in the split form across the two
//     warpgroups through shared memory, with slices across the cluster),
//     __float2int_rn(o * (127 / amax)), amax / 127.
//
// Trouble spots, each handled where its tag appears below:
//   [tail]        bk is a multiple of 32 but not always of the key tile
//                 (1,600 % 128 = 64, 4,320 % 64 = 32): past a block's end a
//                 tile holds the NEXT block's keys, valid memory that TMA
//                 does not zero; only past N does it zero-fill (and a zero
//                 key scores 0, not -inf). Both passes mask them: out of the
//                 max, p = 0 and so no pv.
//   [cluster]     above; the producer warpgroup arrives at both cluster
//                 barriers too (every thread of the cluster must).
//   [tensor maps] 4-D maps: q8 or the payload and kq as (width, heads, N, B)
//                 with row strides heads * dq or 3C; V's key-major copy as
//                 (N, dv, heads, B); every stride a multiple of 16 bytes (a
//                 one-head map at q/k 32: 32 bytes). A box wider than the
//                 width (q/k 32 in 64 bytes) is zero-filled past it.
//   [max pass]    the integer max, above; m starts at -1e30 as in the
//                 Pallas kernel.
//   [P layout]    above.
//   [bits]        pv is exact and l, acc and the epilogues take the plain
//                 version's arithmetic (__float2int_rn, _rn products); l
//                 is summed in another order, and p's exp2 may differ from
//                 exp2f in its last bit, which can move a rounded p by one
//                 (the int8 bars' +-1 flips). A missing wgmma wait or an
//                 mbarrier parity error shows as a run-to-run difference,
//                 which chip_smoke.py checks (every case runs twice).
//   [small grids] 128 rows a block in the rows form: phi='s' h4 at batch 1
//                 is 78 blocks on 132 SMs; time_serving.py times batch 1
//                 and 2.
//   [fences]      no wgmma group is in flight across the softmax's register
//                 writes (each product is waited for before them): a group
//                 left in flight there makes ptxas serialize every wgmma of
//                 the kernel (C7513, PERF.md).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "flash_int8_common.cuh"
#include "sm90_common.cuh"
#include "wgmma_s8.cuh"

namespace {

using namespace int8attn;
using namespace s8;
using namespace sm90;

constexpr int CONSUMERS = 2;  // consumer warpgroups, 64 rows each
constexpr int THREADS_SM90 = 128 * (CONSUMERS + 1);
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;      // [cluster] the portable cluster size
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
constexpr int ALIGN = 1024;         // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr int BARRIER_BYTES = 1024;
constexpr int AMAX_OFFSET = 512;    // split form: the two warpgroups' row amax
enum { BAR_AMAX = 5 };  // both consumer warpgroups sync (split form, int8 out)

struct Params {
  const float* qs_tab;  // per-(row, head) q scales (B, N, heads)
  const float* ks;      // (B, heads, nk)
  const float* vs;
  void* o;              // (B, N, heads * dv): bf16, fp32 or int8
  float* os;            // int8 out: its scales (B, N, heads)
  int n, heads, dq, dv, bk, nk;
  int swq;              // bytes of a q/k box row: 64 (dq up to 64) or 128
  int slabs;            // q/k boxes a row: ceil(dq / swq)
  int stages;           // K ring stages (one slab each)
  int v_stages;         // V ring stages
  int slices;           // [v slices] blocks a head's v is cut into
  int cluster;          // [cluster] blocks exchanging the int8 output's amax (1 or slices)
  int out_mode;         // Out
  float scale_log2;     // scale * log2(e)
};

// p127's exp2: ex2.approx (one MUFU.EX2), where exp2f adds range handling
// for results below the normal floats, which round to p = 0 here anyway
// and are a vanishing share of l ([bits])
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// [conversions] int <-> float through the fp32 adder, exactly: I2F and F2I
// run at a quarter of the fp32 rate, and pass 2 converts every score in
// and every p out. 1.5 * 2^23 has an ulp of 1, so adding a float x with
// |x| < 2^22 rounds it to the nearest integer, ties to even (rint), in the
// low mantissa bits; an int s with |s| <= 2^22 added to its bit pattern is
// 1.5 * 2^23 + s exactly.
constexpr int MAGIC_BITS = 0x4B400000;  // 1.5 * 2^23
constexpr float MAGIC = 12582912.f;
// |s| <= 2^22: every score of q/k up to 256 (256 * 128^2)
constexpr int SMALL_DQ = 256;
__device__ __forceinline__ float small_int_to_float(int s) {
  return __fsub_rn(__int_as_float(MAGIC_BITS + s), MAGIC);
}
__device__ __forceinline__ int rint_small(float x) {  // 0 <= x < 2^22
  return __float_as_int(__fadd_rn(x, MAGIC)) - MAGIC_BITS;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Grid (ceil(N / rows), heads * slices, B); block: consumer warpgroups 0 and 1,
// producer warpgroup 2. DVW: the v columns one consumer warpgroup owns; KT:
// keys a tile. Rows form: 128 rows, warpgroup w on rows 64w .. 64w + 63, all
// of v (DVW = dv). Split form: 64 rows, warpgroup w on v columns [w DVW,
// (w + 1) DVW), both computing S of the same rows; columns counted from the
// block's v slice ([v slices]). Shared memory, from a
// 1024-aligned base: barriers (and the split form's row amax) | Q | K ring |
// V ring | fp32 acc (several key blocks); with [q stream] no Q, each ring
// stage a Q slab then a K slab. SMALL: q/k up to SMALL_DQ, whose
// scores convert to float through the adder ([conversions]). QS: [q stream];
// CL: [cluster] (an int8 output on sliced v). Both are template flags, so
// the forms without them compile as they did before them.
template <int DVW, bool SPLIT, int KT, bool SMALL, bool QS, bool CL>
__global__ void __launch_bounds__(THREADS_SM90, 1)
    flash_int8_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int ROWS = SPLIT ? 64 : 128;
  constexpr int VROWS = (SPLIT ? 2 : 1) * DVW;  // v columns a V stage holds
  constexpr uint32_t V_BYTES = VROWS * KT;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  unsigned char* gbase = smem_raw + (base - raw);  // generic pointer to base
  const uint32_t bar_q = base;
  const uint32_t bar_kfull = base + 8, bar_kempty = bar_kfull + 8 * MAX_STAGES;
  const uint32_t bar_vfull = bar_kempty + 8 * MAX_STAGES, bar_vempty = bar_vfull + 16;
  float* amax_s = reinterpret_cast<float*>(gbase + AMAX_OFFSET);  // [2][64]
  const uint32_t q_slab = ROWS * p.swq;       // one Q box
  const uint32_t k_slab = KT * p.swq;         // one K box
  // [q stream] a ring stage: the K slab, after the Q slab when Q streams
  const uint32_t k_off = QS ? q_slab : 0;
  const uint32_t stage_bytes = k_off + k_slab;
  const uint32_t q_smem = base + BARRIER_BYTES;
  const uint32_t k_smem = q_smem + (QS ? 0 : p.slabs * q_slab);
  const uint32_t v_smem = k_smem + p.stages * stage_bytes;
  const uint32_t acc_off = v_smem + p.v_stages * V_BYTES - base;

  const int m0 = blockIdx.x * ROWS;
  const int head = blockIdx.y / p.slices;
  const int v0 = (blockIdx.y % p.slices) * VROWS;  // [v slices] the block's first v column
  const int b = blockIdx.z;
  const int tiles = (p.bk + KT - 1) / KT;  // key tiles a block
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar_kfull + 8 * s, 1);
      mbar_init(bar_kempty + 8 * s, CONSUMERS * 4);  // one arrival a reading warp
    }
    for (int s = 0; s < p.v_stages; ++s) {
      mbar_init(bar_vfull + 8 * s, 1);
      mbar_init(bar_vempty + 8 * s, CONSUMERS * 4);
    }
    // [fences] the initialised barriers visible to the async proxy (TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else for the whole kernel: the roles never reconverge, so ptxas
  // honours setmaxnreg.
  if (wg == CONSUMERS) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      if constexpr (!QS) {
        mbar_expect_tx(bar_q, p.slabs * q_slab);
        for (int c = 0; c < p.slabs; ++c)
          tma_load(q_smem + c * q_slab, &tq, bar_q, c * p.swq, head, m0, b);
      }
      int st = 0, ph = 0, vt = 0;  // K ring position; V tiles loaded
      for (int blk = 0; blk < p.nk; ++blk) {
        for (int pass = 0; pass < 2; ++pass) {
          for (int t = 0; t < tiles; ++t) {
            // [tail] the last tile may run into the next block (or past N,
            // zero-filled): the consumers mask those keys
            const int key0 = blk * p.bk + t * KT;
            for (int c = 0; c < p.slabs; ++c) {
              mbar_wait(bar_kempty + 8 * st, ph ^ 1);
              const uint32_t stage = k_smem + st * stage_bytes;
              mbar_expect_tx(bar_kfull + 8 * st, stage_bytes);
              if constexpr (QS)  // [q stream] Q's slab c beside K's
                tma_load(stage, &tq, bar_kfull + 8 * st, c * p.swq, head, m0, b);
              tma_load(stage + k_off, &tk, bar_kfull + 8 * st, c * p.swq, head, key0, b);
              if (++st == p.stages) {
                st = 0;
                ph ^= 1;
              }
            }
            if (pass == 1) {
              const int vs = vt % p.v_stages;
              mbar_wait(bar_vempty + 8 * vs, ((vt / p.v_stages) & 1) ^ 1);
              mbar_expect_tx(bar_vfull + 8 * vs, V_BYTES);
              for (int h = 0; h < VROWS / DVW; ++h)  // boxes of at most 256 rows
                tma_load(v_smem + vs * V_BYTES + h * DVW * KT, &tv, bar_vfull + 8 * vs, key0,
                         v0 + h * DVW, head, b);
              ++vt;
            }
          }
        }
      }
    }
    if constexpr (CL) {  // [cluster] every thread arrives at both phases
      cluster_sync();
      cluster_sync();
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int t4 = lane & 3;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the 64
    const int row_off = SPLIT ? 0 : wg * 64;  // this warpgroup's first row in the block
    const int col_off = v0 + (SPLIT ? wg * DVW : 0);  // and its first v column
    const int rows[2] = {m0 + row_off + r0, m0 + row_off + r0 + 8};
    const long long tab = (long long)b * p.n;
    float qs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      qs[r] = rows[r] < p.n ? p.qs_tab[(tab + rows[r]) * p.heads + head] : 0.f;
    const float* ksg = p.ks + ((long long)b * p.heads + head) * p.nk;
    const float* vsg = p.vs + ((long long)b * p.heads + head) * p.nk;
    float* acc_s = reinterpret_cast<float*>(gbase + acc_off) + wg * (DVW / 2) * 128 + tid;
    const bool multi = p.nk > 1;
    if (multi)
      for (int i = 0; i < DVW / 2; ++i) acc_s[i * 128] = 0.f;  // this thread's own entries

    float m_run[2] = {-1e30f, -1e30f};  // [max pass] the Pallas kernel's start
    float l_run[2] = {0.f, 0.f};        // summed over the quad at each block's end
    float corr[2] = {0.f, 0.f};
    int pv[DVW / 2];
    int st = 0, ph = 0;  // K ring position
    int vt = 0;          // V tiles consumed
    if constexpr (!QS) mbar_wait(bar_q, 0);  // Q has landed

    // one arrival a warp, after the warp's wgmma.wait_group covered the reads
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S = Q K^T of one key tile: slab by slab, one slab's group in flight
    // while the next is issued, each stage released as its group retires;
    // all waited for on return ([fences])
    auto s_tile = [&](int (&s)[KT / 2]) {
      int prev = -1;
      for (int c = 0; c < p.slabs; ++c) {
        const int cur = st;
        mbar_wait(bar_kfull + 8 * st, ph);
        const uint32_t stage = k_smem + st * stage_bytes;
        const uint32_t kb = stage + k_off;
        // [q stream] this warpgroup's rows of the stage's Q slab, or of the
        // resident tile's slab c
        const uint32_t qb = (QS ? stage : q_smem + c * q_slab) + row_off * p.swq;
        // [narrow q/k] past dq the box is zero-filled: only real columns
        const int ksteps = min(p.swq, p.dq - c * p.swq) / 32;
        wgmma_fence();
        for (int kk = 0; kk < ksteps; ++kk)
          wgmma_ss<KT>(s, desc_k_major(qb + kk * 32, p.swq), desc_k_major(kb + kk * 32, p.swq),
                       c > 0 || kk > 0);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(bar_kempty + 8 * prev);
        }
        prev = cur;
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      release(bar_kempty + 8 * prev);
    };
    // pv += P V of pass-2 tile `vt` on this warpgroup's v columns: issued
    // and committed; `pv_done` releases its V stage once a wait covered it
    auto pv_issue = [&](const uint32_t (&pa)[KT / 32][4], bool first) {
      const int vs = vt % p.v_stages;
      mbar_wait(bar_vfull + 8 * vs, (vt / p.v_stages) & 1);
      const uint32_t vb = v_smem + vs * V_BYTES + (SPLIT ? wg * DVW * KT : 0);
      wgmma_fence();  // [fences] pa was written by ordinary instructions
#pragma unroll
      for (int kk = 0; kk < KT / 32; ++kk)
        wgmma_rs<DVW>(pv, pa[kk], desc_k_major(vb + kk * 32, KT), !(first && kk == 0));
      wgmma_commit();
    };
    auto pv_done = [&]() {
      release(bar_vempty + 8 * (vt % p.v_stages));
      ++vt;
    };
    // end of a key block: acc = acc * corr + float(pv) * vs_j in shared
    // memory (several blocks; with one, acc is formed in the epilogue)
    auto fold = [&](int blk) {
      const float vsc = vsg[blk];
#pragma unroll
      for (int i = 0; i < DVW / 2; ++i) {
        float* a = acc_s + i * 128;
        *a = __fadd_rn(__fmul_rn(*a, corr[(i >> 1) & 1]),
                       __fmul_rn(static_cast<float>(pv[i]), vsc));
      }
    };

    for (int blk = 0; blk < p.nk; ++blk) {
      const float kss = ksg[blk] * p.scale_log2;
      const float rs[2] = {qs[0] * kss, qs[1] * kss};
      // pass 1: [max pass] the integer row max over the block's keys
      int imax[2] = {INT_MIN, INT_MIN};
      for (int t = 0; t < tiles; ++t) {
        int s[KT / 2];
        s_tile(s);
        const int kv = p.bk - t * KT;  // [tail] keys of this block in the tile
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kv >= KT || 8 * i + 2 * t4 + (e & 1) < kv)
              imax[e >> 1] = max(imax[e >> 1], s[4 * i + e]);
      }
      float sub[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        imax[r] = max(imax[r], __shfl_xor_sync(0xffffffff, imax[r], 1));
        imax[r] = max(imax[r], __shfl_xor_sync(0xffffffff, imax[r], 2));
        // [max pass] the float the plain version's max over __fmul_rn(float(S),
        // rs) gives: both maps are monotone (rs > 0)
        const float m_new = fmaxf(m_run[r], __fmul_rn(static_cast<float>(imax[r]), rs[r]));
        corr[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        sub[r] = m_new - LOG2_127;
      }
      // pass 2: p127 against the block max, rounded, then pv += P V
      float lsum[2] = {0.f, 0.f};
      int s[KT / 2];
      s_tile(s);
      for (int t = 0; t < tiles; ++t) {
        const int kv = p.bk - t * KT;
        uint32_t pa[KT / 32][4];
#pragma unroll
        for (int kk = 0; kk < KT / 32; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) pa[kk][j] = 0u;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = 4 * kk + c;  // the accumulator's 8-key chunk
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int si = s[4 * i + e];
              const float x = __fmul_rn(SMALL ? small_int_to_float(si) : static_cast<float>(si),
                                        rs[r]);
              // [tail] masked keys: p = 0, so no pv and nothing in l
              const float pe = 8 * i + 2 * t4 + (e & 1) < kv ? exp2_approx(x - sub[r]) : 0.f;
              lsum[r] += pe;
              const uint32_t q8 = static_cast<uint32_t>(min(rint_small(pe), 127));
              // [P layout] register 2h + r (h = c / 2), byte 2 (c % 2) + e % 2
              pa[kk][(c >> 1) * 2 + r] |= q8 << (8 * ((c & 1) * 2 + (e & 1)));
            }
          }
        }
        const bool last = t == tiles - 1;
        if (last) {  // the block's row sums: l = l * corr + sum p127
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            lsum[r] += __shfl_xor_sync(0xffffffff, lsum[r], 1);
            lsum[r] += __shfl_xor_sync(0xffffffff, lsum[r], 2);
            l_run[r] = __fadd_rn(__fmul_rn(l_run[r], corr[r]), lsum[r]);
          }
        }
        // [fences] P V of this tile and S of the next issued back to back,
        // both retired (s_tile's waits) before the next softmax writes a
        // register either reads
        pv_issue(pa, t == 0);
        if (!last) {
          s_tile(s);
        } else {
          wgmma_wait<0>();
        }
        pv_done();
      }
      if (multi) fold(blk);
    }

    // epilogue: o = acc * (1 / l); one block: acc = float(pv) * vs, as the
    // plain version forms it (0 * corr + float(pv) * vs)
    const float vs0 = vsg[0];
    const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
    auto o_at = [&](int i) {
      const float acc = multi ? acc_s[i * 128] : __fmul_rn(static_cast<float>(pv[i]), vs0);
      return __fmul_rn(acc, inv[(i >> 1) & 1]);
    };
    const long long o_row = static_cast<long long>(p.heads) * p.dv;
    const long long obase = tab * o_row + static_cast<long long>(head) * p.dv + col_off;
    const int v_cols = p.dv - col_off;  // valid columns from col_off
    if (p.out_mode == OUT_I8) {
      // int8 per (row, head): amax over the head's whole dv (floor 1e-30)
      float amax[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < DVW / 2; ++i)
        if (8 * (i >> 2) + 2 * t4 < v_cols) amax[(i >> 1) & 1] =
            fmaxf(amax[(i >> 1) & 1], fabsf(o_at(i)));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffff, amax[r], 1));
        amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffff, amax[r], 2));
      }
      if constexpr (SPLIT || CL) {
        // the other warpgroup's half of the row (split form) and the other
        // slices' columns ([cluster]): each row's entries in every block's
        // amax_s (rows form: [wg][row]; split form: both [0][row] and
        // [1][row])
        if (t4 == 0) {
          amax_s[wg * 64 + r0] = amax[0];
          amax_s[wg * 64 + r0 + 8] = amax[1];
        }
        if constexpr (CL) {
          cluster_sync();
          const uint32_t own = smem_addr(amax_s);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            for (int rank = 0; rank < p.cluster; ++rank)
#pragma unroll
              for (int h = 0; h < (SPLIT ? 2 : 1); ++h) {
                const int idx = (SPLIT ? h : wg) * 64 + r0 + 8 * r;
                amax[r] = fmaxf(amax[r], ld_cluster_f32(own + 4 * idx, rank));
              }
          cluster_sync();  // peers have read this block's amax_s
        } else {
          named_sync(BAR_AMAX);
          amax[0] = fmaxf(amax[0], amax_s[(1 - wg) * 64 + r0]);
          amax[1] = fmaxf(amax[1], amax_s[(1 - wg) * 64 + r0 + 8]);
        }
      }
      float qmul[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        amax[r] = fmaxf(amax[r], 1e-30f);
        qmul[r] = 127.f / amax[r];
      }
      int8_t* o8 = static_cast<int8_t*>(p.o) + obase;
#pragma unroll
      for (int i = 0; i < DVW / 8; ++i) {
        const int col = 8 * i + 2 * t4;
        if (col >= v_cols) continue;  // dv is a multiple of 64: the pair is whole
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (rows[r] >= p.n) continue;
          char2 v;
          v.x = static_cast<char>(__float2int_rn(__fmul_rn(o_at(4 * i + 2 * r), qmul[r])));
          v.y = static_cast<char>(__float2int_rn(__fmul_rn(o_at(4 * i + 2 * r + 1), qmul[r])));
          *reinterpret_cast<char2*>(o8 + rows[r] * o_row + col) = v;
        }
      }
      // one block of the cluster (the head's first slice) writes the scale
      if (t4 == 0 && (!SPLIT || wg == 0) && (!CL || blockIdx.y % p.slices == 0)) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < p.n) p.os[(tab + rows[r]) * p.heads + head] = amax[r] * INV127;
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < DVW / 8; ++i) {
      const int col = 8 * i + 2 * t4;
      if (col >= v_cols) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // query rows past N were computed on zero-filled q and are not stored
        if (rows[r] >= p.n) continue;
        const float o0 = o_at(4 * i + 2 * r), o1 = o_at(4 * i + 2 * r + 1);
        if (p.out_mode == OUT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.o) + obase + rows[r] * o_row + col) =
              make_float2(o0, o1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.o) + obase +
                                             rows[r] * o_row + col) =
              __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// [tensor maps] an int8 4-D map over `base`, dims innermost first, strides
// (of dims 1-3) in bytes, box `box`, swizzled by the box's inner bytes (64
// or 128). TMA zero-fills what lies outside the dims. The base and every
// stride must be multiples of 16 bytes; the map travels by value as a
// __grid_constant__ kernel parameter.
bool make_map(CUtensorMap* map, const void* base, const long long (&dims)[4],
              const long long (&strides)[3], const int (&box)[4]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  cuuint64_t d[4], s[3];
  cuuint32_t bx[4];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i < 3; ++i) {
    if (strides[i] % 16) return false;
    s[i] = static_cast<cuuint64_t>(strides[i]);
  }
  const CUtensorMapSwizzle sw =
      box[0] == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), d, s, bx, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory of a plan: alignment slack, barriers, the resident Q
// tile, the ring (a K slab a stage, after a Q slab with q_stream), the V
// ring, the fp32 acc (several key blocks).
// ops/attention_int8.py::int8_sm90_smem_bytes computes the same.
int plan_smem(int rows, int keys, int swq, int slabs, int v_cols, int split, int stages,
              int v_stages, int multi, int q_stream) {
  return ALIGN + BARRIER_BYTES + (q_stream ? 0 : rows * slabs * swq) +
         stages * (keys * swq + (q_stream ? rows * swq : 0)) +
         v_stages * (split ? 2 : 1) * v_cols * keys + (multi ? CONSUMERS * 64 * v_cols * 4 : 0);
}

template <int DVW, bool SPLIT, int KT, bool SMALL, bool QS, bool CL>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, int batch, int smem, cudaStream_t stream) {
  // per call, not cached: the attribute belongs to the current device
  auto* kernel = flash_int8_sm90_kernel<DVW, SPLIT, KT, SMALL, QS, CL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = SPLIT ? 64 : 128;
  const dim3 grid((p.n + rows - 1) / rows, p.heads * p.slices, batch);
  if constexpr (!CL) {
    flash_int8_sm90_kernel<DVW, SPLIT, KT, SMALL, QS, CL><<<grid, THREADS_SM90, smem, stream>>>(
        tq, tk, tv, p);
    return cudaGetLastError();
  }
  // [cluster] a head's v slices, consecutive in grid y, one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS_SM90);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<CUtensorMap*>(&tq), const_cast<CUtensorMap*>(&tk),
                  const_cast<CUtensorMap*>(&tv), const_cast<Params*>(&p)};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instantiation of a plan: its form and v columns a warpgroup
template <bool SMALL, bool QS, bool CL>
cudaError_t launch_form(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                        const Params& p, int v_cols, int split, int batch, int smem,
                        cudaStream_t st) {
  if (split)
    return v_cols == 192 ? launch<192, true, 64, SMALL, QS, CL>(tq, tk, tv, p, batch, smem, st)
                         : launch<256, true, 64, SMALL, QS, CL>(tq, tk, tv, p, batch, smem, st);
  return v_cols == 128 ? launch<128, false, 128, SMALL, QS, CL>(tq, tk, tv, p, batch, smem, st)
                       : launch<256, false, 64, SMALL, QS, CL>(tq, tk, tv, p, batch, smem, st);
}

// and its score conversion, Q resident or streamed (only past q/k 512: the
// plain conversion), and cluster
template <bool CL>
cudaError_t launch_plan(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                        const Params& p, int v_cols, int split, int q_stream, int batch,
                        int smem, cudaStream_t st) {
  if (q_stream) return launch_form<false, true, CL>(tq, tk, tv, p, v_cols, split, batch, smem, st);
  return p.dq <= SMALL_DQ
             ? launch_form<true, false, CL>(tq, tk, tv, p, v_cols, split, batch, smem, st)
             : launch_form<false, false, CL>(tq, tk, tv, p, v_cols, split, batch, smem, st);
}

}  // namespace

extern "C" {

// Indices of the launch plan, ops/attention_int8.py::int8_sm90_plan.
enum { PLAN_ROWS, PLAN_KEYS, PLAN_SWQ, PLAN_V_COLS, PLAN_SPLIT, PLAN_STAGES, PLAN_V_STAGES,
       PLAN_MULTI, PLAN_SLICES, PLAN_Q_STREAM, PLAN_CLUSTER, PLAN_SMEM, PLAN_LEN };

// int8 flash attention of `heads` heads on Hopper. q: q_kind 0 (bf16) or 1
// (fp32), (B, N, *) with row stride q_row elements, head h at column h * dq,
// quantized first into the workspace q8 (B, N, heads * dq) int8 and q_scales
// (B, N, heads) f32; or q_kind 2, the int8 qkv payload (B, N, q_row), read
// in place with the per-(row, head) scales qs (B, N, heads). kq (B, N, heads
// * dq) int8; vt the key-major copy of vq, (B, heads, dv, N) int8 with the
// keys of each 32-key group in the [P layout] order; ks, vs (B, heads, nk)
// f32. out (B, N, heads * dv): out_mode 0 bf16, 1 fp32, 2 int8 with
// out_scales (B, N, heads) f32. scale_log2 = scale * log2(e), rounded to f32
// from double as JAX rounds its weakly typed constant. `plan` (PLAN_LEN
// ints) must be one this library was built for: v in `slices` slices of
// dv / slices columns, each in the rows form (128 rows, slices of 128 on
// 128-key tiles or of 256 on 64-key tiles) or the split form (64 rows, 192
// or 256 v columns a warpgroup, 64-key tiles); cluster 1, or for an int8
// output on sliced v cluster == slices (at most 8); q/k a multiple of 32
// in boxes of 64 bytes at dq up to 64, else 128, Q resident or streamed
// (q_stream 0 or 1; streamed in 128-byte boxes); 1-8 ring stages and 1-2 V
// stages; multi == (nk > 1); the shared memory it needs within the card's
// 227 KB. Anything else returns
// cudaErrorInvalidValue, as does a failed tensor-map encode. Returns the
// cudaError_t of the launches.
int flash_int8_sm90(const void* q, int q_kind, const void* qs, const void* kq, const void* ks,
                    const void* vt, const void* vs, void* q8, void* q_scales, void* out,
                    void* out_scales, int out_mode, int batch, int n, int heads, int dq, int dv,
                    long long q_row, int bk, int nk, float scale_log2, const int* plan,
                    void* stream) {
  const int rows = plan[PLAN_ROWS], keys = plan[PLAN_KEYS], swq = plan[PLAN_SWQ];
  const int v_cols = plan[PLAN_V_COLS], split = plan[PLAN_SPLIT], stages = plan[PLAN_STAGES];
  const int v_stages = plan[PLAN_V_STAGES], multi = plan[PLAN_MULTI], smem = plan[PLAN_SMEM];
  const int slices = plan[PLAN_SLICES], q_stream = plan[PLAN_Q_STREAM];
  const int cluster = plan[PLAN_CLUSTER];
  const int slabs = (dq + swq - 1) / swq;
  const bool rows_ok = split == 0 && rows == 128 &&
                       ((v_cols == 128 && keys == 128) || (v_cols == 256 && keys == 64));
  const bool split_ok = split == 1 && rows == 64 && keys == 64 && (v_cols == 192 || v_cols == 256);
  if (!(rows_ok || split_ok) || slices < 1 || (split ? 2 : 1) * v_cols * slices != dv ||
      cluster != (out_mode == OUT_I8 ? slices : 1) || cluster > MAX_CLUSTER ||
      q_stream < 0 || q_stream > 1 || (q_stream && swq != 128) ||
      batch < 1 || heads < 1 || n <= 0 || n % 32 ||
      bk <= 0 || bk % 32 || bk * nk != n || dq <= 0 || dq % 32 ||
      swq != (dq <= 64 ? 64 : 128) ||
      stages < 1 || stages > MAX_STAGES || v_stages < 1 || v_stages > 2 ||
      multi != (nk > 1 ? 1 : 0) || out_mode < OUT_BF16 || out_mode > OUT_I8 || q_kind < 0 ||
      q_kind > 2 || (q_kind == 2 && qs == nullptr) || (out_mode == OUT_I8 && !out_scales) ||
      smem != plan_smem(rows, keys, swq, slabs, v_cols, split, stages, v_stages, multi,
                        q_stream) ||
      smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* q_int8 = q;
  const float* qs_tab = static_cast<const float*>(qs);
  long long q8_row = q_row;  // bytes
  if (q_kind < 2) {
    cudaError_t err = quant_q(q, q_kind, static_cast<int>(q_row), batch * n, heads, dq, q8,
                              q_scales, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    q_int8 = q8;
    qs_tab = static_cast<const float*>(q_scales);
    q8_row = static_cast<long long>(heads) * dq;
  }
  // [tensor maps] q and kq as (width, heads, N, B); V's copy as (N, dv,
  // heads, B)
  CUtensorMap tq, tk, tv;
  const long long cq = static_cast<long long>(heads) * dq;
  if (!make_map(&tq, q_int8, {dq, heads, n, batch}, {dq, q8_row, q8_row * n},
                {swq, 1, rows, 1}) ||
      !make_map(&tk, kq, {dq, heads, n, batch}, {dq, cq, cq * n}, {swq, 1, keys, 1}) ||
      !make_map(&tv, vt, {n, dv, heads, batch},
                {n, static_cast<long long>(dv) * n, static_cast<long long>(heads) * dv * n},
                {keys, v_cols, 1, 1}))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.qs_tab = qs_tab;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.o = out;
  p.os = static_cast<float*>(out_scales);
  p.n = n;
  p.heads = heads;
  p.dq = dq;
  p.dv = dv;
  p.bk = bk;
  p.nk = nk;
  p.swq = swq;
  p.slabs = slabs;
  p.stages = stages;
  p.v_stages = v_stages;
  p.slices = slices;
  p.cluster = cluster;
  p.out_mode = out_mode;
  p.scale_log2 = scale_log2;
  // the instantiations, one a plan the rule picks
  return static_cast<int>(
      cluster > 1 ? launch_plan<true>(tq, tk, tv, p, v_cols, split, q_stream, batch, smem, st)
                  : launch_plan<false>(tq, tk, tv, p, v_cols, split, q_stream, batch, smem, st));
}

}  // extern "C"
