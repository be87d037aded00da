// Flash-attention forward for Hopper (sm_90a) on fp32 inputs: fp32-accurate
// products on the tensor cores as 3xTF32, wgmma fed by a TMA ring, one
// producer warpgroup and two consumer warpgroups a block, after a pre-pass
// that splits every operand into its tf32 high and low parts.
//
// Replaces, for fp32 inputs, at every width (the whole fp32 domain: q/k and v
// widths that are multiples of 8, any N, any number of packed heads):
//   * transparent_object_detection_tpu/ops/attention.py::_mha_flash_kernel
//     (flash_attention_mha_packed): serving, q/k/v column views of the packed
//     (B, N, 3C) qkv array, out (B, N, C);
//   * transparent_object_detection_tpu/ops/attention.py::_flash_kernel
//     (flash_attention_pallas): one head, q/k width dq, v width dv (dark3's
//     SelfAttention; the folded heads, zero-padded to a multiple of 8);
//   * transparent_object_detection_tpu/ops/attention_vjp.py::_fwd_lse_kernel
//     (flash_fwd_lse): training, the same kernel with the lse store enabled.
// ops/attention.py::packed_fwd_form states the rule.
//
// Arithmetic, that of the Pallas kernels on fp32 inputs, per query row i:
// s_ij = (q_i . k_j) * scale * log2(e), accumulated in fp32; an exp2-domain
// online softmax whose running max starts at -1e30; p_ij = exp2(s_ij - m)
// kept in fp32, never rounded; l and acc in fp32; out = acc * (1 / l) in
// fp32; with lse, lse_i = (m + log2 l) * ln 2, one per (batch, head, row),
// the layout the backward (flash_attn_bwd.cu) reads. Each product a.b is
// taken as a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, where x_hi is x with the 13
// low mantissa bits cleared (a tf32 value) and x_lo = x - x_hi (exact in
// fp32, itself a tf32 value but for 2 bits): the dropped a_lo.b_lo and the
// truncation of x_lo are about 2^-21 of the product, far inside the fp32 bar
// (1e-4 of |plain| + 1e-4 of max|plain|), where one tf32 product (2^-11 to
// 2^-10, biased by the truncation) lands outside it.
//
// Bound. 2 * N^2 * (dqk + dv) fp32 operations a (batch, head), which as
// three tf32 products run at 495 / 3 = 165 TFLOP/s on the H100's tensor
// cores (fp32 FMA on the CUDA cores: 67 TFLOP/s): phi='m' 640x640 batch 2,
// h2 + h4 (8 heads of 384): about 6.5 ms.
//
// Design.
//   * The pre-pass (split_rows_kernel, split_vt_kernel, launched before the
//     attention kernel on the same stream): writes q_hi, q_lo, k_hi, k_lo
//     contiguous (B, N, heads * d) and V transposed, (B, heads, dv, N_pad)
//     with the keys contiguous, hi and lo. hi is stored explicitly with its
//     low bits cleared, so nothing rests on what the tensor core does with
//     an operand's low 13 bits. [key-major V] [P fragments]
//   * TMA loads. One thread of the producer warpgroup loads, per 64-key
//     tile, q/k in 16-column slabs (one 64-byte swizzle row) through a ring
//     of `stages` stages, each stage K hi and lo (64 keys) and, where Q does
//     not stay resident, Q hi and lo (the block's rows); then V^T hi and lo
//     of the block's v in chunks (sliced form: two of 32 keys, 128-byte
//     rows; split form below: four of 16) through a ring of `v_stages`.
//     Each stage is guarded by a full and an empty mbarrier. Q stays
//     resident (loaded once) where the block's rows of its hi and lo fit
//     beside the rings (q/k widths up to 128 at the routed sites); wider
//     heads stream it with K and read it again from L2 for every key tile.
//     The slab is 16 columns, not the 32 a 128-byte row holds, so that
//     twice the stages fit (measured faster, PERF.md).
//   * S = Q K^T: each consumer warpgroup owns 64 query rows and issues, per
//     8-column step, three wgmma m64n64k8 tf32 (hi.hi, hi.lo, lo.hi) with
//     both operands in shared memory (K-major), one slab's group in flight
//     while the next is issued, each stage released as its group retires.
//     hi.hi and the two cross terms go to two accumulators, summed after
//     the tile: the tensor core truncates its fp32 sum at every add, and one
//     accumulator for all three tripled those losses (lse off plain by
//     1.1e-4 at q/k 600, N = 1,100, score std 4, where the fp32 bar is 1e-4).
//   * The online softmax runs on the S accumulator in registers; P is split
//     in registers into its hi (in place) and lo parts.
//   * O += P V: three wgmma m64nDVk8 tf32 a step with A = P hi or lo from
//     registers (the RS form) and B = V^T hi or lo from shared memory.
//   * v wider than one warpgroup's 256 fp32 accumulator columns: the split
//     form where q/k is wider than 128 (heads of 288 to 3,584): 64-row
//     blocks whose warpgroup 0 computes S and the softmax once and hands
//     P's A fragments (thread t of warpgroup 1 holds the same rows, so the
//     fragments pass as they stand, hi and lo) and the row rescale to
//     warpgroup 1 through shared memory; each runs P.V on its half of 2 x
//     192 or 2 x 256 columns, V^T arriving in 16-key chunks (64-byte rows)
//     through a ring, each chunk's products issued as it lands. At phi='m'
//     h2 (8 heads of 384) that is one S for 384 columns, not one for each
//     of two 192-column slices: measured faster there, at h4 and at the
//     folded heads (PERF.md). Elsewhere (dark3: q/k 64 and 128 against v
//     512 and 1,024, whose S is cheap) v runs in slices across 128-row
//     blocks, each recomputing S; `f32_sm90_plan` picks the form and the
//     slice (64, 128, 192 or 256 columns) by the widths.
//   * setmaxnreg gives the consumers 240 registers (O alone is DV / 2 a
//     thread; S, its cross terms and P's low part 32 each) and the producer
//     24. Descriptors advance from one base a slab (2 a k8 step): computed
//     one by one they took the registers DV = 256 needed (80 bytes spilled,
//     every wgmma serialized, C7512).
//   Tried and dropped (bring-up runs): two v slices' blocks paired in a
//   cluster, each q/k stage multicast into both (half the L2 reads of Q and
//   K), slower at every paired site, with two 48 KB stages and with five
//   of 24 KB.
//
// Trouble spots, each handled where its tag appears below:
//   [key-major V]   tf32 wgmma reads B from shared memory K-major only (the
//                   transpose bit is for 16-bit types): V is transposed by
//                   the pre-pass
//   [P fragments]   the accumulator of m64nNk8 gives a thread keys 2c, 2c + 1
//                   of each 8-key chunk, the A fragment of m64nNk8 wants
//                   columns c and c + 4: V^T stores each group of 8 keys in
//                   the order [0, 2, 4, 6, 1, 3, 5, 7]
//   [ragged N]      keys and query rows past N
//   [tensor maps]   cuTensorMapEncodeTiled, the parameter space, alignment
//   [lse]           the contract with the backward
//   [fences]        wgmma fences, groups and mbarrier phases
//   [hand-over]     the split form's P, rescale and row sums between the
//                   consumer warpgroups (named barriers 1-3)
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int BM = 128;            // query rows a block, 64 a consumer warpgroup
constexpr int KT = 64;             // keys a tile
constexpr int SLAB = 16;           // q/k columns a ring stage: a 64-byte box row
constexpr int QK_ROW = SLAB * 4;   // bytes
constexpr int V_CHUNK = 32;        // keys a V stage (sliced form): a 128-byte V^T box row
constexpr int V_CHUNK_SPLIT = 16;  // keys a V stage (split form): a 64-byte V^T box row
constexpr int CONSUMERS = 2;
constexpr int THREADS_F32 = 128 * (CONSUMERS + 1);
constexpr int MAX_STAGES = 8;
constexpr int MAX_V_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;
constexpr int ALIGN = 1024;
constexpr int BARRIER_BYTES = 1024;
constexpr int K_SLAB_BYTES = KT * QK_ROW;  // one of hi, lo: 4 KB
// the split form's hand-over: P's fragments (hi and lo, 8 k8 steps, a float4
// a thread each), the row rescale and the row sums (a float2 a thread each)
constexpr int XCHG_BYTES = (KT / 8) * 2 * 128 * 16 + 2 * 128 * 8;
constexpr uint32_t TF32_MASK = 0xffffe000u;  // clears the 13 low mantissa bits
constexpr int PRE_THREADS = 256;

struct F32Params {
  float* o;          // (B, N, heads * dv)
  float* lse;        // (B, heads, N), or null (serving)
  int n, heads, dv;
  int slabs;         // ceil(dqk / SLAB)
  int dv_splits;     // v slices a head, one a block
  int stages;        // q/k ring stages
  int v_stages;      // V ring stages
  int q_resident;    // Q loaded once (else Q hi and lo in every q/k stage)
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & TF32_MASK);
}

// ---------------------------------------------------------------------------
// the pre-pass
// ---------------------------------------------------------------------------

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

// [key-major V] [P fragments] V (B, N, heads * dv view) -> V^T hi and lo,
// (B, heads, dv, n_pad) contiguous: row d of head h holds v[key][h * dv + d]
// with the keys of each group of 8 in the order [0, 2, 4, 6, 1, 3, 5, 7];
// keys at or past N are 0. Grid (n_pad / 32, ceil(dv / 32), B * heads), block
// (32, 8): a 32-key x 32-column tile through shared memory.
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

// ---------------------------------------------------------------------------
// the attention kernel
// ---------------------------------------------------------------------------

template <int DV>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[DV / 2], const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (DV == 64) wgmma_rs_tf32_n64(d, a, db);
  if constexpr (DV == 128) wgmma_rs_tf32_n128(d, a, db);
  if constexpr (DV == 192) wgmma_rs_tf32_n192(d, a, db);
  if constexpr (DV == 256) wgmma_rs_tf32_n256(d, a, db);
}

// Named barriers of the split form (sm90_common.cuh's named_sync and
// named_arrive, 256 threads: the two consumer warpgroups).
enum { BAR_P_FULL = 1, BAR_P_EMPTY = 2, BAR_L = 3 };

// Grid (ceil(N / rows), heads * dv_splits, B); block: consumer warpgroups 0
// and 1, producer warpgroup 2. Sliced form (SPLIT false): 128 rows, the
// consumers own rows 0-63 and 64-127 of the block's v slice of DV columns,
// V^T in two 32-key chunks a tile. Split form (SPLIT true): 64 rows, both
// consumers on the same rows, warpgroup 0 on v columns [0, DV) and
// warpgroup 1 on [DV, 2 DV) of the block's 2 DV; warpgroup 0 alone computes
// S and the softmax and hands P's fragments and the row rescale to
// warpgroup 1; V^T in four 16-key chunks a tile, both halves a stage,
// through a ring of v_stages. Shared memory, from a 1024-aligned base:
// barriers | the split form's hand-over (P's fragments, the row rescale,
// the row sums) | Q hi and lo, slab by slab (resident form) | the q/k ring
// (a stage: K hi, K lo, and in the streamed form Q hi, Q lo) | the V ring.
// Every TMA box and every tile is 1024-aligned.
template <int DV, bool SPLIT>
__global__ void __launch_bounds__(THREADS_F32, 1)
    flash_fwd_f32_sm90_kernel(const __grid_constant__ CUtensorMap tqh,
                              const __grid_constant__ CUtensorMap tql,
                              const __grid_constant__ CUtensorMap tkh,
                              const __grid_constant__ CUtensorMap tkl,
                              const __grid_constant__ CUtensorMap tvh,
                              const __grid_constant__ CUtensorMap tvl, const F32Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int ROWS = SPLIT ? 64 : BM;
  constexpr int VK = SPLIT ? V_CHUNK_SPLIT : V_CHUNK;  // keys a V stage
  constexpr int VROW = VK * 4;                         // bytes a V^T box row
  constexpr int V_CHUNKS = KT / VK;                    // V stages a key tile
  constexpr uint32_t V_BOX = DV * VROW;                // one of hi, lo, one half
  constexpr uint32_t V_STAGE = (SPLIT ? 2 : 1) * 2 * V_BOX;
  constexpr uint32_t Q_SLAB = ROWS * QK_ROW;           // one of hi, lo
  // the split form's Q and K are read by warpgroup 0 alone
  constexpr int K_READERS = (SPLIT ? 1 : CONSUMERS) * 4;
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t bar_q = base;
  const uint32_t bar_kfull = base + 8, bar_kempty = bar_kfull + 8 * MAX_STAGES;
  const uint32_t bar_vfull = bar_kempty + 8 * MAX_STAGES;
  const uint32_t bar_vempty = bar_vfull + 8 * MAX_V_STAGES;
  const uint32_t xchg = base + BARRIER_BYTES;  // split form: P's fragments | rescale | sums
  const uint32_t q_smem = xchg + (SPLIT ? XCHG_BYTES : 0);
  const uint32_t q_bytes = p.q_resident ? p.slabs * 2 * Q_SLAB : 0;
  const uint32_t stage_bytes = 2 * K_SLAB_BYTES + (p.q_resident ? 0 : 2 * Q_SLAB);
  const uint32_t k_smem = q_smem + q_bytes;
  const uint32_t v_smem = k_smem + p.stages * stage_bytes;

  const int m0 = blockIdx.x * ROWS;
  const int head = blockIdx.y / p.dv_splits;
  const int split = blockIdx.y % p.dv_splits;
  const int b = blockIdx.z;
  const int n_tiles = (p.n + KT - 1) / KT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar_kfull + 8 * s, 1);
      mbar_init(bar_kempty + 8 * s, K_READERS);  // one arrival a reading warp
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
      // [ragged N] rows past N and columns past the width arrive zero-filled
      if (p.q_resident) {
        mbar_expect_tx(bar_q, q_bytes);
        for (int c = 0; c < p.slabs; ++c) {
          const uint32_t dst = q_smem + c * 2 * Q_SLAB;
          tma_load(dst, &tqh, bar_q, c * SLAB, head, m0, b);
          tma_load(dst + Q_SLAB, &tql, bar_q, c * SLAB, head, m0, b);
        }
      }
      int st = 0, ph = 0, vst = 0, vph = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int c = 0; c < p.slabs; ++c) {
          mbar_wait(bar_kempty + 8 * st, ph ^ 1);
          const uint32_t dst = k_smem + st * stage_bytes, bar = bar_kfull + 8 * st;
          mbar_expect_tx(bar, stage_bytes);
          tma_load(dst, &tkh, bar, c * SLAB, head, t * KT, b);
          tma_load(dst + K_SLAB_BYTES, &tkl, bar, c * SLAB, head, t * KT, b);
          if (!p.q_resident) {
            tma_load(dst + 2 * K_SLAB_BYTES, &tqh, bar, c * SLAB, head, m0, b);
            tma_load(dst + 2 * K_SLAB_BYTES + Q_SLAB, &tql, bar, c * SLAB, head, m0, b);
          }
          if (++st == p.stages) {
            st = 0;
            ph ^= 1;
          }
        }
        // V^T of the tile, chunk by chunk through the V ring; coordinates
        // (key, v row, head, batch); rows past dv (the last slice or half)
        // are zero-filled
        for (int j = 0; j < V_CHUNKS; ++j) {
          mbar_wait(bar_vempty + 8 * vst, vph ^ 1);
          const uint32_t dst = v_smem + vst * V_STAGE, bar = bar_vfull + 8 * vst;
          mbar_expect_tx(bar, V_STAGE);
#pragma unroll
          for (int half = 0; half < (SPLIT ? 2 : 1); ++half) {
            const int row = (SPLIT ? 2 : 1) * split * DV + half * DV;
            tma_load(dst + half * 2 * V_BOX, &tvh, bar, t * KT + j * VK, row, head, b);
            tma_load(dst + half * 2 * V_BOX + V_BOX, &tvl, bar, t * KT + j * VK, row, head, b);
          }
          if (++vst == p.v_stages) {
            vst = 0;
            vph ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const uint32_t q_rows = SPLIT ? 0 : wg * 64 * QK_ROW;  // this warpgroup's rows in Q
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-1e30f, -1e30f};
    float l_run[2] = {0.f, 0.f};  // this thread's share, summed over the quad at the end
    const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the 64
    int st = 0, ph = 0, vst = 0, vph = 0;
    if (p.q_resident && (!SPLIT || wg == 0)) mbar_wait(bar_q, 0);  // Q has landed
    // one arrival a warp, after the warp's wgmma.wait_group covered the reads
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto rescale = [&](const float(&corr)[2]) {
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        o[4 * i] *= corr[0];
        o[4 * i + 1] *= corr[0];
        o[4 * i + 2] *= corr[1];
        o[4 * i + 3] *= corr[1];
      }
    };
    // split form: O += P V on this warpgroup's half of the block's v, chunk
    // by chunk as each 16-key V stage lands, one chunk's group in flight
    // while the next is issued, each stage released as its group retires.
    // [P fragments] fh[i] / fl[i]: the A fragment (hi, lo) of k8 step i
    auto pv_chunks = [&](const uint32_t(&fh)[KT / 8][4], const uint32_t(&fl)[KT / 8][4],
                         int half) {
      int prev = -1;
#pragma unroll
      for (int j = 0; j < V_CHUNKS; ++j) {
        const int cur = vst;
        mbar_wait(bar_vfull + 8 * vst, vph);
        const uint32_t vb = v_smem + vst * V_STAGE + half * 2 * V_BOX;
        const uint64_t dvh = desc_k_major(vb, VROW), dvl = desc_k_major(vb + V_BOX, VROW);
        wgmma_fence();  // [fences] o, fh and fl were written by ordinary instructions
#pragma unroll
        for (int kk = 0; kk < VK / 8; ++kk) {
          const int i = j * (VK / 8) + kk;
          wgmma_rs_tf32<DV>(o, fh[i], dvh + 2 * kk);
          wgmma_rs_tf32<DV>(o, fh[i], dvl + 2 * kk);
          wgmma_rs_tf32<DV>(o, fl[i], dvh + 2 * kk);
        }
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(bar_vempty + 8 * prev);
        }
        prev = cur;
        if (++vst == p.v_stages) {
          vst = 0;
          vph ^= 1;
        }
      }
      wgmma_wait<0>();
      release(bar_vempty + 8 * prev);
    };
    // the split form's hand-over: float4 (i, hi or lo, thread) of P's
    // fragments, then float2 (thread) of the row rescale
    float4* xf = reinterpret_cast<float4*>(smem_raw + (xchg - smem_u32(smem_raw)));
    float2* xc = reinterpret_cast<float2*>(xf + (KT / 8) * 2 * 128);
    float2* xl = xc + 128;

    if (!SPLIT || wg == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        // S = Q K^T, slab by slab, three tf32 products a step: hi.hi into s,
        // the two cross terms into e, added once the tile is done (the
        // tensor core's fp32 accumulation truncates each add to the running
        // sum: fewer adds into the large one, fewer such losses); one slab's
        // group in flight while the next is issued, each stage released as
        // its group retires. (No group stays in flight across the softmax:
        // C7513, ptxas would serialize every wgmma of the kernel.)
        float s[KT / 2], e[KT / 2];
        // slab c: wait for its stage, issue its products, commit
        auto issue = [&](int c) {
          mbar_wait(bar_kfull + 8 * st, ph);
          const uint32_t kh = k_smem + st * stage_bytes;
          const uint32_t qh =
              (p.q_resident ? q_smem + c * 2 * Q_SLAB : kh + 2 * K_SLAB_BYTES) + q_rows;
          // a k8 step adds 32 bytes, 2 in the descriptor's address field
          const uint64_t dqh = desc_k_major(qh, QK_ROW);
          const uint64_t dql = desc_k_major(qh + Q_SLAB, QK_ROW);
          const uint64_t dkh = desc_k_major(kh, QK_ROW);
          const uint64_t dkl = desc_k_major(kh + K_SLAB_BYTES, QK_ROW);
          wgmma_fence();  // [fences] before the first wgmma that touches s and e
#pragma unroll
          for (int kk = 0; kk < SLAB / 8; ++kk) {
            wgmma_ss_tf32_n64(s, dqh + 2 * kk, dkh + 2 * kk, c > 0 || kk > 0);
            wgmma_ss_tf32_n64(e, dqh + 2 * kk, dkl + 2 * kk, c > 0 || kk > 0);
            wgmma_ss_tf32_n64(e, dql + 2 * kk, dkh + 2 * kk, 1);
          }
          wgmma_commit();
          if (++st == p.stages) {
            st = 0;
            ph ^= 1;
          }
        };
        int prev = st;
        issue(0);
        for (int c = 1; c < p.slabs; ++c) {
          const int cur = st;
          issue(c);
          wgmma_wait<1>();
          release(bar_kempty + 8 * prev);
          prev = cur;
        }
        wgmma_wait<0>();
        release(bar_kempty + 8 * prev);
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) s[i] += e[i];

        // online softmax in the exp2 domain on the accumulator: s[4i + e] is
        // row r0 + 8 * (e / 2), key 8i + 2 * (lane % 4) + e % 2
        const int n0 = t * KT;
        // [ragged N] TMA zero-fills the keys past N: they score 0, not -inf,
        // so they are masked here
        const bool ragged = n0 + KT > p.n;
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < KT / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * i + e] * p.scale_log2;
            if (ragged && n0 + 8 * i + 2 * (lane & 3) + (e & 1) >= p.n) x = -INFINITY;
            s[4 * i + e] = x;
            tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
          }
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffff, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffff, tmax[r], 2));
          const float m_new = fmaxf(m_run[r], tmax[r]);
          corr[r] = fast_exp2(m_run[r] - m_new);
          m_run[r] = m_new;
          l_run[r] *= corr[r];
        }
        // p in fp32 (l sums it unrounded), then split: hi in place, lo beside
        float plo[KT / 2];
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          const float pe = fast_exp2(s[i] - m_run[(i >> 1) & 1]);
          l_run[(i >> 1) & 1] += pe;
          s[i] = tf32_hi(pe);
          plo[i] = pe - s[i];
        }
        rescale(corr);

        // [P fragments] the A fragment of k8 step i holds (row r0, column
        // c), (r0 + 8, c), (r0, c + 4), (r0 + 8, c + 4), c = lane % 4:
        // columns c and c + 4 are the accumulator's keys 2c and 2c + 1,
        // which V^T's key order puts at rows c and c + 4 of the step
        uint32_t fh[KT / 8][4], fl[KT / 8][4];
#pragma unroll
        for (int i = 0; i < KT / 8; ++i) {
          fh[i][0] = __float_as_uint(s[4 * i]);
          fh[i][1] = __float_as_uint(s[4 * i + 2]);
          fh[i][2] = __float_as_uint(s[4 * i + 1]);
          fh[i][3] = __float_as_uint(s[4 * i + 3]);
          fl[i][0] = __float_as_uint(plo[4 * i]);
          fl[i][1] = __float_as_uint(plo[4 * i + 2]);
          fl[i][2] = __float_as_uint(plo[4 * i + 1]);
          fl[i][3] = __float_as_uint(plo[4 * i + 3]);
        }
        if constexpr (SPLIT) {
          // [hand-over] P(t) and the rescale to warpgroup 1: thread t of
          // warpgroup 1 holds the same rows, so it takes this thread's
          // fragments as they stand; the buffer is free once it has read
          // P(t - 1)
          if (t > 0) named_sync(BAR_P_EMPTY);
#pragma unroll
          for (int i = 0; i < KT / 8; ++i) {
            xf[(2 * i) * 128 + tid] = make_float4(__uint_as_float(fh[i][0]),
                                                  __uint_as_float(fh[i][1]),
                                                  __uint_as_float(fh[i][2]),
                                                  __uint_as_float(fh[i][3]));
            xf[(2 * i + 1) * 128 + tid] = make_float4(__uint_as_float(fl[i][0]),
                                                      __uint_as_float(fl[i][1]),
                                                      __uint_as_float(fl[i][2]),
                                                      __uint_as_float(fl[i][3]));
          }
          xc[tid] = make_float2(corr[0], corr[1]);
          named_arrive(BAR_P_FULL);
          pv_chunks(fh, fl, 0);
        } else {
          // O += P V, chunk j of the tile in V stage j
          mbar_wait(bar_vfull, vph);
          mbar_wait(bar_vfull + 8, vph);
          wgmma_fence();  // [fences] o, fh and fl were written by ordinary instructions
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint64_t dvh = desc_k_major(v_smem + j * V_STAGE, VROW);
            const uint64_t dvl = desc_k_major(v_smem + j * V_STAGE + V_BOX, VROW);
#pragma unroll
            for (int kk = 0; kk < VK / 8; ++kk) {
              const int i = 4 * j + kk;
              wgmma_rs_tf32<DV>(o, fh[i], dvh + 2 * kk);
              wgmma_rs_tf32<DV>(o, fh[i], dvl + 2 * kk);
              wgmma_rs_tf32<DV>(o, fl[i], dvh + 2 * kk);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          release(bar_vempty);
          release(bar_vempty + 8);
          vph ^= 1;
        }
      }
    } else if constexpr (SPLIT) {
      // warpgroup 1: O += P V on the second half, P's fragments handed over
      // [hand-over]
      for (int t = 0; t < n_tiles; ++t) {
        named_sync(BAR_P_FULL);
        uint32_t fh[KT / 8][4], fl[KT / 8][4];
#pragma unroll
        for (int i = 0; i < KT / 8; ++i) {
          const float4 h = xf[(2 * i) * 128 + tid], l = xf[(2 * i + 1) * 128 + tid];
          fh[i][0] = __float_as_uint(h.x);
          fh[i][1] = __float_as_uint(h.y);
          fh[i][2] = __float_as_uint(h.z);
          fh[i][3] = __float_as_uint(h.w);
          fl[i][0] = __float_as_uint(l.x);
          fl[i][1] = __float_as_uint(l.y);
          fl[i][2] = __float_as_uint(l.z);
          fl[i][3] = __float_as_uint(l.w);
        }
        const float2 c2 = xc[tid];
        if (t + 1 < n_tiles) named_arrive(BAR_P_EMPTY);  // read: warpgroup 0 may write P(t + 1)
        const float corr[2] = {c2.x, c2.y};
        rescale(corr);
        pv_chunks(fh, fl, 1);
      }
    }

    // out = acc / l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 2);
    }
    if constexpr (SPLIT) {  // [hand-over] warpgroup 1 takes the row sums of warpgroup 0
      if (wg == 0) {
        xl[tid] = make_float2(l_run[0], l_run[1]);
        named_arrive(BAR_L);
      } else {
        named_sync(BAR_L);
        const float2 l2 = xl[tid];
        l_run[0] = l2.x;
        l_run[1] = l2.y;
      }
    }
    const int row0 = m0 + (SPLIT ? 0 : wg * 64) + r0;
    const int rows[2] = {row0, row0 + 8};
    // [lse] the natural-log logsumexp of the scaled scores, (m + log2 l) *
    // ln 2, written once a row: by the first v slice (every slice computes
    // the same m and l) and, split, by warpgroup 0, which owns m; the
    // backward recomputes P from it
    if (p.lse != nullptr && split == 0 && (!SPLIT || wg == 0) && (lane & 3) == 0) {
      float* lse = p.lse + (static_cast<long long>(b) * p.heads + head) * p.n;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < p.n) lse[rows[r]] = (m_run[r] + log2f(l_run[r])) * LN2;
    }
    const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
    const long long o_row = static_cast<long long>(p.heads) * p.dv;
    const int col0 = SPLIT ? (2 * split + wg) * DV : split * DV;  // this warpgroup's first column
    float* og = p.o + static_cast<long long>(b) * p.n * o_row + head * p.dv + col0;
    const int v_cols = p.dv - col0;  // valid columns from col0
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int col = 8 * i + 2 * (lane & 3);
      if (col >= v_cols) continue;  // dv is a multiple of 8: the pair is whole
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // [ragged N] query rows past N were computed on zero-filled q and
        // are not stored
        if (rows[r] < p.n)
          *reinterpret_cast<float2*>(og + rows[r] * o_row + col) =
              make_float2(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// [tensor maps] a 4-D fp32 map, dims innermost first with strides in
// elements (each a multiple of 4: 16 bytes), boxes of box0 x box1 x box2 x 1
// under the swizzle of the box row's width (64 or 128 bytes); TMA
// zero-fills what lies outside the dims.
bool make_map_f32(CUtensorMap* map, const void* base, const long long (&dims)[4],
                  const long long (&strides)[3], int box0, int box1, int box2) {
  const EncodeTiled encode = encode_tiled();
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

// Dynamic shared memory of a plan: alignment slack, barriers, the split
// form's hand-over, Q hi and lo (resident form), the q/k ring, the V ring
// (sliced: two 32-key chunks of the slice; split: v_stages 16-key chunks of
// both halves; hi and lo). ops/attention.py::f32_sm90_smem_bytes computes
// the same.
int plan_smem(int slabs, int v_slice, int stages, int q_resident, int wg_split, int v_stages) {
  const int rows = wg_split ? 64 : BM;
  const int stage = 2 * K_SLAB_BYTES + (q_resident ? 0 : 2 * rows * QK_ROW);
  const int v_stage = (wg_split ? 2 : 1) * 2 * v_slice * 4 * (wg_split ? V_CHUNK_SPLIT : V_CHUNK);
  return ALIGN + BARRIER_BYTES + (wg_split ? XCHG_BYTES : 0) +
         (q_resident ? slabs * 2 * rows * QK_ROW : 0) + stages * stage + v_stages * v_stage;
}

template <int DV, bool SPLIT>
cudaError_t launch(const CUtensorMap (&maps)[6], const F32Params& p, int batch, int smem,
                   cudaStream_t stream) {
  // per call, not cached: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_sm90_kernel<DV, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = SPLIT ? 64 : BM;
  const dim3 grid((p.n + rows - 1) / rows, p.heads * p.dv_splits, batch);
  flash_fwd_f32_sm90_kernel<DV, SPLIT><<<grid, THREADS_F32, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Indices of the launch plan, ops/attention.py::f32_sm90_plan.
enum { PLAN_ROWS, PLAN_KEYS, PLAN_SLAB, PLAN_V_SLICE, PLAN_STAGES, PLAN_Q_RESIDENT,
       PLAN_DV_SPLITS, PLAN_WG_SPLIT, PLAN_V_STAGES, PLAN_SMEM, PLAN_LEN };

// fp32 forward of `heads` packed heads: q, k (B, N, heads * dqk) and v (B, N,
// heads * dv) given by pointer, batch stride and row stride in elements (head
// h at column h * dqk or h * dv; the packed qkv's sections are such views;
// strides multiples of 4, bases 16-byte aligned) -> out (B, N, heads * dv)
// fp32 contiguous, and with lse non-null lse (B, heads, N) fp32. Scratch the
// caller allocates: q_hi, q_lo (B, N, heads * dqk), k_hi, k_lo (the same),
// vt_hi, vt_lo (B, heads, dv, n_pad), n_pad = N rounded up to 64. dqk and dv
// multiples of 8. `plan` (PLAN_LEN ints) must be one this library was built
// for: 64-key tiles, 16-column slabs, 1-8 stages, and either 128 rows with v
// in dv_splits slices of 64, 128, 192 or 256 columns and two V stages
// (wg_split 0), or 64 rows with v in dv_splits slices of twice 192 or 256
// columns, one half a consumer warpgroup, and 2-4 V stages (wg_split 1);
// the shared memory it needs within the card's 227 KB. Anything else returns
// cudaErrorInvalidValue, as does a failed tensor-map encode. Launches the
// pre-pass, then the attention kernel, on `stream`.
int flash_fwd_f32_sm90(const float* q, const float* k, const float* v, float* out, float* lse,
                       float* q_hi, float* q_lo, float* k_hi, float* k_lo, float* vt_hi,
                       float* vt_lo, int batch, int n, int heads, int dqk, int dv, int n_pad,
                       long long q_batch, long long q_row, long long k_batch, long long k_row,
                       long long v_batch, long long v_row, float scale, const int* plan,
                       void* stream) {
  const int vs = plan[PLAN_V_SLICE], stages = plan[PLAN_STAGES], splits = plan[PLAN_DV_SPLITS];
  const int q_res = plan[PLAN_Q_RESIDENT], smem = plan[PLAN_SMEM];
  const int wg_split = plan[PLAN_WG_SPLIT], v_stages = plan[PLAN_V_STAGES];
  const int slabs = (dqk + SLAB - 1) / SLAB;
  const int rows = wg_split ? 64 : BM;
  const int cover = (wg_split ? 2 : 1) * vs;  // v columns a block covers
  const bool sliced_ok = wg_split == 0 && v_stages == 2 &&
                         (vs == 64 || vs == 128 || vs == 192 || vs == 256);
  const bool split_ok = wg_split == 1 && v_stages >= 2 && v_stages <= MAX_V_STAGES &&
                        (vs == 192 || vs == 256);
  if (!(sliced_ok || split_ok) || plan[PLAN_ROWS] != rows || plan[PLAN_KEYS] != KT ||
      plan[PLAN_SLAB] != SLAB || stages < 1 || stages > MAX_STAGES ||
      (q_res != 0 && q_res != 1) || batch < 1 || n < 1 || heads < 1 || dqk < 8 || dqk % 8 ||
      dv < 8 || dv % 8 || n_pad < n || n_pad % KT || splits < 1 || splits * cover < dv ||
      (splits - 1) * cover >= dv ||
      smem != plan_smem(slabs, vs, stages, q_res, wg_split, v_stages) || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the pre-pass
  const int wq = heads * dqk;
  const dim3 rows_grid((wq / 4 + PRE_THREADS - 1) / PRE_THREADS, n, batch);
  split_rows_kernel<<<rows_grid, PRE_THREADS, 0, st>>>(q, q_hi, q_lo, n, wq, q_batch, q_row);
  split_rows_kernel<<<rows_grid, PRE_THREADS, 0, st>>>(k, k_hi, k_lo, n, wq, k_batch, k_row);
  split_vt_kernel<<<dim3(n_pad / 32, (dv + 31) / 32, batch * heads), dim3(32, 8), 0, st>>>(
      v, vt_hi, vt_lo, n, n_pad, heads, dv, v_batch, v_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // [tensor maps] Q, K hi and lo (dqk, heads, N, B), boxes of 16 columns x
  // the block's rows or 64 keys; V^T hi and lo (n_pad, dv, heads, B), boxes
  // of 32 keys (sliced) or 16 (split) x the slice
  const long long qk_dims[4] = {dqk, heads, n, batch};
  const long long qk_strides[3] = {dqk, wq, static_cast<long long>(n) * wq};
  const long long v_dims[4] = {n_pad, dv, heads, batch};
  const long long v_strides[3] = {n_pad, static_cast<long long>(dv) * n_pad,
                                  static_cast<long long>(heads) * dv * n_pad};
  const int vk = wg_split ? V_CHUNK_SPLIT : V_CHUNK;
  CUtensorMap maps[6];
  if (!make_map_f32(&maps[0], q_hi, qk_dims, qk_strides, SLAB, 1, rows) ||
      !make_map_f32(&maps[1], q_lo, qk_dims, qk_strides, SLAB, 1, rows) ||
      !make_map_f32(&maps[2], k_hi, qk_dims, qk_strides, SLAB, 1, KT) ||
      !make_map_f32(&maps[3], k_lo, qk_dims, qk_strides, SLAB, 1, KT) ||
      !make_map_f32(&maps[4], vt_hi, v_dims, v_strides, vk, vs, 1) ||
      !make_map_f32(&maps[5], vt_lo, v_dims, v_strides, vk, vs, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  F32Params p;
  p.o = out;
  p.lse = lse;
  p.n = n;
  p.heads = heads;
  p.dv = dv;
  p.slabs = slabs;
  p.dv_splits = splits;
  p.stages = stages;
  p.v_stages = v_stages;
  p.q_resident = q_res;
  p.scale_log2 = scale * LOG2E;
  if (wg_split)
    return static_cast<int>(vs == 192 ? launch<192, true>(maps, p, batch, smem, st)
                                      : launch<256, true>(maps, p, batch, smem, st));
  switch (vs) {
    case 64: return static_cast<int>(launch<64, false>(maps, p, batch, smem, st));
    case 128: return static_cast<int>(launch<128, false>(maps, p, batch, smem, st));
    case 192: return static_cast<int>(launch<192, false>(maps, p, batch, smem, st));
    default: return static_cast<int>(launch<256, false>(maps, p, batch, smem, st));
  }
}

}  // extern "C"
