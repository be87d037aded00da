// Flash-attention backward for Hopper (sm_90a) on fp32 inputs: fp32-accurate
// products on the tensor cores as 3xTF32, wgmma fed by TMA rings, one
// producer warpgroup and two consumer warpgroups a block, two kernels and no
// atomics, after a pre-pass that splits every operand into its tf32 high and
// low parts (tf32_split.cuh).
//
// Replaces, for fp32 inputs, at every width (the whole fp32 domain: q/k and v
// widths that are multiples of 8, any N, packed heads or one, the folded
// heads as one head on B * H rows), the two TPU kernels of
// transparent_object_detection_tpu/ops/attention_vjp.py (flash_bwd):
//   * _bwd_dq_kernel  -> flash_bwd_dq_f32_kernel:  dq = sum_k dS K
//   * _bwd_dkv_kernel -> flash_bwd_dkv_f32_kernel: dk = sum_q dS^T Q,
//                                                 dv = sum_q P^T dO
// ops/attention_vjp.py::bwd_form states the rule ("f32_sm90" for every fp32
// call) and bwd_f32_sm90_plan the launch plans.
//
// Arithmetic, that of the Pallas kernels on fp32 inputs (_recompute_p_ds and
// its two callers; the astype there casts nothing), per (query, key) tile: S
// = Q K^T in fp32; P = exp2(S * scale * log2 e - lse * log2 e); dP = dO V^T;
// dS = P * (dP - D) * scale with D = rowsum(dO * O) (computed in PyTorch);
// dq, dk and dv summed in fp32. Each product a.b is taken as a_hi.b_hi +
// a_hi.b_lo + a_lo.b_hi, x_hi being x with its 13 low mantissa bits cleared
// and x_lo = x - x_hi (the dropped a_lo.b_lo and the truncation of x_lo are
// about 2^-21 of the product). The tile sizes only change the order of the
// fp32 sums.
//
// Bound. 2 * N^2 * (4 * dqk + 3 * dv) operations a (batch, head), the Pallas
// count (dq 2 * N^2 * (2 * dqk + dv), dk/dv 2 * N^2 * (2 * dqk + 2 * dv)),
// which as three tf32 products run at 495 / 3 = 165 TFLOP/s: phi='n'
// 640x640 batch 2, the four training sites, about 2.9 ms for dq and 4.0 for
// dk/dv. Output passes (below) add (passes - 1) * 2 * N^2 * (dqk + dv) to
// either kernel, and a warpgroup's output columns past the head width cost
// their products: none at heads of 128; at the folded 288 of phi='n' dq and
// dk/dv take three passes.
//
// Design. Every operand streams from L2 through TMA rings in 16-column
// slabs (64-byte rows, 64-byte swizzle: the layout a K-major wgmma operand
// reads) and 16-token chunks, hi and lo side by side in a stage, each stage
// guarded by a full and an empty mbarrier; the column tiles are 64 wide.
// Nothing is reduced across blocks, so the gradients keep the same bits
// from run to run.
//   * dq (a block: 128 query rows of one (batch, head), 64 a consumer
//     warpgroup; one ring that both read). Per key tile the producer streams
//     the dqk slabs of Q (128 rows) and K, the dv slabs of dO (128 rows) and
//     V, then four chunks of K^T; each warpgroup computes S = Q K^T and dP =
//     dO V^T for its own rows, three tf32 wgmma m64n64k8 a k8 step with both
//     operands in shared memory, then P, dS in registers and dQ += dS K on N
//     columns (64 or 128; wider heads in output passes, grid y). The
//     warpgroups never wait for each other, so each fills the other's gaps.
//   * dk/dv (a block: 64 keys of one (batch, head); keys are the wgmma M
//     dimension, so S^T = K Q^T and dP^T = V dO^T give P^T and dS^T in the
//     A layout of dV += P^T dO and dK += dS^T Q; a ring a warpgroup).
//     Warpgroup 0 computes S^T and P^T and accumulates dV (N0 columns),
//     warpgroup 1 computes dP^T, forms dS^T with the P^T that warpgroup 0
//     hands over through shared memory (two buffers behind named barriers, so
//     warpgroup 0 runs up to a tile ahead) and accumulates dK (N1 columns).
//     dV and dK of 128 columns each, or N0 = 128 and N1 = 64 where dv is
//     wider than dqk (dark3); wider gradients in output passes, each
//     recomputing S^T and dP^T.
//   * The gradient products take X = dS, P^T or dS^T from registers (the RS
//     form, hi and lo split in registers) and B from a transposed copy the
//     pre-pass writes (K^T for dQ, dO^T for dV, Q^T for dK) [key-major].
//   * setmaxnreg: 240 registers for the consumers (the gradient's N / 2 a
//     thread, its tile's fresh accumulator as many, X's fragments 64; S and
//     dP 32 each and their cross terms), 24 for the producer.
//   Tried and dropped (bring-up runs on the H100, not committed): the rows
//   of a block resident in shared memory (read once, fewer stages) in place
//   of streamed with every tile: no faster in dq, slower in dk/dv; one
//   producer thread filling both dk/dv rings in turn: the rings starved
//   each other; dq on 64-row blocks whose warpgroups split S and dP and
//   trade them: the hand-over kept the warpgroups in lockstep.
//
// Trouble spots, each handled where its tag appears below:
//   [key-major]  tf32 wgmma reads B from shared memory K-major only (the
//                transpose bit is for 16-bit types): the gradient products'
//                B come from transposed copies whose tokens run in the
//                order tf32_split.cuh's [token order] names, which puts the
//                accumulator's columns 2c, 2c + 1 where the A fragment wants
//                columns c, c + 4
//   [precision]  the tensor core truncates its fp32 sum at each add: hi.hi
//                and the cross terms of S and dP accumulate apart, and each
//                column tile's gradient product goes into a fresh
//                accumulator that is added to the running sum in fp32 (a
//                sum over N / 8 k8 steps of three products each in the
//                tensor core would lose about 2^-24 of itself an add)
//   [ragged N]   rows and columns past N (TMA zero-fills them: a zero-filled
//                column scores 0, not -inf, so P is set to 0 there
//                explicitly; lse and D are never read past N; rows past N
//                are never stored)
//   [exchange]   P^T between the dk/dv kernel's warpgroups (named barriers)
//   [fences]     wgmma fences, groups and mbarrier phases
//   [ring]       stage order and release
//   [tensor maps] cuTensorMapEncodeTiled, the parameter space, alignment
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"
#include "tf32_split.cuh"

namespace {

using namespace flash;
using namespace sm90;
using namespace tf32;

constexpr int KT = 64;                      // columns a tile
constexpr int SLAB = 16;                    // score-product columns a slab: a 64-byte box row
constexpr int ROW_BYTES = SLAB * 4;
constexpr int CHUNK = 16;                   // tokens a gradient-product chunk: a 64-byte box row
constexpr int BOX64 = 64 * ROW_BYTES;       // one of hi, lo of a 64-row slab: 4 KB
constexpr int DQ_ROWS = 128;                // query rows a dq block
constexpr int DKV_ROWS = 64;                // keys a dk/dv block
constexpr int THREADS_BWD = 384;            // consumer warpgroups 0 and 1, producer 2
constexpr int MAX_STAGES = 8;               // stages a ring
constexpr int SMEM_LIMIT = 232448;
constexpr int ALIGN = 1024;
constexpr int BARRIER_BYTES = 1024;
constexpr int XCHG_BYTES = 64 * 64 * 4;     // one fp32 64 x 64 tile handed over
// a dq stage: a slab of the 128 rows (hi, lo) and of the 64 columns (hi,
// lo), or a chunk of K^T; a dk/dv stage: a slab of the 64 rows and of the 64
// columns, or a chunk of the warpgroup's transposed copy
constexpr int DQ_SLAB_STAGE = 2 * 2 * BOX64 + 2 * BOX64;
constexpr int DKV_SLAB_STAGE = 4 * BOX64;
// [exchange] named barriers over the two consumer warpgroups (never 0):
// full and empty, one pair a P^T buffer
enum { BAR_P_FULL = 1, BAR_P_EMPTY = 3 };
// the maps: rows hi, lo; columns hi, lo; transposed hi, lo. dq: the score
// product's (Q, K, K^T), then the dP product's (dO, V); dk/dv: warpgroup 0's
// (K, Q, dO^T), then warpgroup 1's (V, dO, Q^T)
enum { M_RH, M_RL, M_CH, M_CL, M_YH, M_YL, M_COUNT };

struct BwdMaps {
  CUtensorMap m[2 * M_COUNT];
};

struct BwdF32Params {
  const float* lse;      // (B, heads, N)
  const float* dcap;     // (B, heads, N)
  float* out[2];         // dq: dq; dk/dv: dv (warpgroup 0), dk (warpgroup 1)
  long long out_batch[2], out_row[2];
  int out_width[2];      // their head widths: dqk; dv, dqk
  int slabs[2];          // slabs of the score and the dP products: ceil(dqk / 16), ceil(dv / 16)
  int n, heads, passes;
  int stages;            // stages a ring
  float scale, scale_log2;
};

// one arrival a warp, after the warp's wgmma.wait_group covered its reads
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// A ring of `stages` stages of `unit` bytes from `data`; full and empty
// barriers 8 bytes apart; stage g % stages in phase (g / stages) & 1.
struct Ring {
  uint32_t full, empty, data, unit;
  int stages, st, ph;
  __device__ __forceinline__ uint32_t wait() {  // [fences] the current stage, once it landed
    mbar_wait(full + 8 * st, ph);
    return data + st * unit;
  }
  __device__ __forceinline__ void advance() {
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
  }
};

// The producer's side: the next stage once its readers released it, with
// `bytes` expected on its full barrier.
__device__ __forceinline__ uint32_t next_stage(Ring& r, uint32_t bytes, uint32_t& bar) {
  mbar_wait(r.empty + 8 * r.st, r.ph ^ 1);
  bar = r.full + 8 * r.st;
  mbar_expect_tx(bar, bytes);
  const uint32_t dst = r.data + r.st * r.unit;
  r.advance();
  return dst;
}

// acc = A B^T over `slabs` 16-column slabs, one a stage: hi.hi into s, the
// two cross terms into e [precision]. In a stage, A's hi at a, its lo at a
// + a_lo; B's hi at b, its lo at b + BOX64. One stage's group in flight
// while the next is issued, each stage released as its group retires.
__device__ __forceinline__ void score_product(Ring& r, int slabs, uint32_t a, uint32_t a_lo,
                                              uint32_t b, float (&s)[32], float (&e)[32]) {
  int prev = -1;
  for (int c = 0; c < slabs; ++c) {
    const int cur = r.st;
    const uint32_t base = r.wait();
    // a k8 step adds 32 bytes, 2 in the descriptor's address field
    const uint64_t dah = desc_k_major(base + a, ROW_BYTES);
    const uint64_t dal = desc_k_major(base + a + a_lo, ROW_BYTES);
    const uint64_t dbh = desc_k_major(base + b, ROW_BYTES);
    const uint64_t dbl = desc_k_major(base + b + BOX64, ROW_BYTES);
    wgmma_fence();  // [fences] before the first wgmma that touches s and e
#pragma unroll
    for (int kk = 0; kk < SLAB / 8; ++kk) {
      wgmma_ss_tf32_n64(s, dah + 2 * kk, dbh + 2 * kk, c > 0 || kk > 0);
      wgmma_ss_tf32_n64(e, dah + 2 * kk, dbl + 2 * kk, c > 0 || kk > 0);
      wgmma_ss_tf32_n64(e, dal + 2 * kk, dbh + 2 * kk, 1);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      release(r.empty + 8 * prev);
    }
    prev = cur;
    r.advance();
  }
  wgmma_wait<0>();
  release(r.empty + 8 * prev);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] += e[i];
}

// acc (64 x N) += X (64 x 64 fp32, the accumulator layout of the score
// product) Y (the tile's 64 tokens of N rows of a transposed copy, in four
// 16-token chunks, one a stage: hi at the stage's start, lo N * 64 bytes on),
// into a fresh accumulator added to acc in fp32 [precision].
template <int N>
__device__ __forceinline__ void grad_product(Ring& r, const float (&x)[32], float (&acc)[N / 2]) {
  float part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
  int prev = -1;
#pragma unroll
  for (int j = 0; j < KT / CHUNK; ++j) {
    // [key-major] the A fragments of the chunk's two k8 steps, hi and lo,
    // built as the chunk is issued (fewer live registers than all eight at
    // once): k8 step i holds (row r0, column c), (r0 + 8, c), (r0, c + 4),
    // (r0 + 8, c + 4) of its 8 columns, c = lane % 4, which are the
    // accumulator's columns 2c and 2c + 1
    uint32_t fh[CHUNK / 8][4], fl[CHUNK / 8][4];
#pragma unroll
    for (int kk = 0; kk < CHUNK / 8; ++kk) {
      const int i = j * (CHUNK / 8) + kk;
      const float v[4] = {x[4 * i], x[4 * i + 2], x[4 * i + 1], x[4 * i + 3]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float h = tf32_hi(v[q]);
        fh[kk][q] = __float_as_uint(h);
        fl[kk][q] = __float_as_uint(v[q] - h);
      }
    }
    const int cur = r.st;
    const uint32_t yb = r.wait();
    const uint64_t dyh = desc_k_major(yb, ROW_BYTES);
    const uint64_t dyl = desc_k_major(yb + N * ROW_BYTES, ROW_BYTES);
    wgmma_fence();  // [fences] part, fh and fl were written by ordinary instructions
#pragma unroll
    for (int kk = 0; kk < CHUNK / 8; ++kk) {
      wgmma_rs_tf32<N>(part, fh[kk], dyh + 2 * kk);
      wgmma_rs_tf32<N>(part, fh[kk], dyl + 2 * kk);
      wgmma_rs_tf32<N>(part, fl[kk], dyh + 2 * kk);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      release(r.empty + 8 * prev);
    }
    prev = cur;
    r.advance();
  }
  wgmma_wait<0>();
  release(r.empty + 8 * prev);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
}

// The producer's chunks of a tile: four 16-token boxes of n_rows rows of a
// transposed copy from row `row` (coordinates token, row, head, batch; rows
// past the head width are zero-filled).
__device__ __forceinline__ void load_chunks(Ring& r, const CUtensorMap* m, int n_rows, int t,
                                            int row, int head, int b) {
  const uint32_t box = n_rows * ROW_BYTES;
  for (int j = 0; j < KT / CHUNK; ++j) {
    uint32_t bar;
    const uint32_t dst = next_stage(r, 2 * box, bar);
    tma_load(dst, m + M_YH, bar, t * KT + j * CHUNK, row, head, b);
    tma_load(dst + box, m + M_YL, bar, t * KT + j * CHUNK, row, head, b);
  }
}

// acc[4i + e] is row r0 + 8 * (e / 2), column 8i + 2 * (lane % 4) + e % 2 of
// the warpgroup's N columns: stored from `out` (its first row and column)
// where the column lies within `cols` and [ragged N] the row before N (the
// widths are multiples of 8: a pair is whole).
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], float* out, long long row,
                                           int row0, int n, int cols) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x & 127) / 32 * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    if (col >= cols) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row0 + r0 + 8 * h;
      if (rr < n)
        *reinterpret_cast<float2*>(out + rr * row + col) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void init_ring_barriers(const Ring& r, int readers) {
  for (int s = 0; s < r.stages; ++s) {
    mbar_init(r.full + 8 * s, 1);
    mbar_init(r.empty + 8 * s, readers);  // one arrival a reading warp
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// Grid (ceil(N / 128), heads * passes, B). Shared memory from a 1024-aligned
// base: barriers | the ring (a stage: a slab of the 128 rows and of the 64
// columns, hi and lo, or a K^T chunk). [ring] Per key tile: the dqk slabs of
// Q and K, the dv slabs of dO and V, four chunks of K^T; both warpgroups
// read every stage and release it.
template <int N>
__global__ void __launch_bounds__(THREADS_BWD, 1)
    flash_bwd_dq_f32_kernel(const __grid_constant__ BwdMaps maps, const BwdF32Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  Ring ring{base, base + 8 * MAX_STAGES, base + BARRIER_BYTES, DQ_SLAB_STAGE, p.stages, 0, 0};
  const int head = blockIdx.y / p.passes, pass = blockIdx.y % p.passes;
  const int row0 = blockIdx.x * DQ_ROWS;
  const int b = blockIdx.z;
  const int n_tiles = (p.n + KT - 1) / KT;
  const int wg = threadIdx.x / 128;
  const int col0 = pass * N, cols = min(N, p.out_width[0] - col0);
  if (threadIdx.x == 0) {
    init_ring_barriers(ring, 8);
    // [fences] the initialised barriers visible to the async proxy (TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else for the whole kernel: the roles never reconverge, so ptxas
  // honours setmaxnreg.
  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      // [ragged N] rows and columns past N and past the widths arrive
      // zero-filled
      for (int t = 0; t < n_tiles; ++t) {
        for (int prod = 0; prod < 2; ++prod) {  // Q and K, then dO and V
          const CUtensorMap* m = maps.m + M_COUNT * prod;
          for (int c = 0; c < p.slabs[prod]; ++c) {
            uint32_t bar;
            const uint32_t dst = next_stage(ring, DQ_SLAB_STAGE, bar);
            tma_load(dst, m + M_RH, bar, c * SLAB, head, row0, b);
            tma_load(dst + 2 * BOX64, m + M_RL, bar, c * SLAB, head, row0, b);
            tma_load(dst + 4 * BOX64, m + M_CH, bar, c * SLAB, head, t * KT, b);
            tma_load(dst + 5 * BOX64, m + M_CL, bar, c * SLAB, head, t * KT, b);
          }
        }
        load_chunks(ring, maps.m, N, t, col0, head, b);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<240>();
    const int lane = threadIdx.x % 32;
    const int r0 = (threadIdx.x % 128) / 32 * 16 + (lane >> 2);  // rows r0, r0 + 8 of the 64
    const int rows = row0 + 64 * wg;  // this warpgroup's first row
    const long long stat = (static_cast<long long>(b) * p.heads + head) * p.n;
    // [ragged N] per-row statistics, never read past N
    float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rows + r0 + 8 * h;
      if (row < p.n) {
        rl[h] = p.lse[stat + row] * LOG2E;
        rd[h] = p.dcap[stat + row];
      }
    }
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    const uint32_t a = wg * BOX64;  // this warpgroup's 64 of the stage's 128 rows
    for (int t = 0; t < n_tiles; ++t) {
      float s[32], dp[32];
      {
        float e[32];
        score_product(ring, p.slabs[0], a, 2 * BOX64, 4 * BOX64, s, e);   // S = Q K^T
        score_product(ring, p.slabs[1], a, 2 * BOX64, 4 * BOX64, dp, e);  // dP = dO V^T
      }
      // s[4i + e] is row r0 + 8 * (e / 2), key 8i + 2 * (lane % 4) + e % 2
      // of the tile; [ragged N] a zero-filled key scores 0: its P is set to 0
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = t * KT + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const float pr =
            key < p.n ? fast_exp2(s[i] * p.scale_log2 - rl[(i >> 1) & 1]) : 0.f;
        s[i] = pr * (dp[i] - rd[(i >> 1) & 1]) * p.scale;
      }
      grad_product<N>(ring, s, acc);  // dQ += dS K
    }
    store_rows<N>(acc, p.out[0] + static_cast<long long>(b) * p.out_batch[0] +
                           static_cast<long long>(head) * p.out_width[0] + col0,
                  p.out_row[0], rows, p.n, cols);
  }
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------

// Ring w of the dk/dv kernel: barriers at base + 128 w, data past the two
// P^T buffers (ring 1 after ring 0's stages), a stage the larger of a slab
// stage and a chunk of N_w rows, hi and lo.
template <int N0, int N1>
__device__ __forceinline__ Ring dkv_ring(uint32_t base, int w, int stages) {
  constexpr uint32_t unit0 = N0 * 2 * ROW_BYTES > DKV_SLAB_STAGE ? N0 * 2 * ROW_BYTES
                                                                 : DKV_SLAB_STAGE;
  constexpr uint32_t unit1 = N1 * 2 * ROW_BYTES > DKV_SLAB_STAGE ? N1 * 2 * ROW_BYTES
                                                                 : DKV_SLAB_STAGE;
  const uint32_t data0 = base + BARRIER_BYTES + 2 * XCHG_BYTES;
  const uint32_t bars = base + 16 * MAX_STAGES * w;
  return Ring{bars, bars + 8 * MAX_STAGES, w == 0 ? data0 : data0 + stages * unit0,
              w == 0 ? unit0 : unit1, stages, 0, 0};
}

// Consumer warpgroup WG of the dk/dv kernel: 0 computes S^T and P^T, hands
// P^T to warpgroup 1 where `partner`, and accumulates dV (its columns of
// this pass, `cols` from col0, if any); 1 computes dP^T, forms dS^T with
// that P^T and accumulates dK.
template <int N0, int N1, int WG>
__device__ __forceinline__ void dkv_consume(const BwdF32Params& p, uint32_t base,
                                            unsigned char* smem, int row0, int head, int b,
                                            int col0, int cols, bool partner) {
  constexpr int N = WG == 0 ? N0 : N1;
  Ring r = dkv_ring<N0, N1>(base, WG, p.stages);
  const int lane = threadIdx.x % 32;
  const int n_tiles = (p.n + KT - 1) / KT;
  const long long stat = (static_cast<long long>(b) * p.heads + head) * p.n;
  // [ragged N] the tile's per-column statistics (lse for P^T, D for dS^T),
  // never read past N: entry 2i + e is column 8i + 2 * (lane % 4) + e
  const float* src = (WG == 0 ? p.lse : p.dcap) + stat;
  const float mul = WG == 0 ? LOG2E : 1.f;
  float* xf = reinterpret_cast<float*>(smem + (base + BARRIER_BYTES - smem_u32(smem)));
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    // [exchange] P^T of tile t in buffer t % 2, [element][thread]: thread t
    // of warpgroup 1 holds the same (key, query) positions as thread t of
    // warpgroup 0
    const int buf = t & 1;
    float* x = xf + buf * (XCHG_BYTES / 4) + (threadIdx.x & 127);
    float cs[16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = t * KT + 8 * i + 2 * (lane & 3) + e;
        cs[2 * i + e] = q < p.n ? src[q] * mul : 0.f;
      }
    float s[32];
    {
      float e[32];
      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
      score_product(r, p.slabs[WG], 0, BOX64, 2 * BOX64, s, e);
    }
    // s[4i + e] is key r0 + 8 * (e / 2), query 8i + 2 * (lane % 4) + e % 2
    // of the tile
    if (WG == 0) {
      // P^T; [ragged N] a zero-filled query scores 0: its P^T is set to 0
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int q = t * KT + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        s[i] = q < p.n ? fast_exp2(s[i] * p.scale_log2 - cs[2 * (i >> 2) + (i & 1)]) : 0.f;
      }
      if (partner) {  // the buffer is free once warpgroup 1 read P^T(t - 2)
        if (t >= 2) named_sync(BAR_P_EMPTY + buf);
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i * 128] = s[i];
        named_arrive(BAR_P_FULL + buf);
      }
      if (cols > 0) grad_product<N>(r, s, acc);  // dV += P^T dO
    } else {
      named_sync(BAR_P_FULL + buf);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = x[i * 128] * (s[i] - cs[2 * (i >> 2) + (i & 1)]) * p.scale;
      if (t + 2 < n_tiles) named_arrive(BAR_P_EMPTY + buf);
      grad_product<N>(r, s, acc);  // dK += dS^T Q
    }
  }
  if (cols > 0)
    store_rows<N>(acc, p.out[WG] + static_cast<long long>(b) * p.out_batch[WG] +
                           static_cast<long long>(head) * p.out_width[WG] + col0,
                  p.out_row[WG], row0, p.n, cols);
}

// Grid (ceil(N / 64), heads * passes, B). Shared memory from a 1024-aligned
// base: barriers | two P^T buffers | ring 0 | ring 1 (a stage: a slab of the
// 64 rows and of the 64 columns, hi and lo, or a chunk of N_w rows of the
// warpgroup's transposed copy). [ring] Per query tile, ring w carries the
// slabs of warpgroup w's product (0: K and Q, dqk wide; 1: V and dO, dv
// wide), then, where the warpgroup owns columns in this pass, four chunks
// of its transposed copy (0: dO^T; 1: Q^T), each ring filled by a thread of
// its own.
template <int N0, int N1>
__global__ void __launch_bounds__(THREADS_BWD, 1)
    flash_bwd_dkv_f32_kernel(const __grid_constant__ BwdMaps maps, const BwdF32Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const int head = blockIdx.y / p.passes, pass = blockIdx.y % p.passes;
  const int row0 = blockIdx.x * DKV_ROWS;
  const int b = blockIdx.z;
  const int n_tiles = (p.n + KT - 1) / KT;
  const int wg = threadIdx.x / 128;
  // this pass's columns of dV (warpgroup 0) and dK (warpgroup 1)
  const int col0[2] = {pass * N0, pass * N1};
  const int cols[2] = {min(N0, p.out_width[0] - col0[0]), min(N1, p.out_width[1] - col0[1])};
  // warpgroup 1 forms dS^T only where it owns dK columns in this pass;
  // warpgroup 0 computes P^T whatever columns it owns
  const bool active1 = cols[1] > 0;
  if (threadIdx.x == 0) {
    init_ring_barriers(dkv_ring<N0, N1>(base, 0, p.stages), 4);
    init_ring_barriers(dkv_ring<N0, N1>(base, 1, p.stages), 4);
    // [fences] the initialised barriers visible to the async proxy (TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    // lane 0 of warp w fills ring w: the rings never wait for each other
    setmaxnreg_dec<24>();
    const int w = (threadIdx.x - 256) / 32;
    if (w < 2 && threadIdx.x % 32 == 0 && (w == 0 || active1)) {
      Ring r = dkv_ring<N0, N1>(base, w, p.stages);
      const CUtensorMap* m = maps.m + M_COUNT * w;
      // [ragged N] rows and columns past N and past the widths arrive
      // zero-filled
      for (int t = 0; t < n_tiles; ++t) {
        for (int c = 0; c < p.slabs[w]; ++c) {
          uint32_t bar;
          const uint32_t dst = next_stage(r, DKV_SLAB_STAGE, bar);
          tma_load(dst, m + M_RH, bar, c * SLAB, head, row0, b);
          tma_load(dst + BOX64, m + M_RL, bar, c * SLAB, head, row0, b);
          tma_load(dst + 2 * BOX64, m + M_CH, bar, c * SLAB, head, t * KT, b);
          tma_load(dst + 3 * BOX64, m + M_CL, bar, c * SLAB, head, t * KT, b);
        }
        if (cols[w] > 0) load_chunks(r, m, w == 0 ? N0 : N1, t, col0[w], head, b);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<240>();
    if (wg == 0)
      dkv_consume<N0, N1, 0>(p, base, smem_raw, row0, head, b, col0[0], cols[0], active1);
    else if (active1)
      dkv_consume<N0, N1, 1>(p, base, smem_raw, row0, head, b, col0[1], cols[1], true);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Dynamic shared memory of a plan (ops/attention_vjp.py::
// bwd_f32_sm90_smem_bytes computes the same): alignment slack, barriers,
// then dq: `stages` stages of its ring (a slab stage, 24 KB); dk/dv: two
// P^T buffers and `stages` stages of each ring, a stage of ring w the larger
// of a slab stage (16 KB) and a chunk of N_w rows (hi and lo).
int unit_bytes(int n_w) {
  return n_w * 2 * ROW_BYTES > DKV_SLAB_STAGE ? n_w * 2 * ROW_BYTES : DKV_SLAB_STAGE;
}
int dq_smem(int stages) { return ALIGN + BARRIER_BYTES + stages * DQ_SLAB_STAGE; }
int dkv_smem(int n0, int n1, int stages) {
  return ALIGN + BARRIER_BYTES + 2 * XCHG_BYTES + stages * (unit_bytes(n0) + unit_bytes(n1));
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const BwdMaps& maps, const BwdF32Params& p, int rows,
                   int batch, int smem, cudaStream_t stream) {
  // per call, not cached: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + rows - 1) / rows, p.heads * p.passes, batch);
  kernel<<<grid, THREADS_BWD, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

// [tensor maps] the row form (B, N, heads * w contiguous: dims (w, heads, N,
// B), boxes of 16 columns x box_rows rows) and the transposed form (B,
// heads, w, n_pad: dims (n_pad, w, heads, B), boxes of 16 tokens x n_rows
// rows) of one operand's hi and lo
bool rows_maps(CUtensorMap* m, float* const* hl, int batch, int n, int heads, int w,
               int box_rows) {
  const long long dims[4] = {w, heads, n, batch};
  const long long strides[3] = {w, static_cast<long long>(heads) * w,
                                static_cast<long long>(n) * heads * w};
  return make_map_f32(&m[0], hl[0], dims, strides, SLAB, 1, box_rows) &&
         make_map_f32(&m[1], hl[1], dims, strides, SLAB, 1, box_rows);
}
bool t_maps(CUtensorMap* m, float* const* hl, int batch, int n_pad, int heads, int w,
            int n_rows) {
  const long long dims[4] = {n_pad, w, heads, batch};
  const long long strides[3] = {n_pad, static_cast<long long>(w) * n_pad,
                                static_cast<long long>(heads) * w * n_pad};
  return make_map_f32(&m[0], hl[0], dims, strides, CHUNK, n_rows, 1) &&
         make_map_f32(&m[1], hl[1], dims, strides, CHUNK, n_rows, 1);
}

// Indices of a launch plan, ops/attention_vjp.py::bwd_f32_sm90_plan.
enum { PLAN_ROWS, PLAN_KEYS, PLAN_SLAB, PLAN_N0, PLAN_N1, PLAN_PASSES, PLAN_STAGES, PLAN_SMEM,
       PLAN_LEN };

// The plan check (anything else returns cudaErrorInvalidValue): the rows a
// block of the kernel, 64-column tiles, 16-column slabs; N0 and N1 a pair
// this library was built for (dq: N0 = N1, 64 or 128; dk/dv: 128 and 128,
// or 128 and 64); the passes that cover the gradients (dq: dqk in N0
// columns a pass; dk/dv: dv in N0 and dqk in N1, as many as the wider
// needs); 2-8 stages; the shared memory the plan names, as computed here,
// within the card's 227 KB.
bool plan_ok(bool dq, const int* plan, int dqk, int dv) {
  const int n0 = plan[PLAN_N0], n1 = plan[PLAN_N1], stages = plan[PLAN_STAGES];
  const bool pair_ok = dq ? n0 == n1 && (n0 == 64 || n0 == 128)
                          : n0 == 128 && (n1 == 128 || n1 == 64);
  if (!pair_ok || plan[PLAN_ROWS] != (dq ? DQ_ROWS : DKV_ROWS) || plan[PLAN_KEYS] != KT ||
      plan[PLAN_SLAB] != SLAB || stages < 2 || stages > MAX_STAGES)
    return false;
  const int dv_passes = (dv + n0 - 1) / n0, dk_passes = (dqk + n1 - 1) / n1;
  const int passes = dq ? (dqk + n0 - 1) / n0 : (dv_passes > dk_passes ? dv_passes : dk_passes);
  const int smem = dq ? dq_smem(stages) : dkv_smem(n0, n1, stages);
  return plan[PLAN_PASSES] == passes && plan[PLAN_SMEM] == smem && smem <= SMEM_LIMIT;
}

// The operands of one call: q, k (B, N, heads * dqk) and v, dO (B, N, heads
// * dv) by pointer, batch and row strides in elements (multiples of 4, bases
// 16-byte aligned; the packed qkv's sections are such views).
struct Operands {
  const float *q, *k, *v, *dO;
  long long q_batch, q_row, k_batch, k_row, v_batch, v_row, do_batch, do_row;
};

// The pre-pass, the maps and the launch of one kernel. scratch: hi and lo
// of q, k (B, N, heads * dqk) and v, dO (B, N, heads * dv), contiguous, then
// of the kernel's transposed copies (B, heads, width, n_pad): dq K^T; dk/dv
// dO^T and Q^T.
int run(bool dq, const Operands& o, const float* lse, const float* dcap, float* out0,
        float* out1, long long out0_batch, long long out0_row, long long out1_batch,
        long long out1_row, float* const* scratch, int batch, int n, int heads, int dqk, int dv,
        int n_pad, float scale, const int* plan, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || dqk < 8 || dqk % 8 || dv < 8 || dv % 8 || n_pad < n ||
      n_pad % KT || !plan_ok(dq, plan, dqk, dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the pre-pass [key-major]
  float* const* s = scratch;
  const int wq = heads * dqk, wv = heads * dv;
  split_rows(o.q, s[0], s[1], batch, n, wq, o.q_batch, o.q_row, st);
  split_rows(o.k, s[2], s[3], batch, n, wq, o.k_batch, o.k_row, st);
  split_rows(o.v, s[4], s[5], batch, n, wv, o.v_batch, o.v_row, st);
  split_rows(o.dO, s[6], s[7], batch, n, wv, o.do_batch, o.do_row, st);
  if (dq) {
    split_vt(o.k, s[8], s[9], batch, n, n_pad, heads, dqk, o.k_batch, o.k_row, st);
  } else {
    split_vt(o.dO, s[8], s[9], batch, n, n_pad, heads, dv, o.do_batch, o.do_row, st);
    split_vt(o.q, s[10], s[11], batch, n, n_pad, heads, dqk, o.q_batch, o.q_row, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n0 = plan[PLAN_N0], n1 = plan[PLAN_N1];
  BwdMaps maps;
  CUtensorMap* m = maps.m;
  CUtensorMap* m1 = m + M_COUNT;
  // [tensor maps] dq: Q (128-row boxes), K, K^T | dO (128-row boxes), V;
  // dk/dv: K, Q, dO^T | V, dO, Q^T
  const bool ok =
      dq ? rows_maps(m + M_RH, s + 0, batch, n, heads, dqk, DQ_ROWS) &&
               rows_maps(m + M_CH, s + 2, batch, n, heads, dqk, KT) &&
               t_maps(m + M_YH, s + 8, batch, n_pad, heads, dqk, n0) &&
               rows_maps(m1 + M_RH, s + 6, batch, n, heads, dv, DQ_ROWS) &&
               rows_maps(m1 + M_CH, s + 4, batch, n, heads, dv, KT)
         : rows_maps(m + M_RH, s + 2, batch, n, heads, dqk, DKV_ROWS) &&
               rows_maps(m + M_CH, s + 0, batch, n, heads, dqk, KT) &&
               t_maps(m + M_YH, s + 8, batch, n_pad, heads, dv, n0) &&
               rows_maps(m1 + M_RH, s + 4, batch, n, heads, dv, DKV_ROWS) &&
               rows_maps(m1 + M_CH, s + 6, batch, n, heads, dv, KT) &&
               t_maps(m1 + M_YH, s + 10, batch, n_pad, heads, dqk, n1);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  BwdF32Params p;
  p.lse = lse;
  p.dcap = dcap;
  p.out[0] = out0;
  p.out[1] = out1;
  p.out_batch[0] = out0_batch;
  p.out_row[0] = out0_row;
  p.out_batch[1] = out1_batch;
  p.out_row[1] = out1_row;
  p.out_width[0] = dq ? dqk : dv;
  p.out_width[1] = dqk;
  p.slabs[0] = (dqk + SLAB - 1) / SLAB;
  p.slabs[1] = (dv + SLAB - 1) / SLAB;
  p.n = n;
  p.heads = heads;
  p.passes = plan[PLAN_PASSES];
  p.stages = plan[PLAN_STAGES];
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  const int smem = plan[PLAN_SMEM];
  if (dq)
    err = n0 == 64 ? launch(flash_bwd_dq_f32_kernel<64>, maps, p, DQ_ROWS, batch, smem, st)
                   : launch(flash_bwd_dq_f32_kernel<128>, maps, p, DQ_ROWS, batch, smem, st);
  else
    err = n1 == 128
              ? launch(flash_bwd_dkv_f32_kernel<128, 128>, maps, p, DKV_ROWS, batch, smem, st)
              : launch(flash_bwd_dkv_f32_kernel<128, 64>, maps, p, DKV_ROWS, batch, smem, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dq of the fp32 flash backward of `heads` packed heads (q/k width dqk, v
// width dv, multiples of 8): q, k, v, dO by pointer, batch and row strides
// in elements (multiples of 4, bases 16-byte aligned; the packed qkv's
// sections are such views); lse and dcap (B, heads, N) fp32 contiguous; dq
// written through its batch and row strides (a column view of a packed dqkv
// is fine). `scratch` (10 pointers the caller allocates): hi and lo of q, k
// (B, N, heads * dqk), of v, dO (B, N, heads * dv), contiguous, and of K^T
// (B, heads, dqk, n_pad), n_pad = N rounded up to 64. `plan` (PLAN_LEN ints)
// must be one this library was built for; anything else returns
// cudaErrorInvalidValue, as does a failed tensor-map encode. Launches the
// pre-pass, then the kernel, on `stream`.
int flash_bwd_dq_f32_sm90(const float* q, const float* k, const float* v, const float* dO,
                          const float* lse, const float* dcap, float* dq, float* const* scratch,
                          int batch, int n, int heads, int dqk, int dv, int n_pad,
                          long long q_batch, long long q_row, long long k_batch, long long k_row,
                          long long v_batch, long long v_row, long long do_batch,
                          long long do_row, long long dq_batch, long long dq_row, float scale,
                          const int* plan, void* stream) {
  const Operands o = {q, k, v, dO, q_batch, q_row, k_batch, k_row, v_batch, v_row, do_batch,
                      do_row};
  return run(true, o, lse, dcap, dq, dq, dq_batch, dq_row, dq_batch, dq_row, scratch, batch, n,
             heads, dqk, dv, n_pad, scale, plan, stream);
}

// dk and dv of the same backward, one launch after the pre-pass, written
// through their strides; `scratch` (12 pointers): hi and lo of q, k, v, dO
// as for dq, then of dO^T (B, heads, dv, n_pad) and Q^T (B, heads, dqk,
// n_pad). Arguments and plan as flash_bwd_dq_f32_sm90.
int flash_bwd_dkv_f32_sm90(const float* q, const float* k, const float* v, const float* dO,
                           const float* lse, const float* dcap, float* dk, float* dv,
                           float* const* scratch, int batch, int n, int heads, int dqk, int dvw,
                           int n_pad, long long q_batch, long long q_row, long long k_batch,
                           long long k_row, long long v_batch, long long v_row,
                           long long do_batch, long long do_row, long long dk_batch,
                           long long dk_row, long long dv_batch, long long dv_row, float scale,
                           const int* plan, void* stream) {
  const Operands o = {q, k, v, dO, q_batch, q_row, k_batch, k_row, v_batch, v_row, do_batch,
                      do_row};
  return run(false, o, lse, dcap, dv, dk, dv_batch, dv_row, dk_batch, dk_row, scratch, batch, n,
             heads, dqk, dvw, n_pad, scale, plan, stream);
}

}  // extern "C"
