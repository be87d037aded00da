// Flash-attention backward for Hopper (sm_90a), bf16, the wide form: S and
// dP formed once per entry point by a wgmma kernel fed by a TMA ring, P and
// dS handed to bf16 wgmma GEMMs through a workspace in device memory, no
// atomics.
//
// Replaces, for the bf16 calls that neither csrc/flash_bwd_sm90.cu (packed
// heads of equal widths, multiples of 64 up to 384) nor
// csrc/flash_bwd_single_sm90.cu (one head where its plan fits) takes, the
// two TPU kernels of transparent_object_detection_tpu/ops/attention_vjp.py
// (flash_bwd): the neck heads of phi 'l' and 'x' (8 heads of 768, 1,536
// and 3,584) and their tensor-parallel local shapes (1 to 8 heads), dark3
// of phi 'l' and 'x' (one head, q/k 256 and 512, v 2,048 and 4,096), and
// every other width that is a multiple of 8 (unequal widths, v narrower
// than q/k, widths off the 64 grid), any N:
//   * _bwd_dq_kernel  -> flash_bwd_dq_wide_sm90:  dq = sum_k dS K
//   * _bwd_dkv_kernel -> flash_bwd_dkv_wide_sm90: dk = sum_q dS^T Q,
//                                                 dv = sum_q P^T dO
// ops/attention_vjp.py::bwd_form states the rule, bwd_wide_sm90_plan the
// plan, which this library recomputes and refuses if it differs.
//
// Arithmetic, that of flash_bwd_dq_plain / flash_bwd_dkv_plain and of the
// Pallas kernels (_recompute_p_ds and its two callers), per (query, key):
// S = Q K^T in fp32; P = exp2(S * scale * log2 e - lse * log2 e); dP = dO
// V^T; dS = P * (dP - D) * scale with D = rowsum(dO * O) (computed in
// PyTorch); P and dS rounded to bf16 before their products; dq, dk and dv
// summed in fp32 and stored in bf16.
//
// Bound. The Pallas count, 2 N^2 (2 dqk + dv) operations an image and head
// for dq and 2 N^2 (2 dqk + 2 dv) for dk/dv, is what these kernels do:
// each entry point forms S and dP once (the dq entry point's S and dP are
// the Pallas dq kernel's recompute). The workspace adds 2 bytes a score
// written and read for dq (dS) and 4 for dk/dv (P and dS): at phi='l' h2,
// batch 2, 1.31 GB each, against 3.05 (dq) and 4.07 ms (dk/dv) of
// operations at the data sheet's 989 TFLOP/s bf16; the tensor cores bound
// it.
//
// Why this design. At heads of 768 one 64-row block's fp32 dQ is 192 KB,
// three quarters of the SM's registers, and Q and dO resident for 64 rows
// take 192 KB of the 227 KB of shared memory; at 1,536 and 3,584 neither
// fits. A fused kernel must then form S and dP again for every slice of the
// output's columns (the mma.sync template took up to seven passes). Here
// the contraction and the gradient product are apart:
//   * wide_scores_kernel<MODE> (a block: 128 rows x 128 tokens of one
//     (batch, head); warpgroup w its rows 64w..64w+63): one TMA ring of
//     stages, each a 128 x 64 slab of the rows' operand and one of the
//     tokens' (32 KB, 128-byte swizzle), carries S's q/k slabs, then dP's v
//     slabs; each consumer warpgroup sums them as m64n128k16 SS products
//     into S (64 registers) and dP (64). MODE_DQ: rows are queries (S = Q
//     K^T, dP = dO V^T, lse and D per row); MODE_DKV: rows are keys (S^T = K
//     Q^T, dP^T = V dO^T, lse and D per column), so dS^T and P^T come out of
//     the accumulator in the A layout of dK and dV. P and dS are written in
//     bf16 to the workspace in wgmma's register-fragment order: a tile of 64
//     rows x 64 tokens is 8 KB, [k16 step][thread][4 registers], each
//     thread's 16 bytes beside its neighbours' (coalesced stores).
//   * wide_grad_kernel (a block: 128 output rows x 256 gradient columns;
//     warpgroup w its 64 rows): the ring carries, a 64-token tile a stage,
//     the two row tiles' fragments (one 1-D bulk copy of 8 KB each) and the
//     token rows of K, Q or dO (four 64 x 64 boxes, read MN-major); each
//     consumer loads its 16 fragment registers from shared memory and issues
//     four m64n256k16 RS products into a 64 x 256 fp32 accumulator (128
//     registers). Each output tile is summed over all of N by one block in
//     token order: the gradient has the same bits from run to run.
//   The dq entry point: scores (MODE_DQ, dS only), then dq = dS K. The
//   dk/dv entry point: scores (MODE_DKV, P^T and dS^T), then dk = dS^T Q
//   and dv = P^T dO, two launches of the same kernel. The (batch, head)
//   pairs go in groups whose workspace stays within the plan's bound
//   (WORKSPACE_LIMIT bytes, at least one pair a group): each group is one
//   launch of each kernel.
//   * setmaxnreg: the producer warpgroup gives up 144 registers a thread
//     (168 -> 24), the consumers take exactly that (168 -> 240).
//
// Trouble spots, each handled where its tag appears below:
//   [ragged N]   rows and tokens past N: TMA zero-fills them, a zero-filled
//                token scores 0 (not -inf), so P (and dS) is set to 0 there;
//                lse and D are never read past N; N is padded to 128 in the
//                workspace, whose tiles past N hold zeros; rows past N are
//                never stored
//   [columns]    widths that are not multiples of 64 (or, in the GEMM, of
//                256): TMA zero-fills the columns past the head's width,
//                which add nothing, and output columns past it are never
//                stored
//   [fences]     wgmma fences, pinned accumulators and drained groups (else
//                ptxas serializes the wgmma pipeline), mbarrier phases
//   [ring]       stage order and release
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int SLAB = 64;                    // columns of a slab
constexpr int TILE = 128;                   // rows and tokens of a score block
constexpr int TOK = 64;                     // tokens (and rows) of a workspace tile
constexpr int GCOLS = 256;                  // gradient columns of a GEMM block
constexpr int THREADS_SM90 = 384;           // consumer warpgroups 0 and 1, producer 2
constexpr int SMEM_LIMIT = 232448;          // dynamic shared memory a block may use
constexpr int ALIGN = 1024;                 // a swizzle atom: 8 rows of 128 bytes
constexpr int BARRIER_BYTES = 1024;
constexpr int MAX_STAGES = 8;
constexpr int HALF_BYTES = 64 * 128;        // 64 rows of a 64-column bf16 slab; a workspace tile
constexpr int SCORE_STAGE = 2 * TILE * 128;  // the rows' and the tokens' 128 x 64 slabs
constexpr int GRAD_STAGE = 2 * HALF_BYTES + (GCOLS / SLAB) * HALF_BYTES;
constexpr long long WORKSPACE_LIMIT = 2147483648LL;  // bytes of a group's workspace

enum { MODE_DQ = 0, MODE_DKV = 1 };

__host__ __device__ constexpr int stages_of(int stage_bytes) {
  return (SMEM_LIMIT - ALIGN - BARRIER_BYTES) / stage_bytes < MAX_STAGES
             ? (SMEM_LIMIT - ALIGN - BARRIER_BYTES) / stage_bytes
             : MAX_STAGES;
}
constexpr int SCORE_STAGES = stages_of(SCORE_STAGE);  // 7
constexpr int GRAD_STAGES = stages_of(GRAD_STAGE);    // 4
constexpr int SCORE_SMEM = ALIGN + BARRIER_BYTES + SCORE_STAGES * SCORE_STAGE;
constexpr int GRAD_SMEM = ALIGN + BARRIER_BYTES + GRAD_STAGES * GRAD_STAGE;

struct ScoreParams {
  const float* lse;   // (B, heads, N)
  const float* dcap;  // (B, heads, N)
  uint4* ws_p;        // P^T (MODE_DKV), the group's fragment tiles
  uint4* ws_ds;       // dS (MODE_DQ) or dS^T (MODE_DKV)
  int n, heads;
  int qs, vs;         // 64-column slabs of the q/k and v contractions
  int tiles;          // 64-token tiles of N padded to 128
  int bh0;            // the group's first (batch, head) pair
  float scale, scale_log2;
};

struct GradParams {
  const uint4* ws;    // the rows' operand (dS, dS^T or P^T), fragment tiles
  __nv_bfloat16* out;
  long long out_batch, out_row;
  int n, heads, width, tiles, bh0;
};

// one arrival a warp, after the warp's wgmma.wait_group covered its reads
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// [fences] An accumulator's registers pinned at this point of the program:
// no ordinary instruction that reads or writes them moves across it, so
// ptxas finds none inside the wgmma pipeline (else it serializes it).
template <int N>
__device__ __forceinline__ void pin(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(a[i])::"memory");
}

// One 1-D bulk copy of `bytes` (a multiple of 16) into shared memory,
// counted on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival a consumer warp
    }
    // [fences] the initialised barriers visible to the async proxy (TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
}

// [ring] acc = sum over the ring's slabs [c0, c1) (counted from 0 across
// the whole list) of A (this warpgroup's 64 rows) B^T (the 128 tokens),
// four m64n128k16 SS steps a slab; each slab's group drained and the slab
// released before the next ([fences]: no group in flight past the loop's
// runtime branch)
__device__ __forceinline__ void contract(float (&acc)[64], uint32_t data, uint32_t full,
                                         uint32_t empty, int wg, int c0, int c1) {
  pin(acc);
  wgmma_fence();
  for (int c = c0; c < c1; ++c) {
    const int st = c % SCORE_STAGES;
    mbar_wait(full + 8 * st, (c / SCORE_STAGES) & 1);
    const uint32_t a = data + st * SCORE_STAGE + wg * HALF_BYTES;
    const uint32_t b = data + st * SCORE_STAGE + TILE * 128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n128(acc, desc_sw128(a + kk * 32, 16, 1024), desc_sw128(b + kk * 32, 16, 1024),
                    !(c == c0 && kk == 0));
    wgmma_commit();
    wgmma_wait<0>();
    release(empty + 8 * st);
  }
  pin(acc);
}

// A 64 x 128 fp32 accumulator (the m64n128 layout: element 4i + 2h + e is
// row r0 + 8h, column 8i + 2 * (lane % 4) + e) in bf16 as wgmma's A
// fragments of two 64-token tiles: tile `tile0 + h` gets columns 64h..64h+63,
// k16 step kk's four registers at [kk][thread] (16 bytes)
__device__ __forceinline__ void write_frags(uint4* ws, long long tile0, const float (&x)[64]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4* dst = ws + (tile0 + h) * (HALF_BYTES / 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* y = x + 32 * h + 8 * kk;
      dst[kk * 128 + t] = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                                     pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
    }
  }
}

// ---------------------------------------------------------------------------
// S and dP, P and dS into the workspace
// ---------------------------------------------------------------------------

// Grid (tiles / 2, tiles / 2, group): blockIdx.x the 128-token tile,
// blockIdx.y the 128-row tile, blockIdx.z the pair within the group. The
// maps: ta1 / tb1 the rows' and the tokens' operands of the first
// contraction (MODE_DQ: Q, K; MODE_DKV: K, Q), ta2 / tb2 of the second
// (dO, V; V, dO), each with 128-row boxes. Shared memory from a
// 1024-aligned base: barriers | ring (stages of the rows' slab, then the
// tokens').
template <int MODE>
__global__ void __launch_bounds__(THREADS_SM90, 1)
    wide_scores_kernel(const __grid_constant__ CUtensorMap ta1,
                       const __grid_constant__ CUtensorMap tb1,
                       const __grid_constant__ CUtensorMap ta2,
                       const __grid_constant__ CUtensorMap tb2, const ScoreParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t full = base, empty = base + 8 * MAX_STAGES;
  const uint32_t data = base + BARRIER_BYTES;
  const int ct = blockIdx.x, rt = blockIdx.y;
  const int bh = p.bh0 + blockIdx.z;
  const int b = bh / p.heads, head = bh % p.heads;
  const int nslabs = p.qs + p.vs;
  // warp-uniform as far as the compiler can tell (a broadcast): ptxas would
  // serialize the wgmma of a path it takes for divergent
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  init_ring(full, empty, SCORE_STAGES);

  // One if/else for the whole kernel: the roles never reconverge, so ptxas
  // honours setmaxnreg.
  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      for (int c = 0; c < nslabs; ++c) {
        const int st = c % SCORE_STAGES;
        mbar_wait(empty + 8 * st, ((c / SCORE_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, SCORE_STAGE);
        const uint32_t dst = data + st * SCORE_STAGE;
        const bool first = c < p.qs;
        const int col = (first ? c : c - p.qs) * SLAB;
        // [ragged N] [columns] rows and tokens past N, and columns past the
        // width, land zero-filled
        tma_load(dst, first ? &ta1 : &ta2, full + 8 * st, col, head, rt * TILE, b);
        tma_load(dst + TILE * 128, first ? &tb1 : &tb2, full + 8 * st, col, head, ct * TILE, b);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<240>();
    const int lane = threadIdx.x & 31;
    const int r0 = (threadIdx.x & 127) / 32 * 16 + (lane >> 2);
    const int row0 = rt * TILE + wg * 64 + r0;  // this thread's rows row0, row0 + 8
    const int col0 = ct * TILE + 2 * (lane & 3);
    const float* lse_g = p.lse + static_cast<long long>(bh) * p.n;
    const float* d_g = p.dcap + static_cast<long long>(bh) * p.n;

    float s[64], dp[64];
    contract(s, data, full, empty, wg, 0, p.qs);
    contract(dp, data, full, empty, wg, p.qs, nslabs);

#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int row = row0 + 8 * ((j >> 1) & 1);
      const int col = col0 + 8 * (j >> 2) + (j & 1);
      // [ragged N] a zero-filled row or token scores 0: its P is set to 0,
      // and lse and D are never read past N
      const bool valid = row < p.n && col < p.n;
      const int stat = MODE == MODE_DQ ? row : col;  // the query
      const float l = valid ? lse_g[stat] * LOG2E : 0.f;
      const float d = valid ? d_g[stat] : 0.f;
      const float pv = valid ? fast_exp2(s[j] * p.scale_log2 - l) : 0.f;
      s[j] = pv;
      dp[j] = pv * (dp[j] - d) * p.scale;
    }
    const long long tile0 =
        ((static_cast<long long>(blockIdx.z) * p.tiles + 2 * rt + wg) * p.tiles) + 2 * ct;
    write_frags(p.ws_ds, tile0, dp);
    if (MODE == MODE_DKV) write_frags(p.ws_p, tile0, s);
  }
}

// ---------------------------------------------------------------------------
// the gradient products: out = X Y over all tokens
// ---------------------------------------------------------------------------

// Grid (ceil(width / 256), tiles / 2, group): blockIdx.x the 256 output
// columns, blockIdx.y the 128 output rows. X the workspace's fragment tiles
// of those rows, Y (ty, 64-row boxes) the token rows of K, Q or dO. Shared
// memory from a 1024-aligned base: barriers | ring (stages of the two row
// tiles' fragments, 16 KB, then Y's four 64 x 64 boxes, 32 KB).
__global__ void __launch_bounds__(THREADS_SM90, 1)
    wide_grad_kernel(const __grid_constant__ CUtensorMap ty, const GradParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t full = base, empty = base + 8 * MAX_STAGES;
  const uint32_t data = base + BARRIER_BYTES;
  const int cb = blockIdx.x, rb = blockIdx.y;
  const int bh = p.bh0 + blockIdx.z;
  const int b = bh / p.heads, head = bh % p.heads;
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  // the fragment tiles of this block's row tiles 2rb, 2rb + 1, token tile 0
  const uint4* x0 = p.ws + (static_cast<long long>(blockIdx.z) * p.tiles + 2 * rb) * p.tiles *
                               (HALF_BYTES / 16);
  init_ring(full, empty, GRAD_STAGES);

  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      for (int t = 0; t < p.tiles; ++t) {
        const int st = t % GRAD_STAGES;
        mbar_wait(empty + 8 * st, ((t / GRAD_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, GRAD_STAGE);
        const uint32_t dst = data + st * GRAD_STAGE;
        for (int w = 0; w < 2; ++w)
          bulk_load(dst + w * HALF_BYTES,
                    x0 + (static_cast<long long>(w) * p.tiles + t) * (HALF_BYTES / 16),
                    HALF_BYTES, full + 8 * st);
        // [ragged N] [columns] tokens past N and columns past the width
        // land zero-filled
        for (int c = 0; c < GCOLS / SLAB; ++c)
          tma_load(dst + (2 + c) * HALF_BYTES, &ty, full + 8 * st, cb * GCOLS + c * SLAB, head,
                   t * TOK, b);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<240>();
    const int lane = threadIdx.x & 31;
    const int t128 = threadIdx.x & 127;
    float acc[GCOLS / 2];
#pragma unroll
    for (int i = 0; i < GCOLS / 2; ++i) acc[i] = 0.f;

    for (int t = 0; t < p.tiles; ++t) {
      const int st = t % GRAD_STAGES;
      mbar_wait(full + 8 * st, (t / GRAD_STAGES) & 1);
      const uint32_t stage = data + st * GRAD_STAGE;
      uint32_t xa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 v = lds128(stage + wg * HALF_BYTES + (kk * 128 + t128) * 16);
        xa[kk][0] = v.x;
        xa[kk][1] = v.y;
        xa[kk][2] = v.z;
        xa[kk][3] = v.w;
      }
      pin(acc);
      wgmma_fence();  // [fences] xa was written by ordinary instructions
      const uint32_t y = stage + 2 * HALF_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n256(acc, xa[kk], desc_sw128(y + kk * 16 * 128, HALF_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      release(empty + 8 * st);
    }

    // [ragged N] [columns] rows past N and columns past the width not stored
    const int r0 = t128 / 32 * 16 + (lane >> 2);
    const int row0 = rb * TILE + wg * 64 + r0;
    __nv_bfloat16* out = p.out + static_cast<long long>(b) * p.out_batch +
                         static_cast<long long>(head) * p.width;
#pragma unroll
    for (int a = 0; a < GCOLS / SLAB; ++a)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = cb * GCOLS + a * SLAB + 8 * i + 2 * (lane & 3);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < p.n && col < p.width)
            *reinterpret_cast<__nv_bfloat162*>(out + row * p.out_row + col) =
                __floats2bfloat162_rn(acc[32 * a + 4 * i + 2 * r], acc[32 * a + 4 * i + 2 * r + 1]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// per call, not cached: the attribute belongs to the current device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

int tiles_of(int n) { return (n + TILE - 1) / TILE * (TILE / TOK); }

// (batch, head) pairs a group: the most whose workspace (`mats` matrices of
// tiles^2 fragment tiles a pair) stays within WORKSPACE_LIMIT, at least
// one, then balanced over the groups that takes
int group_of(int pairs, int tiles, int mats) {
  const long long pair_bytes = static_cast<long long>(mats) * tiles * tiles * HALF_BYTES;
  long long most = WORKSPACE_LIMIT / pair_bytes;
  if (most < 1) most = 1;
  if (most > pairs) most = pairs;
  const int groups = static_cast<int>((pairs + most - 1) / most);
  return (pairs + groups - 1) / groups;
}

}  // namespace

extern "C" {

// Indices of a launch plan, ops/attention_vjp.py::bwd_wide_sm90_plan.
enum {
  PLAN_TILE, PLAN_TOK, PLAN_SLAB, PLAN_GCOLS, PLAN_STAGES, PLAN_GRAD_STAGES, PLAN_GROUP,
  PLAN_SMEM, PLAN_GRAD_SMEM, PLAN_LEN
};

// The plan both entry points share, recomputed here: 128-row score tiles,
// 64-token workspace tiles, 64-column slabs, 256 gradient columns a GEMM
// block, the most ring stages (up to 8) that fit each kernel's shared
// memory, the group of (batch, head) pairs of group_of, and the two
// kernels' shared memory.
static bool plan_ok(const int* plan, int pairs, int n, int mats) {
  return plan[PLAN_TILE] == TILE && plan[PLAN_TOK] == TOK && plan[PLAN_SLAB] == SLAB &&
         plan[PLAN_GCOLS] == GCOLS && plan[PLAN_STAGES] == SCORE_STAGES &&
         plan[PLAN_GRAD_STAGES] == GRAD_STAGES &&
         plan[PLAN_GROUP] == group_of(pairs, tiles_of(n), mats) &&
         plan[PLAN_SMEM] == SCORE_SMEM && plan[PLAN_GRAD_SMEM] == GRAD_SMEM &&
         SCORE_SMEM <= SMEM_LIMIT && GRAD_SMEM <= SMEM_LIMIT;
}

static bool shape_ok(int batch, int n, int heads, int dqk, int dv) {
  return batch >= 1 && n >= 1 && heads >= 1 && dqk > 0 && dv > 0 && dqk % 8 == 0 && dv % 8 == 0;
}

// The 4-D map of a (B, N, heads * width) view (strides in elements) with
// `rows`-row boxes of 64 columns.
static bool map_of(CUtensorMap* m, const void* t, int width, int heads, int n, int batch,
                   const long long* stride, int rows) {
  return make_map(m, t, width, heads, n, batch, stride[1], stride[0], rows);
}

// One group's score kernel of `mode`, maps already made.
static cudaError_t scores(int mode, const CUtensorMap (&m)[4], const ScoreParams& sp, int group,
                          cudaStream_t s) {
  const auto kernel = mode == MODE_DQ ? wide_scores_kernel<MODE_DQ> : wide_scores_kernel<MODE_DKV>;
  const cudaError_t err = allow_smem(kernel, SCORE_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sp.tiles / 2, sp.tiles / 2, group), THREADS_SM90, SCORE_SMEM, s>>>(
      m[0], m[1], m[2], m[3], sp);
  return cudaGetLastError();
}

// One group's gradient product out = X Y, Y's map made.
static cudaError_t grad(const CUtensorMap& ty, const GradParams& gp, int group, cudaStream_t s) {
  const cudaError_t err = allow_smem(wide_grad_kernel, GRAD_SMEM);
  if (err != cudaSuccess) return err;
  wide_grad_kernel<<<dim3((gp.width + GCOLS - 1) / GCOLS, gp.tiles / 2, group), THREADS_SM90,
                      GRAD_SMEM, s>>>(ty, gp);
  return cudaGetLastError();
}

// dq of the bf16 flash backward of `heads` heads of q/k width dqk and v
// width dv (packed heads or one): q, k, v, dO by pointer, their (batch,
// row) strides in elements in `strides` (8 values, 16-byte aligned rows),
// lse and dcap (B, heads, N) fp32 contiguous, dq written through its batch
// and row strides (a column view of a packed dqkv is fine). `ws` is the
// workspace: plan[PLAN_GROUP] pairs of tiles^2 fragment tiles of 8 KB.
// `plan` (PLAN_LEN ints) must be the one this library computes; anything
// else returns cudaErrorInvalidValue, as does a failed tensor-map encode.
// Returns the cudaError_t of the first launch that fails.
int flash_bwd_dq_wide_sm90(const void* q, const void* k, const void* v, const void* dO,
                           const float* lse, const float* dcap, void* dq, void* ws, int batch,
                           int n, int heads, int dqk, int dv, const long long* strides,
                           long long dq_batch, long long dq_row, float scale, const int* plan,
                           void* stream) {
  if (!shape_ok(batch, n, heads, dqk, dv) || !plan_ok(plan, batch * heads, n, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4], ty;
  if (!map_of(&m[0], q, dqk, heads, n, batch, strides + 0, TILE) ||
      !map_of(&m[1], k, dqk, heads, n, batch, strides + 2, TILE) ||
      !map_of(&m[2], dO, dv, heads, n, batch, strides + 6, TILE) ||
      !map_of(&m[3], v, dv, heads, n, batch, strides + 4, TILE) ||
      !map_of(&ty, k, dqk, heads, n, batch, strides + 2, TOK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ScoreParams sp = {};
  sp.lse = lse;
  sp.dcap = dcap;
  sp.ws_ds = static_cast<uint4*>(ws);
  sp.n = n;
  sp.heads = heads;
  sp.qs = (dqk + SLAB - 1) / SLAB;
  sp.vs = (dv + SLAB - 1) / SLAB;
  sp.tiles = tiles_of(n);
  sp.scale = scale;
  sp.scale_log2 = scale * LOG2E;
  GradParams gp = {};
  gp.ws = static_cast<const uint4*>(ws);
  gp.out = static_cast<__nv_bfloat16*>(dq);
  gp.out_batch = dq_batch;
  gp.out_row = dq_row;
  gp.n = n;
  gp.heads = heads;
  gp.width = dqk;
  gp.tiles = sp.tiles;
  const int pairs = batch * heads, group = plan[PLAN_GROUP];
  for (int bh0 = 0; bh0 < pairs; bh0 += group) {
    const int g = pairs - bh0 < group ? pairs - bh0 : group;
    sp.bh0 = gp.bh0 = bh0;
    cudaError_t err = scores(MODE_DQ, m, sp, g, s);
    if (err == cudaSuccess) err = grad(ty, gp, g, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// dk and dv of the same backward, written through their strides: per group
// the score kernel (P^T and dS^T: the workspace holds two matrices, P^T's
// first), then dk = dS^T Q and dv = P^T dO. Arguments and plan as
// flash_bwd_dq_wide_sm90.
int flash_bwd_dkv_wide_sm90(const void* q, const void* k, const void* v, const void* dO,
                            const float* lse, const float* dcap, void* dk, void* dv_out,
                            void* ws, int batch, int n, int heads, int dqk, int dv,
                            const long long* strides, long long dk_batch, long long dk_row,
                            long long dv_batch, long long dv_row, float scale, const int* plan,
                            void* stream) {
  if (!shape_ok(batch, n, heads, dqk, dv) || !plan_ok(plan, batch * heads, n, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4], tq, tdo;
  if (!map_of(&m[0], k, dqk, heads, n, batch, strides + 2, TILE) ||
      !map_of(&m[1], q, dqk, heads, n, batch, strides + 0, TILE) ||
      !map_of(&m[2], v, dv, heads, n, batch, strides + 4, TILE) ||
      !map_of(&m[3], dO, dv, heads, n, batch, strides + 6, TILE) ||
      !map_of(&tq, q, dqk, heads, n, batch, strides + 0, TOK) ||
      !map_of(&tdo, dO, dv, heads, n, batch, strides + 6, TOK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(n), group = plan[PLAN_GROUP];
  uint4* ws_p = static_cast<uint4*>(ws);
  uint4* ws_ds = ws_p + static_cast<long long>(group) * tiles * tiles * (HALF_BYTES / 16);
  ScoreParams sp = {};
  sp.lse = lse;
  sp.dcap = dcap;
  sp.ws_p = ws_p;
  sp.ws_ds = ws_ds;
  sp.n = n;
  sp.heads = heads;
  sp.qs = (dqk + SLAB - 1) / SLAB;
  sp.vs = (dv + SLAB - 1) / SLAB;
  sp.tiles = tiles;
  sp.scale = scale;
  sp.scale_log2 = scale * LOG2E;
  GradParams gk = {}, gv = {};
  gk.ws = ws_ds;
  gk.out = static_cast<__nv_bfloat16*>(dk);
  gk.out_batch = dk_batch;
  gk.out_row = dk_row;
  gk.width = dqk;
  gv.ws = ws_p;
  gv.out = static_cast<__nv_bfloat16*>(dv_out);
  gv.out_batch = dv_batch;
  gv.out_row = dv_row;
  gv.width = dv;
  gk.n = gv.n = n;
  gk.heads = gv.heads = heads;
  gk.tiles = gv.tiles = tiles;
  const int pairs = batch * heads;
  for (int bh0 = 0; bh0 < pairs; bh0 += group) {
    const int g = pairs - bh0 < group ? pairs - bh0 : group;
    sp.bh0 = gk.bh0 = gv.bh0 = bh0;
    cudaError_t err = scores(MODE_DKV, m, sp, g, s);
    if (err == cudaSuccess) err = grad(tq, gk, g, s);
    if (err == cudaSuccess) err = grad(tdo, gv, g, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
