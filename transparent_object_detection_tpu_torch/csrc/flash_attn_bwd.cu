// Flash-attention backward with mma.sync (the template), bf16 only: fp32
// accumulation, P and dS recomputed from q, k and the forward's logsumexp.
// Replaces the two TPU kernels of
// transparent_object_detection_tpu/ops/attention_vjp.py (flash_bwd) over the
// part of their bf16 domain that no Hopper kernel takes
// (ops/attention_vjp.py::bwd_form): dark3 of phi 'l' and 'x' (one head, q/k
// 256 and 512, v 2,048 and 4,096), packed heads of 448 and wider (phi 'l'
// and 'x': 768 to 3,584), and other widths no route reaches (packed heads
// of unequal widths or widths that are not multiples of 64, one head whose
// v is narrower than q/k); any q/k and v head widths that are multiples of
// 8, any N. csrc/flash_bwd_sm90.cu takes packed heads of 128 to 384,
// csrc/flash_bwd_single_sm90.cu one head at dark3 of phi 'n' to 'm' and the
// folded heads, csrc/flash_bwd_f32_sm90.cu every fp32 call.
//
//   * _bwd_dq_kernel:  dq = sum_k dS K          (one block per query block)
//   * _bwd_dkv_kernel: dk = sum_q dS^T Q,  dv = sum_q P^T dO
//                                               (blocks per key block)
// with, per score tile,
//   S  = Q K^T                  (fp32 accumulation)
//   P  = exp(S * scale - lse)   (computed as exp2(S * scale * log2 e - lse * log2 e))
//   dP = dO V^T
//   dS = P * (dP - D) * scale,  D = rowsum(dO * O) (computed in PyTorch)
// and P and dS cast to the input type before their products, as the Pallas
// kernels cast them (attention_vjp.py:187-189, 216-223). Both forms of the
// JAX launcher: packed multi-head (q/k/v and dq/dk/dv as column views of
// packed (B, N, 3C) arrays, head h at column h * dh) and single-head with
// q/k width != v width (the dark3 SelfAttention).
//
// Bound. The backward does 2*N^2*(4*dq + 3*dv) operations per image and
// head (the count attention.py logs for the Pallas backward) on inputs of
// tens of MB, so it is bound by the tensor cores (989 TFLOP/s bf16; dark3
// at phi='l' 640x640: 0.59 ms an image).
//
// Design. Three modes, each a launch; a block owns 64 "rows" (4 warps x 16)
// and walks the other axis in tiles of 32 inside the block, so nothing is
// reduced across blocks: there are no atomics, and the gradient has the
// same bits from run to run.
//   MODE_DQ: rows are queries (q, dO), columns keys (k, v); lse and D per
//            row; acc += dS K.
//   MODE_DK: rows are keys (k, v), columns queries (q, dO); S^T = K Q^T and
//            dP^T = V dO^T on the same mma tiles, lse and D per column;
//            acc += dS^T Q.
//   MODE_DV: rows are keys (k), columns queries (q, dO); acc += P^T dO.
// The fp32 accumulator of 16 rows x W columns takes W/2 registers a thread,
// so a block accumulates at most 256 output columns; the dkv kernel of the
// TPU is two launches here (dk needs dP, dv only P).
//   * flash_bwd_wide_kernel takes every width: a column tile is a
//     sequence of steps on one 3-stage cp.async ring of 128-column slabs:
//     S accumulates over ceil(dq / 128) slabs of q and k, dP over ceil(dv /
//     128) slabs of dO and v, then the output product streams its operand
//     (K, Q or dO) in slabs too. The block's rows stay in shared memory
//     where its blocks an SM still fit, else they stream with the columns.
//     An output up to 256 columns wide is one pass of 4 warps; a wider one
//     (dq, dk; dv when q/k is 768 or wider) takes passes of 512 columns
//     with 8 warps, two column halves that split each score tile and trade
//     its P or dS through shared memory; each pass recomputes S and dP (the
//     registers hold one pass), the last one masked. Extra operations
//     against the Pallas count: (passes - 1) * 2*N^2*(dq + dv) for dq and
//     for dk, (passes - 1) * 2*N^2*dq for dv, and 2*N^2*dq for the dv
//     launch's own S: at phi='l' dark3 (q/k 256, v 2,048: dv in eight
//     passes of 256) 1.29x the Pallas count.
// P and dS go from the fp32 accumulator layout straight into the bf16 A
// operand (registers, as P in the forward). Ragged N is masked: columns
// past N get P = 0, rows past N are computed on zeros and not stored.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BR = 64;  // rows per block (4 warps x 16)
constexpr int BC = 32;  // columns per inner tile
constexpr int MODE_DQ = 0, MODE_DK = 1, MODE_DV = 2;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dO;
  const float* lse;   // (B, heads, N)
  const float* dcap;  // (B, heads, N)
  __nv_bfloat16* out;  // dq, dk or dv
  long long q_batch, k_batch, v_batch, do_batch, out_batch;  // elements between batch items
  int q_row, k_row, v_row, do_row, out_row;                  // elements between rows
  int qk_head, v_head;  // column step between heads: q/k/dq/dk, and v/dO/dv
  int n;
  int d1, d2;           // q/k and v widths of one head
  int splits;           // output passes of the wide kernel
  float scale, scale_log2;
};

// ---------------------------------------------------------------------------
// q/k, v and the output's operand streamed in SL-column slabs through one
// ring; 4 warps a block for outputs up to 256 columns, 8 (two column
// halves) for wider ones, in passes of at most 512 columns
// ---------------------------------------------------------------------------
constexpr int SL = 128;              // columns of one streamed slab
constexpr int STAGES = 3;            // slabs in flight
constexpr int XT = BC + PAD;         // row stride of the X (P or dS) tile
constexpr int SM_SMEM = 233472;      // shared memory of one SM (228 KB)
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a block may use

// ROWS x cols bf16 tile into shared memory (row stride ld), columns [0,
// cols_valid) of rows [0, rows_valid) read, the rest zero-filled; cols and
// cols_valid multiples of 8. All NT threads of the block take part.
template <int ROWS, int NT>
__device__ __forceinline__ void load_block(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                           int stride, int cols, int rows_valid,
                                           int cols_valid) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < ROWS * chunks; i += NT) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    const bool valid = r < rows_valid && c < cols_valid;
    cp_async16(dst + r * ld + c, src + (valid ? (long long)r * stride + c : 0), valid);
  }
}

// acc (this warp's 16 rows x 16 * NG columns) += A (16 x SL at a_s) B^T
// (b_s: the warp's columns, SL wide, row stride SL + PAD)
template <int NG>
__device__ __forceinline__ void slab_product(float (&acc)[2 * NG][4], const __nv_bfloat16* a_s,
                                             const __nv_bfloat16* b_s) {
#pragma unroll
  for (int kk = 0; kk < SL / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_s + kk * 16);
#pragma unroll
    for (int nn = 0; nn < NG; ++nn) {
      uint32_t bf[4];
      ldsm_x4(bf, b_s + nn * 16 * (SL + PAD) + kk * 16);
      mma_16816(acc[2 * nn], a, bf[0], bf[1]);
      mma_16816(acc[2 * nn + 1], a, bf[2], bf[3]);
    }
  }
}

// The three modes for any widths d1 (q/k) and d2 (v) that are multiples of
// 8. A block owns 64 rows and an OW-wide pass of
// the output, columns o0 .. o0 + OW (the last pass masked), with 4 * WC
// warps: warp w takes rows (w % 4) * 16 and column half w / 4 (WC = 2) or
// all columns (WC = 1). A column tile of 32 is a sequence of steps on one
// STAGES-deep cp.async ring of SL-column slabs: S = R1 C1^T over s1 =
// ceil(d1 / SL) slabs and dP = R2 C2^T over s2 = ceil(d2 / SL), each warp
// its 16 x 32 / WC part of the 64 x 32 tile; X = P (dv) or dS (dq, dk)
// becomes the bf16 A operand, straight from the accumulators (WC = 1) or
// through shared memory, so that both halves read their 16 rows in full
// (WC = 2); then acc += X Y over the OW / SL slabs of Y, the column tile's
// slice of K (dq), Q (dk) or dO (dv), each column half accumulating its
// half of every slab (16 x OW / WC a warp: OW / (2 WC) registers). With
// RRES the block's rows of R1 and R2 stay in shared memory; otherwise each
// S and dP step brings its row slab too.
template <int MODE, int OW, int WC, bool RRES>
__global__ void __launch_bounds__(THREADS * WC) flash_bwd_wide_kernel(const BwdParams p) {
  constexpr bool WITH_DP = MODE != MODE_DV;
  constexpr int NT = THREADS * WC;
  constexpr int ST = SL + PAD;
  constexpr int RT = BR * ST, CT = BC * ST;
  constexpr int NY = OW / SL;       // Y slabs a pass
  constexpr int HSL = SL / WC;      // a warp's columns of a Y slab
  constexpr int NG = BC / WC / 16;  // a warp's 16-column groups of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d1 = p.d1, d2 = p.d2;
  const int s1 = (d1 + SL - 1) / SL;
  const int s2 = WITH_DP ? (d2 + SL - 1) / SL : 0;
  const int ns = s1 + s2 + NY;  // steps per column tile
  const int ld1 = s1 * SL + PAD, ld2 = (d2 + SL - 1) / SL * SL + PAD;  // resident row strides
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BR x XT (WC = 2)
  __nv_bfloat16* sR = sX + (WC == 2 ? BR * XT : 0);
  __nv_bfloat16* sC = sR + (RRES ? BR * ld1 + (WITH_DP ? BR * ld2 : 0) : STAGES * RT);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp & 3, wc = warp >> 2;  // row group, column half
  const int r0 = blockIdx.x * BR;
  const int head = blockIdx.y / p.splits;
  const int o0 = (blockIdx.y % p.splits) * OW;  // first output column of this pass
  const int b = blockIdx.z;
  const int n = p.n;

  const __nv_bfloat16* qg = p.q + b * p.q_batch + head * p.qk_head;
  const __nv_bfloat16* kg = p.k + b * p.k_batch + head * p.qk_head;
  const __nv_bfloat16* vg = p.v + b * p.v_batch + head * p.v_head;
  const __nv_bfloat16* dog = p.dO + b * p.do_batch + head * p.v_head;
  const long long stat = ((long long)b * (gridDim.y / p.splits) + head) * n;
  const float* lse_g = p.lse + stat;
  const float* d_g = p.dcap + stat;

  const __nv_bfloat16* r1 = MODE == MODE_DQ ? qg : kg;
  const int r1_row = MODE == MODE_DQ ? p.q_row : p.k_row;
  const __nv_bfloat16* r2 = MODE == MODE_DQ ? dog : vg;
  const int r2_row = MODE == MODE_DQ ? p.do_row : p.v_row;
  const __nv_bfloat16* c1 = MODE == MODE_DQ ? kg : qg;
  const int c1_row = MODE == MODE_DQ ? p.k_row : p.q_row;
  const __nv_bfloat16* c2 = MODE == MODE_DQ ? vg : dog;
  const int c2_row = MODE == MODE_DQ ? p.v_row : p.do_row;
  const __nv_bfloat16* yg = MODE == MODE_DQ ? kg : MODE == MODE_DK ? qg : dog;
  const int y_row = MODE == MODE_DQ ? p.k_row : MODE == MODE_DK ? p.q_row : p.do_row;
  const int wout = MODE == MODE_DV ? d2 : d1;
  __nv_bfloat16* og = p.out + b * p.out_batch +
                      (MODE == MODE_DV ? head * p.v_head : head * p.qk_head) + o0;

  const int n_tiles = (n + BC - 1) / BC;
  const int total = n_tiles * ns;
  // step g of column tile g / ns: slab j = g % ns of S (j < s1), of dP
  // (j < s1 + s2) or of Y, into ring stage g % STAGES
  auto load_step = [&](int g) {
    if (g >= total) return;
    const int t = g / ns, j = g % ns, st = g % STAGES;
    const long long row0 = (long long)t * BC;
    if (j >= s1 + s2) {
      const int y0 = o0 + (j - s1 - s2) * SL;
      load_block<BC, NT>(sC + st * CT, ST, yg + row0 * y_row + y0, y_row, SL, n - t * BC,
                         wout - y0);
      return;
    }
    const bool second = j >= s1;
    const int c0 = (second ? j - s1 : j) * SL;
    const int w = second ? d2 : d1;
    if (!RRES) {
      const __nv_bfloat16* src = second ? r2 : r1;
      const int row = second ? r2_row : r1_row;
      load_block<BR, NT>(sR + st * RT, ST, src + (long long)r0 * row + c0, row, SL, n - r0,
                         w - c0);
    }
    const __nv_bfloat16* src = second ? c2 : c1;
    const int row = second ? c2_row : c1_row;
    load_block<BC, NT>(sC + st * CT, ST, src + row0 * row + c0, row, SL, n - t * BC, w - c0);
  };

  if (RRES) {
    load_block<BR, NT>(sR, ld1, r1 + (long long)r0 * r1_row, r1_row, ld1 - PAD, n - r0, d1);
    if (WITH_DP)
      load_block<BR, NT>(sR + BR * ld1, ld2, r2 + (long long)r0 * r2_row, r2_row, ld2 - PAD,
                         n - r0, d2);
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    load_step(i);
    cp_async_commit();
  }
  int g = 0;
  // wait for step g's slabs; the stage step g - 1 read takes step g + STAGES - 1
  auto advance = [&]() {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_step(g + STAGES - 1);
    cp_async_commit();
  };

  // this thread's rows of the score tile: lane / 4 and lane / 4 + 8 of the
  // warp's 16; its columns 2 * (lane % 4) + {0, 1} of each 8-column group
  const int row0 = r0 + wr * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};
  if constexpr (MODE == MODE_DQ) {
    if (row0 < n) lse_r[0] = lse_g[row0] * LOG2E, d_r[0] = d_g[row0];
    if (row1 < n) lse_r[1] = lse_g[row1] * LOG2E, d_r[1] = d_g[row1];
  }

  float acc[NY * HSL / 8][4];
#pragma unroll
  for (int i = 0; i < NY * HSL / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int a_row = wr * 16 + (lane & 15);  // A operand ([m][k] tile)
  const int a_off = (lane >> 4) * 8;
  // the warp's columns of a C slab, as the B operand ([n][k] tile)
  const int b_off = (wc * (BC / WC) + (lane & 7) + ((lane >> 4) << 3)) * ST + ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);  // transposed B ([k][n] tile)
  const int t_col = (lane >> 4) * 8;
  __nv_bfloat16* x_w = sX + (wr * 16 + (lane >> 2)) * XT + wc * (BC / WC) + 2 * (lane & 3);

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BC;
    float s[2 * NG][4], dp[2 * NG][4];
#pragma unroll
    for (int i = 0; i < 2 * NG; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    for (int j = 0; j < s1; ++j, ++g) {
      advance();
      const int st = g % STAGES;
      const __nv_bfloat16* a_s = RRES ? sR + a_row * ld1 + j * SL : sR + st * RT + a_row * ST;
      slab_product<NG>(s, a_s + a_off, sC + st * CT + b_off);
    }
    if constexpr (WITH_DP) {
      for (int j = 0; j < s2; ++j, ++g) {
        advance();
        const int st = g % STAGES;
        const __nv_bfloat16* a_s = RRES ? sR + BR * ld1 + a_row * ld2 + j * SL
                                        : sR + st * RT + a_row * ST;
        slab_product<NG>(dp, a_s + a_off, sC + st * CT + b_off);
      }
    }

    // P, then dS = P * (dP - D) * scale; columns past N get P = 0; X in
    // bf16 (WC = 2: to shared memory, read after the next step's barrier)
    uint32_t xa[BC / 16][4];
#pragma unroll
    for (int i = 0; i < 2 * NG; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + wc * (BC / WC) + i * 8 + 2 * (lane & 3) + (e & 1);
        float l2, dd = 0.f;
        if constexpr (MODE == MODE_DQ) {
          l2 = lse_r[e >> 1];
          dd = d_r[e >> 1];
        } else {
          l2 = col < n ? lse_g[col] * LOG2E : 0.f;
          if constexpr (WITH_DP) dd = col < n ? d_g[col] : 0.f;
        }
        const float pe = col < n ? fast_exp2(s[i][e] * p.scale_log2 - l2) : 0.f;
        if constexpr (WITH_DP) {
          s[i][e] = pe * (dp[i][e] - dd) * p.scale;
        } else {
          s[i][e] = pe;
        }
      }
      if constexpr (WC == 2) {
        *reinterpret_cast<uint32_t*>(x_w + i * 8) = pack_bf16(s[i][0], s[i][1]);
        *reinterpret_cast<uint32_t*>(x_w + 8 * XT + i * 8) = pack_bf16(s[i][2], s[i][3]);
      }
    }
    if constexpr (WC == 1) {
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        xa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        xa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        xa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        xa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
    }

    // acc[:, this warp's part of slab ys] += X Y_ys, contracted over the BC columns
#pragma unroll
    for (int ys = 0; ys < NY; ++ys, ++g) {
      advance();
      if (WC == 2 && ys == 0) {
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk) ldsm_x4(xa[kk], sX + a_row * XT + a_off + kk * 16);
      }
      if (o0 + ys * SL + wc * HSL >= wout) continue;  // a masked part of the last pass
      const __nv_bfloat16* y_s = sC + (g % STAGES) * CT + wc * HSL;
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
        for (int dn = 0; dn < HSL / 16; ++dn) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, y_s + (kk * 16 + t_row) * ST + dn * 16 + t_col);
          mma_16816(acc[ys * (HSL / 8) + 2 * dn], xa[kk], bf[0], bf[1]);
          mma_16816(acc[ys * (HSL / 8) + 2 * dn + 1], xa[kk], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < NY * HSL / 8; ++i) {
    const int col = (i / (HSL / 8)) * SL + wc * HSL + (i % (HSL / 8)) * 8 + 2 * (lane & 3);
    if (o0 + col >= wout) continue;  // widths are multiples of 8: the pair is whole
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row0 * p.out_row + col) =
          __floats2bfloat162_rn(acc[i][0], acc[i][1]);
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row1 * p.out_row + col) =
          __floats2bfloat162_rn(acc[i][2], acc[i][3]);
    }
  }
}

template <int MODE, int OW, int WC, bool RRES>
cudaError_t launch_wide(const BwdParams& p, int batch, int heads, int smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_wide_kernel<MODE, OW, WC, RRES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n + BR - 1) / BR, heads * p.splits, batch);
  flash_bwd_wide_kernel<MODE, OW, WC, RRES><<<grid, THREADS * WC, smem, stream>>>(p);
  return cudaGetLastError();
}

// The rows stay resident where the blocks an SM still fit (the registers
// allow two 4-warp blocks, or one 8-warp block), else they stream with the
// columns.
template <int MODE, int OW, int WC>
cudaError_t launch_pass(BwdParams& p, int batch, int heads, cudaStream_t stream) {
  p.splits = ((MODE == MODE_DV ? p.d2 : p.d1) + OW - 1) / OW;
  const int d1s = (p.d1 + SL - 1) / SL * SL, d2s = (p.d2 + SL - 1) / SL * SL;
  const int fixed = ((WC == 2 ? BR * XT : 0) + STAGES * BC * (SL + PAD)) * 2;
  const int resident =
      (BR * (d1s + PAD) + (MODE != MODE_DV ? BR * (d2s + PAD) : 0)) * 2 + fixed;
  const bool rres = WC == 1 ? 2 * (resident + 1024) <= SM_SMEM : resident <= MAX_SMEM;
  if (rres) return launch_wide<MODE, OW, WC, true>(p, batch, heads, resident, stream);
  return launch_wide<MODE, OW, WC, false>(p, batch, heads, STAGES * BR * (SL + PAD) * 2 + fixed,
                                          stream);
}

// Outputs up to 256 columns wide: one pass of 4 warps (two blocks an SM).
// Wider dq and dk: passes of 512 columns, 8 warps in two column halves
// sharing each score tile (one block an SM), half the passes and so half
// the recomputed S and dP. The dv pass recomputes only S (over q/k), so
// fewer passes pay for the larger block only where q/k is wide: 8 warps
// from a q/k width of 768, else 4-warp passes of 256. (A sweep of both
// forms over the training sites of phi n/m/l/x on an H100 set these
// thresholds: one 8-warp block an SM loses to two 4-warp blocks wherever
// the pass count does not drop.)
template <int MODE>
cudaError_t run_wide(BwdParams& p, int batch, int heads, cudaStream_t stream) {
  const int wout = MODE == MODE_DV ? p.d2 : p.d1;
  if (wout <= 128) return launch_pass<MODE, 128, 1>(p, batch, heads, stream);
  if (wout <= 256 || (MODE == MODE_DV && p.d1 < 768))
    return launch_pass<MODE, 256, 1>(p, batch, heads, stream);
  return launch_pass<MODE, 512, 2>(p, batch, heads, stream);
}


}  // namespace

extern "C" {

// One gradient of the flash backward. mode 0: dq, 1: dk, 2: dv, written to
// `out` (B, N, heads * width) through its batch and row strides (a column
// view of a packed dqkv array is fine). q, k (heads * dqk wide), v, dO
// (heads * dv wide) bf16 by pointer and strides; dqk and dv multiples of 8;
// lse and dcap (B, heads, N) fp32, contiguous. Returns the cudaError_t of
// the launch.
int flash_bwd(int mode, const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* dcap, void* out, int batch, int n, int heads,
              int dqk, int dv, long long q_batch, int q_row, long long k_batch, int k_row,
              long long v_batch, int v_row, long long do_batch, int do_row,
              long long out_batch, int out_row, float scale, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0 || dqk <= 0 || dv <= 0 || dqk % 8 || dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dO = static_cast<const __nv_bfloat16*>(dO);
  p.lse = lse;
  p.dcap = dcap;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.q_batch = q_batch;
  p.k_batch = k_batch;
  p.v_batch = v_batch;
  p.do_batch = do_batch;
  p.out_batch = out_batch;
  p.q_row = q_row;
  p.k_row = k_row;
  p.v_row = v_row;
  p.do_row = do_row;
  p.out_row = out_row;
  p.qk_head = dqk;
  p.v_head = dv;
  p.d1 = dqk;
  p.d2 = dv;
  p.n = n;
  p.splits = 1;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_DQ: return static_cast<int>(run_wide<MODE_DQ>(p, batch, heads, s));
    case MODE_DK: return static_cast<int>(run_wide<MODE_DK>(p, batch, heads, s));
    case MODE_DV: return static_cast<int>(run_wide<MODE_DV>(p, batch, heads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
