// Flash-attention backward for Hopper (sm_90a): bf16 operands, fp32
// accumulation, P and dS recomputed from q, k and the forward's logsumexp.
// Replaces the two TPU kernels of
// transparent_object_detection_tpu/ops/attention_vjp.py (flash_bwd):
//
//   * _bwd_dq_kernel:  dq = sum_k dS K          (one block per query block)
//   * _bwd_dkv_kernel: dk = sum_q dS^T Q,  dv = sum_q P^T dO
//                                               (blocks per key block)
// with, per score tile,
//   S  = Q K^T                  (fp32 accumulation)
//   P  = exp(S * scale - lse)   (computed as exp2(S * scale * log2 e - lse * log2 e))
//   dP = dO V^T
//   dS = P * (dP - D) * scale,  D = rowsum(dO * O) (computed in PyTorch)
// and P and dS cast to bf16 before their products, as the Pallas kernels
// cast them (attention_vjp.py:187-189, 216-223). Both forms of the JAX
// launcher: packed multi-head (q/k/v and dq/dk/dv as column views of packed
// (B, N, 3C) arrays, head h at column h * dh) and single-head with q/k width
// != v width (the dark3 SelfAttention, dq 64, dv 512).
//
// Bound. At phi='s' 640x640 the backward does 2*N^2*(4*dq + 3*dv) operations
// per image (the count attention.py logs for the Pallas backward): 1.155e12
// over the four sites, on inputs of a few tens of MB, so it is bound by the
// tensor cores (~1.17 ms an image at 989 TFLOP/s bf16; derived, not
// measured).
//
// Design. One templated kernel computes all three gradients. A block owns 64
// "rows" (4 warps x 16) and walks the other axis in tiles of 32 inside the
// block, so nothing is reduced across blocks: there are no atomics, and the
// gradient has the same bits from run to run.
//   MODE_DQ: rows are queries (q, dO in shared memory), columns keys (k, v
//            tiles); lse and D per row; acc += dS K.
//   MODE_DK: rows are keys (k, v), columns queries (q, dO tiles); S^T = K Q^T
//            and dP^T = V dO^T on the same mma tiles, lse and D per column;
//            acc += dS^T Q.
//   MODE_DV: rows are keys (k), columns queries (q, and a 256-wide slice of
//            dO); acc += P^T dO.
// The fp32 accumulator of 16 rows x W columns takes W/2 registers a thread;
// W = 256 is the widest that fits beside the score tiles (the forward's
// limit too). dk and dv together would be 512 wide, so the dkv kernel of the
// TPU is two launches here: the dk pass (needs dP, contracts over all of dv)
// and the dv pass (needs only P; dark3's 512-wide dv in two 256-wide slices,
// each recomputing S over dq = 64). That recomputes S once more per key
// block: 2*N^2*dq more operations (+14% on the neck's dh = 256, +4% on
// dark3). Shared memory a block: 101 KB (packed dq/dk), 114 KB (dark3
// dq/dk), 66 KB and 30 KB (dv), so up to two blocks an SM. P and dS go from the fp32
// accumulator layout straight into the bf16 A operand (registers, as P in
// the forward); the column tile that the last product does not read is
// refetched with cp.async while it runs. Ragged N is masked: columns past N
// get P = 0, rows past N are computed on zeros and not stored.
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
  int n, dv_splits;     // dv_splits: DVT-wide slices of dv (MODE_DV), else 1
  float scale, scale_log2;
};

// D1: q/k width per head; D2: v width per head.
template <int MODE, int D1, int D2>
__global__ void __launch_bounds__(THREADS) flash_bwd_kernel(const BwdParams p) {
  constexpr bool WITH_DP = MODE != MODE_DV;
  constexpr int DW = MODE == MODE_DV ? DVT : D1;  // accumulated output width
  constexpr int DC2 = MODE == MODE_DV ? DVT : D2;  // width of the second column tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sR1 = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BR x D1
  __nv_bfloat16* sR2 = sR1 + BR * (D1 + PAD);                        // BR x D2 (dq, dk)
  __nv_bfloat16* sC1 = sR2 + (WITH_DP ? BR * (D2 + PAD) : 0);        // BC x D1
  __nv_bfloat16* sC2 = sC1 + BC * (D1 + PAD);                        // BC x DC2

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * BR;
  const int head = blockIdx.y / p.dv_splits;
  const int split = blockIdx.y % p.dv_splits;
  const int b = blockIdx.z;
  const int n = p.n;

  const __nv_bfloat16* qg = p.q + b * p.q_batch + head * p.qk_head;
  const __nv_bfloat16* kg = p.k + b * p.k_batch + head * p.qk_head;
  const __nv_bfloat16* vg = p.v + b * p.v_batch + head * p.v_head;
  const __nv_bfloat16* dog = p.dO + b * p.do_batch + head * p.v_head + split * DVT;
  const long long stat = ((long long)b * (gridDim.y / p.dv_splits) + head) * n;
  const float* lse_g = p.lse + stat;
  const float* d_g = p.dcap + stat;

  // row operands (R1, R2) and column operands (C1, C2) of this mode
  const __nv_bfloat16* r1 = MODE == MODE_DQ ? qg : kg;
  const int r1_row = MODE == MODE_DQ ? p.q_row : p.k_row;
  const __nv_bfloat16* r2 = MODE == MODE_DQ ? dog : vg;
  const int r2_row = MODE == MODE_DQ ? p.do_row : p.v_row;
  const __nv_bfloat16* c1 = MODE == MODE_DQ ? kg : qg;
  const int c1_row = MODE == MODE_DQ ? p.k_row : p.q_row;
  const __nv_bfloat16* c2 = MODE == MODE_DQ ? vg : dog;
  const int c2_row = MODE == MODE_DQ ? p.v_row : p.do_row;
  __nv_bfloat16* og = p.out + b * p.out_batch +
                      (MODE == MODE_DV ? head * p.v_head + split * DVT : head * p.qk_head);

  const int n_tiles = (n + BC - 1) / BC;
  load_tile<BR, D1>(sR1, r1 + (long long)r0 * r1_row, r1_row, n - r0);
  if constexpr (WITH_DP) load_tile<BR, D2>(sR2, r2 + (long long)r0 * r2_row, r2_row, n - r0);
  load_tile<BC, D1>(sC1, c1, c1_row, n);
  cp_async_commit();
  load_tile<BC, DC2>(sC2, c2, c2_row, n);
  cp_async_commit();

  // per-row statistics (dq: rows are queries); thread rows lane/4 and lane/4 + 8
  const int row0 = r0 + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};
  if constexpr (MODE == MODE_DQ) {
    if (row0 < n) lse_r[0] = lse_g[row0] * LOG2E, d_r[0] = d_g[row0];
    if (row1 < n) lse_r[1] = lse_g[row1] * LOG2E, d_r[1] = d_g[row1];
  }

  float acc[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);     // non-transposed B ([n][k] tile)
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);  // transposed B ([k][n] tile)
  const int t_col = (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BC;
    cp_async_wait<0>();
    __syncthreads();

    // S = R1 C1^T: this warp's 16 rows x BC columns
    float s[BC / 8][4];
#pragma unroll
    for (int i = 0; i < BC / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D1 / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sR1 + a_row * (D1 + PAD) + a_col + kk * 16);
#pragma unroll
      for (int nn = 0; nn < BC / 16; ++nn) {
        uint32_t bf[4];
        ldsm_x4(bf, sC1 + (nn * 16 + b_row) * (D1 + PAD) + kk * 16 + b_col);
        mma_16816(s[2 * nn], a, bf[0], bf[1]);
        mma_16816(s[2 * nn + 1], a, bf[2], bf[3]);
      }
    }

    // dP = R2 C2^T (dq: dO V^T; dk: V dO^T)
    float dp[BC / 8][4];
    if constexpr (WITH_DP) {
#pragma unroll
      for (int i = 0; i < BC / 8; ++i) dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D2 / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, sR2 + a_row * (D2 + PAD) + a_col + kk * 16);
#pragma unroll
        for (int nn = 0; nn < BC / 16; ++nn) {
          uint32_t bf[4];
          ldsm_x4(bf, sC2 + (nn * 16 + b_row) * (D2 + PAD) + kk * 16 + b_col);
          mma_16816(dp[2 * nn], a, bf[0], bf[1]);
          mma_16816(dp[2 * nn + 1], a, bf[2], bf[3]);
        }
      }
    }

    // the column tile the product below does not read is refetched now
    __syncthreads();
    if (t + 1 < n_tiles) {
      if constexpr (WITH_DP) {
        load_tile<BC, DC2>(sC2, c2 + (long long)(c0 + BC) * c2_row, c2_row, n - c0 - BC);
      } else {
        load_tile<BC, D1>(sC1, c1 + (long long)(c0 + BC) * c1_row, c1_row, n - c0 - BC);
      }
      cp_async_commit();
    }

    // P, then dS = P * (dP - D) * scale; columns past N get P = 0
#pragma unroll
    for (int i = 0; i < BC / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + i * 8 + 2 * (lane & 3) + (e & 1);
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
    }

    // acc += X Y with X = dS (dq, dk) or P (dv) in bf16, Y = C1 (dq: K,
    // dk: Q) or the dO slice C2 (dv), contracted over the BC columns
    const __nv_bfloat16* sY = MODE == MODE_DV ? sC2 : sC1;
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DW / 16; ++dn) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, sY + (kk * 16 + t_row) * (DW + PAD) + dn * 16 + t_col);
        mma_16816(acc[2 * dn], a, bf[0], bf[1]);
        mma_16816(acc[2 * dn + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with sY
    if (t + 1 < n_tiles) {
      if constexpr (WITH_DP) {
        load_tile<BC, D1>(sC1, c1 + (long long)(c0 + BC) * c1_row, c1_row, n - c0 - BC);
      } else {
        load_tile<BC, DC2>(sC2, c2 + (long long)(c0 + BC) * c2_row, c2_row, n - c0 - BC);
      }
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < DW / 8; ++i) {
    const int col = i * 8 + 2 * (lane & 3);
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

template <int MODE, int D1, int D2>
cudaError_t launch(const BwdParams& p, int batch, int heads, cudaStream_t stream) {
  constexpr int DC2 = MODE == MODE_DV ? DVT : D2;
  constexpr int smem = (BR * (D1 + PAD) + (MODE != MODE_DV ? BR * (D2 + PAD) : 0) +
                        BC * (D1 + PAD) + BC * (DC2 + PAD)) * 2;
  // per call, not cached: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<MODE, D1, D2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n + BR - 1) / BR, heads * p.dv_splits, batch);
  flash_bwd_kernel<MODE, D1, D2><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// the (q/k, v) head widths of the phi='s' training path: neck heads (256,
// 256), dark3 (64, 512); any other pair is refused
template <int MODE>
cudaError_t run(const BwdParams& p, int dqk, int dv, int batch, int heads, cudaStream_t stream) {
  if (dqk == 256 && dv == 256) return launch<MODE, 256, 256>(p, batch, heads, stream);
  if (dqk == 64 && dv == 512) return launch<MODE, 64, 512>(p, batch, heads, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One gradient of the flash backward. mode 0: dq, 1: dk, 2: dv, written to
// `out` (B, N, heads * width) through its batch and row strides (a column
// view of a packed dqkv array is fine). q, k (heads * dqk wide), v, dO
// (heads * dv wide) by pointer and strides; lse and dcap (B, heads, N) fp32,
// contiguous. Returns the cudaError_t of the launch.
int flash_bwd(int mode, const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* dcap, void* out, int batch, int n, int heads,
              int dqk, int dv, long long q_batch, int q_row, long long k_batch, int k_row,
              long long v_batch, int v_row, long long do_batch, int do_row,
              long long out_batch, int out_row, float scale, void* stream) {
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
  p.n = n;
  p.dv_splits = mode == MODE_DV ? dv / DVT : 1;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dv % DVT != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case MODE_DQ: return static_cast<int>(run<MODE_DQ>(p, dqk, dv, batch, heads, s));
    case MODE_DK: return static_cast<int>(run<MODE_DK>(p, dqk, dv, batch, heads, s));
    case MODE_DV: return static_cast<int>(run<MODE_DV>(p, dqk, dv, batch, heads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
