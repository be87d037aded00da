// Flash-attention forward for Hopper (sm_90a): exp2-domain online softmax
// with fp32 softmax state, in bf16 on the tensor cores or in fp32 on the CUDA
// cores. One kernel template per type serves three ports:
//
//   * flash_mha_packed: replaces the TPU kernel
//     transparent_object_detection_tpu/ops/attention.py::_mha_flash_kernel
//     as launched by flash_attention_mha_packed. q/k/v are read in place out
//     of ONE packed (B, N, 3C) qkv array: head h of q at column h*dh, of k at
//     C + h*dh, of v at 2C + h*dh, row stride 3C. The output is the
//     head-packed (B, N, C) array, head h at column h*dh. No split copies.
//   * flash_single: replaces
//     transparent_object_detection_tpu/ops/attention.py::_flash_kernel
//     (flash_attention_pallas): one head, q/k width dq, v width dv (the
//     dark3 SelfAttention: dq = C/8, dv = C, scale 1.0; and the multi-head
//     shapes whose heads are folded into the batch axis, such as phi='n'
//     h1's 3 x 283 and phi='m' h1's 8 x 599, zero-padded by the wrapper).
//   * flash_fwd_lse (training): replaces
//     transparent_object_detection_tpu/ops/attention_vjp.py::_fwd_lse_kernel
//     (flash_fwd_lse), both its packed multi-head and its single-head form,
//     at every width and in both types: the same kernels with one more output, the per-(batch, head, query)
//     logsumexp in the natural-log domain, lse = (m + log2 l) * ln 2 from the
//     exp2-domain state, which the backward (flash_attn_bwd.cu) recomputes
//     P from. q/k/v are given by pointer and strides, so the packed form
//     reads them as column views of the qkv projection output.
//
// All compute, per query row i, out_i = sum_j p_ij v_j / sum_j p_ij with
//   s_ij = (q_i . k_j) * scale * log2(e)   (fp32 accumulation)
//   m    = running row max, starting at -1e30 (not -inf: no inf - inf NaN)
//   p_ij = exp2(s_ij - m), cast to the input type before the P.V product
//   l, acc in fp32, output acc * (1 / l) in the input type
// which is the arithmetic of the Pallas kernels (on fp32 inputs p stays fp32).
//
// Bound. At phi='s' 640x640, per image, the four launches of the serving
// forward do 2*N^2*(Cq + Cv) operations: h2 (N=6400, C=1536) ~251.7 GFLOP,
// dark3 (N=6400, 64 + 512) ~47.2, h1 (N=1600, C=2048) ~21.0, h4 (N=1600,
// C=1536) ~15.7; at phi='m' the same sites do ~503, ~94.4, ~49 and ~31.5
// GFLOP. Inputs and outputs are a few tens of MB, so they are bound by the
// tensor cores, not by memory: at the H100 SXM data sheet's 989 TFLOP/s
// bf16 the phi='s' four take at least ~0.34 ms per image (derived, not
// measured). The fp32 form is bound by the 67 TFLOP/s of fp32 FMA.
//
// Design of the bf16 kernel. The N x N score matrix never leaves the SM: a
// block owns 64 query rows (16 per warp, 4 warps) and walks the keys in
// tiles of 64 inside the block (blocks share nothing, so the sequential kv
// grid axis of the TPU kernel becomes this loop). Both products run on the
// tensor cores through mma.sync m16n8k16 bf16 with fp32 accumulation; P
// stays in registers between the two products (the S accumulator layout is
// the A operand layout). The q/k width is a loop: up to 256 columns the q
// tile stays in shared memory and one k tile of that width is refilled
// while P.V runs (the phi='s' path: widths 64 and 256); wider heads stream q
// and k together in 128-column slabs through a 2-stage cp.async ring, S
// accumulating over the slabs in registers. Columns past dq (a multiple of
// 8) are zero-filled, which leaves q.k^T unchanged. The fp32 accumulator of
// a 64 x dv tile does not fit in registers for wide v, so v is split into
// DVT = 256-wide column slices (128 accumulator registers a thread) across
// blocks and q.k^T is recomputed per slice; the last slice is masked where
// dv is not a multiple of 256. Ragged N is masked: keys past N score -inf,
// query rows past N are computed on zeros and not stored.
//
// Design of the fp32 kernel (compute_dtype="float32" models): 32 query rows
// a block, keys in tiles of 32, q/k in 32-column slabs, v in 128-column
// slices, all in shared memory, each thread owning 8 scores and 32
// accumulator columns of one row; plain FFMA, no tensor cores, so that the
// products are fp32 as the Pallas kernel computes them on fp32 inputs.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BM = 64;      // query rows per block
constexpr int BN = 64;      // keys per kv tile
constexpr int SLAB = 128;   // q/k columns a streamed step holds

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                                    // (B, heads, N) or null (serving)
  long long q_batch, k_batch, v_batch, o_batch;  // elements between batch items
  int q_row, k_row, v_row, o_row;                // elements between rows
  int q_col, k_col, v_col;                       // column of head 0
  int dq_head, dv_head;                          // column step between heads
  int dq, dv;                                    // q/k and v widths of one head
  int n;
  int dv_splits;                                 // v column slices per head
  float scale_log2;                              // scale * log2(e)
};

// QRES: the whole q/k width (<= SL, zero-filled past dq) in one step per key
// tile, q loaded once, one k buffer. Otherwise q and k stream in SL-column
// slabs, ceil(dq / SL) steps per key tile, through a 2-stage ring.
template <int SL, bool QRES>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int QT = BM * (SL + PAD);
  constexpr int KT = BN * (SL + PAD);
  constexpr int STAGES = QRES ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + STAGES * QT;
  __nv_bfloat16* sV = sK + STAGES * KT;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM;
  const int head = blockIdx.y / p.dv_splits;
  const int split = blockIdx.y % p.dv_splits;
  const int b = blockIdx.z;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_batch +
                            p.q_col + head * p.dq_head;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_batch +
                            p.k_col + head * p.dq_head;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_batch +
                            p.v_col + head * p.dv_head + split * DVT;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_batch + head * p.dv_head + split * DVT;

  const int n = p.n;
  const int n_tiles = (n + BN - 1) / BN;
  const int slabs = QRES ? 1 : (p.dq + SL - 1) / SL;
  const int steps = n_tiles * slabs;
  const int v_cols = p.dv - split * DVT;  // valid columns of this v slice

  // step j: key tile j / slabs, columns from (j % slabs) * SL
  auto load_qk = [&](int j) {
    const int t = j / slabs, c0 = (j % slabs) * SL, st = QRES ? 0 : (j & 1);
    if (!QRES)
      load_tile_cols<BM, SL>(sQ + st * QT, qg + (long long)m0 * p.q_row + c0, p.q_row, n - m0,
                             p.dq - c0);
    load_tile_cols<BN, SL>(sK + st * KT, kg + (long long)t * BN * p.k_row + c0, p.k_row,
                           n - t * BN, p.dq - c0);
  };
  auto load_v = [&](int t) {
    load_tile_cols<BN, DVT>(sV, vg + (long long)t * BN * p.v_row, p.v_row, n - t * BN, v_cols);
  };

  // prologue: q (resident) with the first k step in one group, the first v
  // tile in the next
  if (QRES) load_tile_cols<BM, SL>(sQ, qg + (long long)m0 * p.q_row, p.q_row, n - m0, p.dq);
  load_qk(0);
  cp_async_commit();
  load_v(0);
  cp_async_commit();

  float acc[DVT / 8][4];
#pragma unroll
  for (int i = 0; i < DVT / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end
  float s[BN / 8][4];

  const int q_frag_off = (warp * 16 + (lane & 15)) * (SL + PAD) + (lane >> 4) * 8;
  const int k_frag_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_frag_col = ((lane >> 3) & 1) * 8;
  const int v_frag_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_frag_col = (lane >> 4) * 8;

  for (int j = 0; j < steps; ++j) {
    const int t = j / slabs, sl = j % slabs;
    const int n0 = t * BN;
    // the first step of a tile may leave its v tile in flight
    if (sl == 0) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!QRES && j + 1 < steps) {  // the other stage was read by step j - 1
      load_qk(j + 1);
      cp_async_commit();
    }

    // S += Q K^T over this step's columns, this warp's 16 rows x 64 keys
    if (sl == 0) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    }
    const __nv_bfloat16* q_s = sQ + (QRES ? 0 : (j & 1) * QT);
    const __nv_bfloat16* k_s = sK + (QRES ? 0 : (j & 1) * KT);
#pragma unroll
    for (int kk = 0; kk < SL / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_s + q_frag_off + kk * 16);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t bf[4];
        ldsm_x4(bf, k_s + (nn * 16 + k_frag_row) * (SL + PAD) + kk * 16 + k_frag_col);
        mma_16816(s[2 * nn], a, bf[0], bf[1]);
        mma_16816(s[2 * nn + 1], a, bf[2], bf[3]);
      }
    }
    if (QRES) {
      __syncthreads();  // every warp is done with sK
      if (j + 1 < steps) {
        load_qk(j + 1);
        cp_async_commit();
      }
    }
    if (sl != slabs - 1) continue;

    // online softmax in the exp2 domain; thread rows: lane/4 and lane/4 + 8
    const bool ragged = n0 + BN > n;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * p.scale_log2;
        if (ragged && n0 + i * 8 + 2 * (lane & 3) + (e & 1) >= n) x = -INFINITY;
        s[i][e] = x;
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
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = fast_exp2(s[i][e] - m_run[e >> 1]);
        s[i][e] = pe;
        l_run[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < DVT / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    if (j + 1 < steps) {
      cp_async_wait<1>();  // v tile t has landed (the next q/k step may be in flight)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // acc += P V; P (bf16) comes straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DVT / 16; ++dn) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, sV + (kk * 16 + v_frag_row) * (DVT + PAD) + dn * 16 + v_frag_col);
        mma_16816(acc[2 * dn], a, bf[0], bf[1]);
        mma_16816(acc[2 * dn + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with sV
    if (t + 1 < n_tiles) {
      load_v(t + 1);
      cp_async_commit();
    }
  }

  // out = acc / l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 2);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  const int row0 = m0 + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  // training: the natural-log logsumexp of the scaled scores,
  // ln(sum_j exp(s_ij * scale)) = (m + log2 l) * ln 2, once per row (every
  // v slice computes the same m and l)
  if (p.lse != nullptr && split == 0 && (lane & 3) == 0) {
    float* lse = p.lse + ((long long)b * (gridDim.y / p.dv_splits) + head) * n;
    if (row0 < n) lse[row0] = (m_run[0] + log2f(l_run[0])) * LN2;
    if (row1 < n) lse[row1] = (m_run[1] + log2f(l_run[1])) * LN2;
  }
#pragma unroll
  for (int i = 0; i < DVT / 8; ++i) {
    const int col = i * 8 + 2 * (lane & 3);
    if (col >= v_cols) continue;  // dv and col are even: the pair is whole
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row0 * p.o_row + col) =
          __floats2bfloat162_rn(acc[i][0] * inv0, acc[i][1] * inv0);
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row1 * p.o_row + col) =
          __floats2bfloat162_rn(acc[i][2] * inv1, acc[i][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 form: CUDA-core FFMA throughout
// ---------------------------------------------------------------------------
constexpr int FBM = 32;    // query rows per block
constexpr int FBN = 32;    // keys per tile
constexpr int FSL = 32;    // q/k columns per slab
constexpr int FDVT = 128;  // v columns per block

__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(const Params p) {
  __shared__ float sQ[FBM][FSL + 1];
  __shared__ float sK[FBN][FSL + 1];
  __shared__ float sP[FBM][FBN + 1];
  __shared__ float sV[FBN][FDVT];
  const int tid = threadIdx.x;
  const int r = tid >> 2, qd = tid & 3;  // row of the block; quarter of its keys / columns
  const int m0 = blockIdx.x * FBM;
  const int head = blockIdx.y / p.dv_splits;
  const int split = blockIdx.y % p.dv_splits;
  const int b = blockIdx.z;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_batch + p.q_col + head * p.dq_head;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_batch + p.k_col + head * p.dq_head;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_batch + p.v_col +
                    head * p.dv_head + split * FDVT;
  float* og = static_cast<float*>(p.o) + b * p.o_batch + head * p.dv_head + split * FDVT;
  const int n = p.n, dq = p.dq;
  const int v_cols = p.dv - split * FDVT;

  float m_run = -1e30f, l_run = 0.f;
  float acc[FDVT / 4];  // columns qd + 4 * c of the slice
#pragma unroll
  for (int c = 0; c < FDVT / 4; ++c) acc[c] = 0.f;

  for (int n0 = 0; n0 < n; n0 += FBN) {
    float s[FBN / 4];
#pragma unroll
    for (int jj = 0; jj < FBN / 4; ++jj) s[jj] = 0.f;
    for (int c0 = 0; c0 < dq; c0 += FSL) {
      __syncthreads();
      for (int i = tid; i < FBM * FSL; i += THREADS) {
        const int rr = i / FSL, cc = i % FSL;
        const bool col_ok = c0 + cc < dq;
        sQ[rr][cc] = (m0 + rr < n && col_ok) ? qg[(long long)(m0 + rr) * p.q_row + c0 + cc] : 0.f;
        sK[rr][cc] = (n0 + rr < n && col_ok) ? kg[(long long)(n0 + rr) * p.k_row + c0 + cc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < FSL; ++cc) {
        const float qv = sQ[r][cc];
#pragma unroll
        for (int jj = 0; jj < FBN / 4; ++jj) s[jj] = fmaf(qv, sK[qd * (FBN / 4) + jj][cc], s[jj]);
      }
    }
    // online softmax in the exp2 domain; a row's 32 scores lie in one quad
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < FBN / 4; ++jj) {
      float x = s[jj] * p.scale_log2;
      if (n0 + qd * (FBN / 4) + jj >= n) x = -INFINITY;
      s[jj] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffff, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffff, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    const float corr = exp2f(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < FBN / 4; ++jj) {
      const float pe = exp2f(s[jj] - m_new);
      sP[r][qd * (FBN / 4) + jj] = pe;
      psum += pe;
    }
    psum += __shfl_xor_sync(0xffffffff, psum, 1);
    psum += __shfl_xor_sync(0xffffffff, psum, 2);
    l_run = l_run * corr + psum;
    m_run = m_new;
    for (int i = tid; i < FBN * FDVT; i += THREADS) {
      const int rr = i / FDVT, cc = i % FDVT;
      sV[rr][cc] = (n0 + rr < n && cc < v_cols) ? vg[(long long)(n0 + rr) * p.v_row + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < FDVT / 4; ++c) acc[c] *= corr;
    for (int jj = 0; jj < FBN; ++jj) {
      const float pj = sP[r][jj];
#pragma unroll
      for (int c = 0; c < FDVT / 4; ++c) acc[c] = fmaf(pj, sV[jj][qd + 4 * c], acc[c]);
    }
  }
  if (m0 + r >= n) return;
  // training: lse = (m + log2 l) * ln 2, once per row, as the bf16 kernel
  if (p.lse != nullptr && split == 0 && qd == 0)
    p.lse[((long long)b * (gridDim.y / p.dv_splits) + head) * n + m0 + r] =
        (m_run + log2f(l_run)) * LN2;
  const float inv = 1.f / l_run;
#pragma unroll
  for (int c = 0; c < FDVT / 4; ++c) {
    const int col = qd + 4 * c;
    if (col < v_cols) og[(long long)(m0 + r) * p.o_row + col] = acc[c] * inv;
  }
}

template <int SL, bool QRES>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  constexpr int stages = QRES ? 1 : 2;
  constexpr int smem = (stages * (BM + BN) * (SL + PAD) + BN * (DVT + PAD)) * 2;
  // per call, not cached: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<SL, QRES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n + BM - 1) / BM, heads * p.dv_splits, batch);
  flash_fwd_kernel<SL, QRES><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// widths are multiples of 8 (16-byte rows); q/k widths up to 256 stay
// resident in shared memory, wider ones stream in SLAB-column slabs
cudaError_t run(Params& p, int batch, int heads, bool f32, cudaStream_t stream) {
  if (p.dq <= 0 || p.dv <= 0 || p.dq % 8 || p.dv % 8) return cudaErrorInvalidValue;
  if (f32) {
    p.dv_splits = (p.dv + FDVT - 1) / FDVT;
    dim3 grid((p.n + FBM - 1) / FBM, heads * p.dv_splits, batch);
    flash_fwd_f32_kernel<<<grid, THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
  p.dv_splits = (p.dv + DVT - 1) / DVT;
  if (p.dq <= 64) return launch<64, true>(p, batch, heads, stream);
  if (p.dq <= 128) return launch<128, true>(p, batch, heads, stream);
  if (p.dq <= 256) return launch<256, true>(p, batch, heads, stream);
  return launch<SLAB, false>(p, batch, heads, stream);
}

}  // namespace

extern "C" {

// Packed multi-head forward: qkv (B, N, 3C) -> out (B, N, C), C = heads * dh,
// bf16 (f32 = 0) or fp32 (f32 = 1). dh % 8 == 0. Returns the cudaError_t of
// the launch.
int flash_mha_packed(const void* qkv, void* out, int batch, int n, int heads, int dh,
                     float scale, int f32, void* stream) {
  const int c = heads * dh;
  Params p;
  p.q = p.k = p.v = qkv;
  p.o = out;
  p.lse = nullptr;
  p.q_batch = p.k_batch = p.v_batch = (long long)n * 3 * c;
  p.o_batch = (long long)n * c;
  p.q_row = p.k_row = p.v_row = 3 * c;
  p.o_row = c;
  p.q_col = 0;
  p.k_col = c;
  p.v_col = 2 * c;
  p.dq_head = p.dv_head = dh;
  p.dq = p.dv = dh;
  p.n = n;
  p.scale_log2 = scale * LOG2E;
  return static_cast<int>(run(p, batch, heads, f32 != 0, static_cast<cudaStream_t>(stream)));
}

// Single-head forward: q, k (B, N, dq), v (B, N, dv) -> out (B, N, dv), bf16
// or fp32. dq % 8 == 0, dv % 8 == 0.
int flash_single(const void* q, const void* k, const void* v, void* out, int batch, int n,
                 int dq, int dv, float scale, int f32, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = nullptr;
  p.q_batch = p.k_batch = (long long)n * dq;
  p.v_batch = p.o_batch = (long long)n * dv;
  p.q_row = p.k_row = dq;
  p.v_row = p.o_row = dv;
  p.q_col = p.k_col = p.v_col = 0;
  p.dq_head = p.dv_head = 0;
  p.dq = dq;
  p.dv = dv;
  p.n = n;
  p.scale_log2 = scale * LOG2E;
  return static_cast<int>(run(p, batch, 1, f32 != 0, static_cast<cudaStream_t>(stream)));
}

// Forward with logsumexp (training): q, k (B, N, heads * dqk) and v (B, N,
// heads * dv) given by pointer, batch stride and row stride (so q/k/v may be
// column views of one packed qkv array; head h at column h * dqk or h * dv)
// -> out (B, N, heads * dv) in the input type, lse (B, heads, N) fp32. bf16
// (f32 = 0) or fp32 (f32 = 1); dqk % 8 == 0, dv % 8 == 0.
int flash_fwd_lse(const void* q, const void* k, const void* v, void* out, float* lse,
                  int batch, int n, int heads, int dqk, int dv, long long q_batch, int q_row,
                  long long k_batch, int k_row, long long v_batch, int v_row, float scale,
                  int f32, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = lse;
  p.q_batch = q_batch;
  p.k_batch = k_batch;
  p.v_batch = v_batch;
  p.o_batch = (long long)n * heads * dv;
  p.q_row = q_row;
  p.k_row = k_row;
  p.v_row = v_row;
  p.o_row = heads * dv;
  p.q_col = p.k_col = p.v_col = 0;
  p.dq_head = dqk;
  p.dv_head = dv;
  p.dq = dqk;
  p.dv = dv;
  p.n = n;
  p.scale_log2 = scale * LOG2E;
  return static_cast<int>(run(p, batch, heads, f32 != 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
