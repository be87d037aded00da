// Flash-attention forward for Hopper (sm_90a): bf16 operands, fp32 softmax
// state, exp2-domain online softmax. One templated kernel serves three ports:
//
//   * flash_mha_packed: replaces the TPU kernel
//     transparent_object_detection_tpu/ops/attention.py::_mha_flash_kernel
//     as launched by flash_attention_mha_packed. q/k/v are read in place out
//     of ONE packed (B, N, 3C) qkv array: head h of q at column h*dh, of k at
//     C + h*dh, of v at 2C + h*dh, row stride 3C. The output is the
//     head-packed (B, N, C) array, head h at column h*dh. No split copies.
//   * flash_single: replaces
//     transparent_object_detection_tpu/ops/attention.py::_flash_kernel
//     (flash_attention_pallas): one head, q/k width dq != v width dv (the
//     dark3 SelfAttention: dq = C/8 = 64, dv = C = 512, scale 1.0).
//   * flash_fwd_lse (training): replaces
//     transparent_object_detection_tpu/ops/attention_vjp.py::_fwd_lse_kernel
//     (flash_fwd_lse), both its packed multi-head and its single-head form:
//     the same kernel with one more output, the per-(batch, head, query)
//     logsumexp in the natural-log domain, lse = (m + log2 l) * ln 2 from the
//     exp2-domain state, which the backward (flash_attn_bwd.cu) recomputes
//     P from. q/k/v are given by pointer and strides, so the packed form
//     reads them as column views of the qkv projection output.
//
// Both compute, per query row i, out_i = sum_j p_ij v_j / sum_j p_ij with
//   s_ij = (q_i . k_j) * scale * log2(e)   (fp32 accumulation)
//   m    = running row max, starting at -1e30 (not -inf: no inf - inf NaN)
//   p_ij = exp2(s_ij - m), cast to bf16 before the P.V product
//   l, acc in fp32, output acc * (1 / l) in bf16
// which is the arithmetic of the Pallas kernels.
//
// Bound. At phi='s' 640x640, per image, the four launches of the serving
// forward do 2*N^2*(Cq + Cv) operations: h2 (N=6400, C=1536) ~251.7 GFLOP,
// dark3 (N=6400, 64 + 512) ~47.2, h1 (N=1600, C=2048) ~21.0, h4 (N=1600,
// C=1536) ~15.7. Their inputs and outputs are a few tens of MB, so they are
// bound by the tensor cores, not by memory: at the H100 SXM data sheet's
// 989 TFLOP/s bf16 the four take at least ~0.34 ms per image (derived, not
// measured).
//
// Design against that bound. The N x N score matrix never leaves the SM: a
// block owns 64 query rows (16 per warp, 4 warps), keeps its q tile in shared
// memory and walks the keys in tiles of 64 inside the block (blocks share
// nothing, so the sequential kv grid axis of the TPU kernel becomes this
// loop). Both products run on the tensor cores through mma.sync m16n8k16
// bf16 with fp32 accumulation; P stays in registers between the two products
// (the S accumulator layout is the A operand layout). The fp32 accumulator
// of a 64 x dv tile does not fit in registers for dv = 512, so the v width is
// split into DVT = 256-wide column slices (128 accumulator registers a
// thread, the widest slice that compiles without spills) across blocks and
// q.k^T is recomputed per slice; for dark3 that is 2 slices, extra q.k^T work
// of a factor (2*64 + 512)/(64 + 512), and the first thing a later wgmma/TMA
// version removes. Instantiated for the q/k widths the phi='s' serving path
// gives it, 64 (dark3) and 256 (neck heads); any other width is refused. The next k tile
// is fetched with cp.async while P.V of the current tile runs. Ragged N is
// masked: keys past N score -inf, query rows past N are computed on zeros
// and not stored.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BM = 64;      // query rows per block
constexpr int BN = 64;      // keys per kv tile

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;                                    // (B, heads, N) or null (serving)
  long long q_batch, k_batch, v_batch, o_batch;  // elements between batch items
  int q_row, k_row, v_row, o_row;                // elements between rows
  int q_col, k_col, v_col;                       // column of head 0
  int dq_head, dv_head;                          // column step between heads
  int n;
  int dv_splits;                                 // DVT-wide slices per head
  float scale_log2;                              // scale * log2(e)
};

template <int DQ>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * (DQ + PAD);
  __nv_bfloat16* sV = sK + BN * (DQ + PAD);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM;
  const int head = blockIdx.y / p.dv_splits;
  const int split = blockIdx.y % p.dv_splits;
  const int b = blockIdx.z;

  const __nv_bfloat16* qg = p.q + b * p.q_batch + p.q_col + head * p.dq_head;
  const __nv_bfloat16* kg = p.k + b * p.k_batch + p.k_col + head * p.dq_head;
  const __nv_bfloat16* vg =
      p.v + b * p.v_batch + p.v_col + head * p.dv_head + split * DVT;
  __nv_bfloat16* og = p.o + b * p.o_batch + head * p.dv_head + split * DVT;

  const int n = p.n;
  const int n_tiles = (n + BN - 1) / BN;

  // prologue: q with the first k tile in one group, the first v tile in the next
  load_tile<BM, DQ>(sQ, qg + (long long)m0 * p.q_row, p.q_row, n - m0);
  load_tile<BN, DQ>(sK, kg, p.k_row, n);
  cp_async_commit();
  load_tile<BN, DVT>(sV, vg, p.v_row, n);
  cp_async_commit();

  float acc[DVT / 8][4];
#pragma unroll
  for (int i = 0; i < DVT / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

  const __nv_bfloat16* q_frag_base = sQ + (warp * 16 + (lane & 15)) * (DQ + PAD) + (lane >> 4) * 8;
  const int k_frag_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_frag_col = ((lane >> 3) & 1) * 8;
  const int v_frag_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_frag_col = (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BN;
    cp_async_wait<1>();  // q and k tile t have landed
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_frag_base + kk * 16);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t bf[4];
        ldsm_x4(bf, sK + (nn * 16 + k_frag_row) * (DQ + PAD) + kk * 16 + k_frag_col);
        mma_16816(s[2 * nn], a, bf[0], bf[1]);
        mma_16816(s[2 * nn + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with sK
    if (t + 1 < n_tiles) {
      load_tile<BN, DQ>(sK, kg + (long long)(n0 + BN) * p.k_row, p.k_row, n - n0 - BN);
      cp_async_commit();
    }

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

    if (t + 1 < n_tiles) {
      cp_async_wait<1>();  // v tile t has landed (k tile t+1 may be in flight)
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
      load_tile<BN, DVT>(sV, vg + (long long)(n0 + BN) * p.v_row, p.v_row, n - n0 - BN);
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

template <int DQ>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  constexpr int smem = ((BM + BN) * (DQ + PAD) + BN * (DVT + PAD)) * 2;
  // per call, not cached: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n + BM - 1) / BM, heads * p.dv_splits, batch);
  flash_fwd_kernel<DQ><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// v widths must be a multiple of DVT
cudaError_t run(const Params& p, int dq, int dv, int batch, int heads, cudaStream_t stream) {
  if (dv % DVT != 0) return cudaErrorInvalidValue;
  switch (dq) {
    case 64: return launch<64>(p, batch, heads, stream);
    case 256: return launch<256>(p, batch, heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Packed multi-head forward: qkv (B, N, 3C) bf16 -> out (B, N, C) bf16,
// C = heads * dh. Returns the cudaError_t of the launch.
int flash_mha_packed(const void* qkv, void* out, int batch, int n, int heads, int dh,
                     float scale, void* stream) {
  const int c = heads * dh;
  Params p;
  p.q = p.k = p.v = static_cast<const __nv_bfloat16*>(qkv);
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = nullptr;
  p.q_batch = p.k_batch = p.v_batch = (long long)n * 3 * c;
  p.o_batch = (long long)n * c;
  p.q_row = p.k_row = p.v_row = 3 * c;
  p.o_row = c;
  p.q_col = 0;
  p.k_col = c;
  p.v_col = 2 * c;
  p.dq_head = p.dv_head = dh;
  p.n = n;
  p.dv_splits = dh / DVT;
  p.scale_log2 = scale * LOG2E;
  return static_cast<int>(run(p, dh, dh, batch, heads, static_cast<cudaStream_t>(stream)));
}

// Single-head forward: q, k (B, N, dq), v (B, N, dv) bf16 -> out (B, N, dv).
int flash_single(const void* q, const void* k, const void* v, void* out, int batch, int n,
                 int dq, int dv, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = nullptr;
  p.q_batch = p.k_batch = (long long)n * dq;
  p.v_batch = p.o_batch = (long long)n * dv;
  p.q_row = p.k_row = dq;
  p.v_row = p.o_row = dv;
  p.q_col = p.k_col = p.v_col = 0;
  p.dq_head = p.dv_head = 0;
  p.n = n;
  p.dv_splits = dv / DVT;
  p.scale_log2 = scale * LOG2E;
  return static_cast<int>(run(p, dq, dv, batch, 1, static_cast<cudaStream_t>(stream)));
}

// Forward with logsumexp (training): q, k (B, N, heads * dqk) and v
// (B, N, heads * dv) given by pointer, batch stride and row stride (so q/k/v
// may be column views of one packed qkv array; head h at column h * dqk or
// h * dv) -> out (B, N, heads * dv) bf16, lse (B, heads, N) fp32.
int flash_fwd_lse(const void* q, const void* k, const void* v, void* out, float* lse,
                  int batch, int n, int heads, int dqk, int dv, long long q_batch, int q_row,
                  long long k_batch, int k_row, long long v_batch, int v_row, float scale,
                  void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(out);
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
  p.n = n;
  p.dv_splits = dv / DVT;
  p.scale_log2 = scale * LOG2E;
  return static_cast<int>(run(p, dqk, dv, batch, heads, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
