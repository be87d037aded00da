// int8 flash attention for Hopper (sm_90a), the mma.sync template. Since the
// Hopper kernel of flash_int8_sm90.cu took every head whose q/k and v widths
// are multiples of 64 up to 512 (ops/attention_int8.py::int8_fwd_form), this
// source serves the other int8 sites: phi='n' dark3 (q/k 32), phi='m'
// dark3 (v 1,024) and every site of phi 'l' and 'x' (heads of 768 and
// wider, dark3 v 2,048 and 4,096). It replaces, there, three TPU kernels of
// transparent_object_detection_tpu/ops/attention_int8.py:
//   * _mha_flash_int8_kernel (flash_attention_mha_int8): entry flash_mha_int8,
//     the function below with an output in q's type (bf16 or fp32);
//   * _mha_flash_int8_qout_kernel (flash_attention_mha_int8_qout): entry
//     flash_mha_int8_qout, the same with the output quantized per (row, head);
//   * _mha_flash_int8_handoff_kernel (flash_attention_int8_handoff): entry
//     flash_int8_handoff, q int8 from the qkv projection's payload, used as it
//     is (no re-rounding) with its scale per (row, head) from a table, and the
//     output int8 or in bf16 / fp32.
//
// Inputs: q int8 with one scale per (row, head) (B, N, heads), head-packed
// with row stride q_row. flash_mha_int8 and flash_mha_int8_qout first
// quantize q from bf16 or fp32 (quant_q_kernel, flash_int8_common.cuh: per
// (row, head), amax over the head's dq columns floored at 1e-12, qq =
// rint(q * (127 / amax)), qs = amax / 127) into a workspace, then run the
// main kernel; the two launches count as one. kq (B, N, Cq) and vq (B, N, Cv)
// int8 with one f32 scale per (batch, head, block of bk keys), (B, H, N / bk).
// Per query row and head, with s_scale = scale * log2(e):
//   per key block j:
//     s = float(qq . kq) * (qs * (ks_j * s_scale))          (int32 dot, exact)
//     pass 1: m_new = max(m, max of s over the WHOLE block)  (m starts -1e30)
//     pass 2: p127 = exp2(s - (m_new - log2 127)); l = l * exp2(m - m_new)
//             + sum p127 (unrounded); pv = int32 sum over the block of
//             rint(p127) * vq; acc = acc * exp2(m - m_new) + float(pv) * vs_j
//   out = acc * (1 / l).
// int8 out: the kernel writes o in fp32 to a workspace and a row pass
// (quant_heads_kernel) takes each (row, head)'s amax over all its v columns
// (floor 1e-30), rint(o * (127 / amax)) and amax / 127 into column `head` of
// (B, N, heads): never per 256-column slice.
// p is rounded against the maximum of its whole quantization block, as the
// TPU kernel does (its key block is the whole quantization block). A
// textbook online softmax over 64-key tiles would round against a running
// maximum and keep weights below 1/254 of the row's peak that come before it:
// another function. So each block costs a second pass of the int8 q.k^T:
// +50% of the MMA work on the neck heads (dq = dv), +11% on dark3 (dq 64,
// dv 512).
//
// Bound. Operations: 2 * N^2 * (2 dq + dv) int8 operations a (batch, head)
// (both q.k^T passes and p.v) against inputs and outputs of tens of MB, so
// the work is bound by operations (the H100 SXM data sheet's 1,979 int8
// TOPS).
//
// Design. A block owns 64 query rows (16 per warp) of one head and one
// 256-wide slice of its v columns (wider v splits across blocks, which
// recompute q.k^T; the last slice is masked where dv is not a multiple of
// 256). Keys stream in tiles of 64 through a 2-stage cp.async ring, both
// passes and all blocks in one sequence of steps; a quantization block whose
// bk is not a multiple of 64 ends in a half tile, its missing keys masked
// (-inf in the max, p = 0). The q/k width is a loop: widths up to 64 and
// exactly 256 keep the int8 q tile in shared memory (phi='n' dark3 and
// phi='l' dark3); others stream q and k together in 128-byte slabs, S
// accumulating in registers. Both products are mma.sync m16n8k32 s8 x s8 ->
// s32. The s32 C fragment of that instruction holds 2 adjacent key columns
// of an 8-wide tile, the s8 A fragment wants 4, so rint(p127) goes through a
// small shared tile (one per warp's rows) and comes back with ldmatrix. The
// B operand of p.v needs keys contiguous per v column: each v tile is
// transposed in shared memory (4 x 4 byte blocks with byte permutes). pv
// stays int32 over a whole block (128 registers a thread); with more than
// one block the fp32 acc lives in shared memory, touched once per block (one
// block an SM); with one block it is formed from pv at the end (two blocks
// an SM). N and bk are multiples of 32, dq of 32, dv of 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_int8_common.cuh"

namespace {

using namespace int8attn;

constexpr int BM = 64;       // query rows per block
constexpr int BN = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr int DVT = 256;     // v columns one block accumulates
constexpr int PADB = 16;     // byte padding of a shared row (bank spread)
constexpr int SLAB = 128;    // q/k bytes a streamed step holds
struct Params {
  const int8_t* q8;         // int8 q, row stride q_row, head h at column h * dq
  const float* qs_tab;      // its per-(row, head) scales (B, N, heads)
  const int8_t* kq;
  const int8_t* vq;
  const float* ks;
  const float* vs;
  void* o;                  // (B, N, heads * dv): bf16 or fp32
  int n, heads, dq, dv, q_row, bk, nk, dv_splits;
  float scale_log2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte async copy; valid = false zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// ROWS x COLS bytes from global (row stride `stride`) into shared memory (row
// stride COLS + PADB), reading rows [0, rows_valid) and columns
// [0, cols_valid) (a multiple of 16); the rest is zero-filled.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_bytes(int8_t* dst, const int8_t* src, long long stride,
                                           int rows_valid, int cols_valid) {
  constexpr int CHUNKS = COLS / 16;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 16;
    const bool valid = r < rows_valid && col < cols_valid;
    cp_async16(dst + r * (COLS + PADB) + col, src + (valid ? r * stride + col : 0), valid);
  }
}

// QW: the q/k columns one step holds: the whole (padded) width when QRES, a
// slab of SLAB bytes otherwise (q then streams beside k, 2 stages).
template <int QW, bool QRES, bool MULTI>
struct Smem {
  static constexpr int QROW = QW + PADB;
  static constexpr int Q = (QRES ? 1 : 2) * BM * QROW;  // q tile, or 2 q slabs
  static constexpr int K = BN * QROW;                   // one k stage
  static constexpr int VRAW = BN * (DVT + PADB);        // v tile as loaded
  static constexpr int VT = DVT * (BN + PADB);          // v tile transposed
  static constexpr int P = BM * (BN + PADB);            // rint(p127)
  static constexpr int ACC = MULTI ? BM * DVT * 4 : 0;  // fp32 acc (nk > 1)
  static constexpr int QS = BM * 4;                     // q row scales
  static constexpr int TOTAL = Q + 2 * K + VRAW + VT + P + ACC + QS;
};

// Position of a step in the sequence: block, pass, key tile, q/k slab.
struct Step {
  int blk, pass, tile, slab;
};

// MULTI: more than one key block (nk > 1), the fp32 acc in shared memory.
// With one block (bk = N) acc is float(pv) * vs,
// formed at the end; the block then needs 95.5 KB of shared memory and two
// fit an SM. TAIL: bk is not a multiple of 64, so each block's last key tile
// is masked. OUT: bf16 or fp32 values.
template <int QW, bool QRES, bool MULTI, bool TAIL, int OUT>
__global__ void __launch_bounds__(THREADS, MULTI ? 1 : 2) flash_int8_kernel(const Params p) {
  using S = Smem<QW, QRES, MULTI>;
  constexpr int QROW = S::QROW;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem);
  int8_t* sK = sQ + S::Q;
  unsigned char* sVraw = reinterpret_cast<unsigned char*>(sK + 2 * S::K);
  unsigned char* sVt = sVraw + S::VRAW;
  int8_t* sP = reinterpret_cast<int8_t*>(sVt + S::VT);
  float* sAcc = reinterpret_cast<float*>(sP + S::P);
  float* sQs = reinterpret_cast<float*>(sP + S::P + S::ACC);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM;
  const int head = blockIdx.y / p.dv_splits, split = blockIdx.y % p.dv_splits;
  const int b = blockIdx.z;
  const int n = p.n;
  const int cq = p.heads * p.dq, cv = p.heads * p.dv;
  const int8_t* q8g = p.q8 + (long long)b * n * p.q_row + head * p.dq;
  const int8_t* kg = p.kq + (long long)b * n * cq + head * p.dq;
  const int8_t* vg = p.vq + (long long)b * n * cv + head * p.dv + split * DVT;
  const float* ksg = p.ks + ((long long)b * p.heads + head) * p.nk;
  const float* vsg = p.vs + ((long long)b * p.heads + head) * p.nk;
  const int v_cols = p.dv - split * DVT;  // valid columns of this v slice

  const int tiles = (p.bk + BN - 1) / BN;  // key tiles per quantization block
  const int slabs = QRES ? 1 : (p.dq + QW - 1) / QW;
  // steps in order: per block, pass 1 then pass 2, per key tile, per slab;
  // step s loads into and reads from ring stage s & 1
  auto advance = [&](Step c) {
    if (++c.slab == slabs) {
      c.slab = 0;
      if (++c.tile == tiles) {
        c.tile = 0;
        if (++c.pass == 2) {
          c.pass = 0;
          ++c.blk;
        }
      }
    }
    return c;
  };
  auto load = [&](const Step& c, int stage) {
    const int k0 = c.blk * p.bk + c.tile * BN;
    const int kv = TAIL ? min(BN, p.bk - c.tile * BN) : BN;
    const int c0 = QRES ? 0 : c.slab * QW;
    load_bytes<BN, QW>(sK + stage * S::K, kg + (long long)k0 * cq + c0, cq, kv, p.dq - c0);
    if (!QRES)
      load_bytes<BM, QW>(sQ + stage * BM * QROW, q8g + (long long)m0 * p.q_row + c0, p.q_row,
                         n - m0, p.dq - c0);
    if (c.pass == 1 && c.slab == 0)
      load_bytes<BN, DVT>(reinterpret_cast<int8_t*>(sVraw), vg + (long long)k0 * cv, cv, kv,
                          v_cols);
    cp_async_commit();
  };
  if (QRES)  // q stays: its first group is the first step's
    load_bytes<BM, QW>(sQ, q8g + (long long)m0 * p.q_row, p.q_row, n - m0, p.dq);
  Step next = {0, 0, 0, 0};
  load(next, 0);
  for (int r = threadIdx.x; r < BM; r += THREADS)
    sQs[r] = m0 + r < n ? p.qs_tab[((long long)b * n + m0 + r) * p.heads + head] : 0.f;
  if (MULTI)
    for (int i = threadIdx.x; i < BM * DVT; i += THREADS) sAcc[i] = 0.f;
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const float qs0 = sQs[r0], qs1 = sQs[r1];
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};
  float m_new[2], rs[2], bmax[2], lsum[2], vsc = 0.f;
  int pv[DVT / 8][4];
  int sc[BN / 8][4];

  for (int s = 0; next.blk < p.nk; ++s) {
    const Step cur = next;
    next = advance(cur);
    const int blk = cur.blk, tile = cur.tile, slab = cur.slab;
    const bool pass2 = cur.pass == 1;
    const int kv = TAIL ? min(BN, p.bk - tile * BN) : BN;
    cp_async_wait_all();
    __syncthreads();
    if (pass2 && slab == 0) {
      // transpose v (keys x DVT) into (DVT x keys): 4 x 4 byte blocks
      for (int w = threadIdx.x; w < (BN / 4) * (DVT / 4); w += THREADS) {
        const int kq4 = w % (BN / 4), c4 = w / (BN / 4);
        uint32_t x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = *reinterpret_cast<const uint32_t*>(sVraw + (4 * kq4 + i) * (DVT + PADB) + 4 * c4);
        const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140), t1 = __byte_perm(x[0], x[1], 0x7362);
        const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140), t3 = __byte_perm(x[2], x[3], 0x7362);
        uint32_t* d = reinterpret_cast<uint32_t*>(sVt + (4 * c4) * (BN + PADB) + 4 * kq4);
        constexpr int RW = (BN + PADB) / 4;  // row stride in words
        d[0] = __byte_perm(t0, t2, 0x5410);
        d[RW] = __byte_perm(t0, t2, 0x7632);
        d[2 * RW] = __byte_perm(t1, t3, 0x5410);
        d[3 * RW] = __byte_perm(t1, t3, 0x7632);
      }
    }
    __syncthreads();
    if (next.blk < p.nk) load(next, (s + 1) & 1);

    if (tile == 0 && slab == 0) {
      const float kss = ksg[blk] * p.scale_log2;
      rs[0] = qs0 * kss;
      rs[1] = qs1 * kss;
      if (!pass2) {
        bmax[0] = bmax[1] = -INFINITY;
      } else {
        lsum[0] = lsum[1] = 0.f;
#pragma unroll
        for (int i = 0; i < DVT / 8; ++i) pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0;
      }
    }

    // S += qq . kq^T over this step's columns, this warp's 16 rows x 64 keys
    if (slab == 0) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0;
    }
    const int8_t* sq = sQ + (QRES ? 0 : (s & 1) * BM * QROW);
    const int8_t* sk = sK + (s & 1) * S::K;
#pragma unroll
    for (int kk = 0; kk < QW / 32; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sq + (warp * 16 + (lane & 15)) * QROW + kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t bf[4];
        ldsm_x4(bf, sk + (nn * 16 + ((lane >> 4) << 3) + (lane & 7)) * QROW + kk * 32 +
                        ((lane >> 3) & 1) * 16);
        mma_s8(sc[2 * nn], a, bf[0], bf[1]);
        mma_s8(sc[2 * nn + 1], a, bf[2], bf[3]);
      }
    }
    if (slab != slabs - 1) continue;

    if (!pass2) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!TAIL || i * 8 + 2 * t4 + (e & 1) < kv)  // keys past the block's end: none
            bmax[e >> 1] =
                fmaxf(bmax[e >> 1], __fmul_rn(static_cast<float>(sc[i][e]), rs[e >> 1]));
      if (tile == tiles - 1) {  // end of pass 1: the block's row max
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffff, bmax[r], 1));
          bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffff, bmax[r], 2));
          m_new[r] = fmaxf(m_run[r], bmax[r]);
        }
      }
      continue;
    }

    // pass 2: p127 against the block max, rounded into sP, then pv += p . v
    const float sub0 = m_new[0] - LOG2_127, sub1 = m_new[1] - LOG2_127;
    int8_t* sp = sP + warp * 16 * (BN + PADB);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __fmul_rn(static_cast<float>(sc[i][e]), rs[e >> 1]);
        pe[e] = !TAIL || i * 8 + 2 * t4 + (e & 1) < kv ? exp2f(x - ((e >> 1) ? sub1 : sub0))
                                                       : 0.f;
        lsum[e >> 1] += pe[e];
      }
      const int col = i * 8 + 2 * t4;
      const int lo = min(__float2int_rn(pe[0]), 127) | (min(__float2int_rn(pe[1]), 127) << 8);
      const int hi = min(__float2int_rn(pe[2]), 127) | (min(__float2int_rn(pe[3]), 127) << 8);
      *reinterpret_cast<uint16_t*>(sp + g * (BN + PADB) + col) = static_cast<uint16_t>(lo);
      *reinterpret_cast<uint16_t*>(sp + (g + 8) * (BN + PADB) + col) = static_cast<uint16_t>(hi);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BN / 32; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sp + (lane & 15) * (BN + PADB) + kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int dn = 0; dn < DVT / 16; ++dn) {
        uint32_t bf[4];
        ldsm_x4(bf, sVt + (dn * 16 + ((lane >> 4) << 3) + (lane & 7)) * (BN + PADB) + kk * 32 +
                        ((lane >> 3) & 1) * 16);
        mma_s8(pv[2 * dn], a, bf[0], bf[1]);
        mma_s8(pv[2 * dn + 1], a, bf[2], bf[3]);
      }
    }

    if (tile == tiles - 1) {  // end of the block: fold into l and acc
      vsc = vsg[blk];
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lsum[r] += __shfl_xor_sync(0xffffffff, lsum[r], 1);
        lsum[r] += __shfl_xor_sync(0xffffffff, lsum[r], 2);
        corr[r] = exp2f(m_run[r] - m_new[r]);
        l_run[r] = __fadd_rn(__fmul_rn(l_run[r], corr[r]), lsum[r]);
        m_run[r] = m_new[r];
      }
      if (MULTI) {
#pragma unroll
        for (int i = 0; i < DVT / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* a = sAcc + ((e >> 1) ? r1 : r0) * DVT + i * 8 + 2 * t4 + (e & 1);
            *a = __fadd_rn(__fmul_rn(*a, corr[e >> 1]),
                           __fmul_rn(static_cast<float>(pv[i][e]), vsc));
          }
        }
      }
    }
  }

  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  const int row0 = m0 + r0, row1 = m0 + r1;
  // one block: acc = 0 * corr + float(pv) * vs, as the plain version forms it
  auto acc_at = [&](int i, int e) {
    return MULTI ? sAcc[((e >> 1) ? r1 : r0) * DVT + i * 8 + 2 * t4 + (e & 1)]
                 : __fmul_rn(static_cast<float>(pv[i][e]), vsc);
  };
  const long long obase = (long long)b * n * cv + head * p.dv + split * DVT;
  // guarded: rows past N or columns past dv in this block; an unguarded
  // copy of the loop for whole tiles keeps the stores free of branches
  auto store_values = [&](auto guarded_type) {
    constexpr bool guarded = decltype(guarded_type)::value;
#pragma unroll
    for (int i = 0; i < DVT / 8; ++i) {
      const int col = i * 8 + 2 * t4;
      if (guarded && col >= v_cols) continue;
      // _rn: the quotient the row pass of the int8 outputs quantizes
      const float o00 = __fmul_rn(acc_at(i, 0), inv0), o01 = __fmul_rn(acc_at(i, 1), inv0);
      const float o10 = __fmul_rn(acc_at(i, 2), inv1), o11 = __fmul_rn(acc_at(i, 3), inv1);
      if (OUT == OUT_F32) {
        float* of = static_cast<float*>(p.o) + obase + col;
        if (!guarded || row0 < n)
          *reinterpret_cast<float2*>(of + (long long)row0 * cv) = make_float2(o00, o01);
        if (!guarded || row1 < n)
          *reinterpret_cast<float2*>(of + (long long)row1 * cv) = make_float2(o10, o11);
      } else {
        __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + obase + col;
        if (!guarded || row0 < n)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * cv) =
              __floats2bfloat162_rn(o00, o01);
        if (!guarded || row1 < n)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * cv) =
              __floats2bfloat162_rn(o10, o11);
      }
    }
  };
  if (n % BM == 0 && v_cols >= DVT) {
    store_values(std::false_type{});
  } else {
    store_values(std::true_type{});
  }
}

// o fp32 (rows, heads * dv) -> int8 and f32 scales (rows, heads): per
// (row, head), amax over the head's dv columns floored at 1e-30,
// rint(o * (127 / amax)), amax / 127. One warp per (row, head).
__global__ void __launch_bounds__(256) quant_heads_kernel(const float* __restrict__ o, int rows,
                                                          int heads, int dv,
                                                          int8_t* __restrict__ o8,
                                                          float* __restrict__ os) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (item >= (long long)rows * heads) return;
  const float* src = o + item * dv;  // (row, head) rows are contiguous
  float amax = 0.f;
  for (int c = lane; c < dv; c += 32) amax = fmaxf(amax, fabsf(src[c]));
  amax = fmaxf(warp_max(amax), 1e-30f);
  const float qmul = 127.f / amax;
  int8_t* dst = o8 + item * dv;
  for (int c = lane; c < dv; c += 32)
    dst[c] = static_cast<int8_t>(__float2int_rn(__fmul_rn(src[c], qmul)));
  if (lane == 0) os[item] = amax * INV127;
}

template <int QW, bool QRES, bool MULTI, bool TAIL, int OUT>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = Smem<QW, QRES, MULTI>::TOTAL;
  auto kernel = flash_int8_kernel<QW, QRES, MULTI, TAIL, OUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n + BM - 1) / BM, p.heads * p.dv_splits, batch);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instantiations the routes reach (tests/test_torch_scales.py's route
// tables; every other int8 site runs flash_int8_sm90.cu): q/k 32 in one key
// block (phi='n' dark3), q/k 256 in several (phi='l' dark3), and the slab
// loop: one block of whole 64-key tiles (phi='l' h4) or, in general, acc in
// shared memory with a masked tail tile, which computes the same function
// for any block count and bk (the form every other shape takes).
template <int OUT>
cudaError_t launch_width(const Params& p, int batch, cudaStream_t stream) {
  const bool tail = p.bk % BN != 0;
  if (p.dq <= 64 && p.nk == 1)
    return tail ? launch<64, true, false, true, OUT>(p, batch, stream)
                : launch<64, true, false, false, OUT>(p, batch, stream);
  if (p.dq == 256 && p.nk > 1)
    return tail ? launch<256, true, true, true, OUT>(p, batch, stream)
                : launch<256, true, true, false, OUT>(p, batch, stream);
  if (p.nk == 1 && !tail) return launch<SLAB, false, false, false, OUT>(p, batch, stream);
  return launch<SLAB, false, true, true, OUT>(p, batch, stream);
}

// The shape rules shared by the entry points (JAX pick_blocks tiles these):
// N and bk multiples of 32, bk * nk == N, dq % 32, dv % 128; q rows 16-byte
// aligned.
bool shapes_ok(int n, int dq, int dv, int q_row, int bk, int nk) {
  return n > 0 && n % 32 == 0 && bk % 32 == 0 && bk * nk == n && dq > 0 && dq % 32 == 0 &&
         dv > 0 && dv % 128 == 0 && q_row % 16 == 0;
}

Params make_params(int n, int heads, int dq, int dv, int q_row, int bk, int nk,
                   float scale_log2) {
  Params p = {};
  p.n = n; p.heads = heads; p.dq = dq; p.dv = dv; p.q_row = q_row; p.bk = bk; p.nk = nk;
  p.dv_splits = (dv + DVT - 1) / DVT;
  p.scale_log2 = scale_log2;
  return p;
}

cudaError_t run(const Params& p, int batch, int out, cudaStream_t stream) {
  switch (out) {
    case OUT_BF16: return launch_width<OUT_BF16>(p, batch, stream);
    case OUT_F32: return launch_width<OUT_F32>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// o (fp32, `work`) -> the int8 output and its per-(row, head) scales
cudaError_t quant_heads(const void* work, int rows, int heads, int dv, void* out,
                        void* out_scales, cudaStream_t st) {
  const long long items = (long long)rows * heads;
  quant_heads_kernel<<<static_cast<unsigned>((items + 7) / 8), 256, 0, st>>>(
      static_cast<const float*>(work), rows, heads, dv, static_cast<int8_t*>(out),
      static_cast<float*>(out_scales));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q bf16 (q_f32 = 0) or fp32 (B, N, *) with row stride q_row, head h at
// column h * dq; kq (B, N, heads * dq), vq (B, N, heads * dv) int8; ks, vs
// (B, heads, nk) f32; q8 (B, N, heads * dq) int8 and q_scales (B, N, heads)
// f32 a workspace; out (B, N, heads * dv) in q's type. scale_log2 = scale *
// log2(e), rounded to f32 from double as JAX rounds its weakly typed
// constant. Returns the cudaError_t of the launches.
int flash_mha_int8(const void* q, int q_f32, const void* kq, const void* ks, const void* vq,
                   const void* vs, void* q8, void* q_scales, void* out, int batch, int n,
                   int heads, int dq, int dv, int q_row, int bk, int nk, float scale_log2,
                   void* stream) {
  if (!shapes_ok(n, dq, dv, heads * dq, bk, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = quant_q(q, q_f32, q_row, batch * n, heads, dq, q8, q_scales, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p = make_params(n, heads, dq, dv, heads * dq, bk, nk, scale_log2);
  p.q8 = static_cast<const int8_t*>(q8);
  p.qs_tab = static_cast<const float*>(q_scales);
  p.kq = static_cast<const int8_t*>(kq);
  p.vq = static_cast<const int8_t*>(vq);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.o = out;
  return static_cast<int>(run(p, batch, q_f32 ? OUT_F32 : OUT_BF16, st));
}

// Replaces _mha_flash_int8_qout_kernel: flash_mha_int8's arguments, the
// output int8 (B, N, heads * dv) with f32 scales (B, N, heads) per (row,
// head): o in fp32 into `work` (B, N, heads * dv), then a row pass.
int flash_mha_int8_qout(const void* q, int q_f32, const void* kq, const void* ks,
                        const void* vq, const void* vs, void* q8, void* q_scales, void* out,
                        void* out_scales, void* work, int batch, int n, int heads, int dq,
                        int dv, int q_row, int bk, int nk, float scale_log2, void* stream) {
  if (!shapes_ok(n, dq, dv, heads * dq, bk, nk) || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = quant_q(q, q_f32, q_row, batch * n, heads, dq, q8, q_scales, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p = make_params(n, heads, dq, dv, heads * dq, bk, nk, scale_log2);
  p.q8 = static_cast<const int8_t*>(q8);
  p.qs_tab = static_cast<const float*>(q_scales);
  p.kq = static_cast<const int8_t*>(kq);
  p.vq = static_cast<const int8_t*>(vq);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.o = work;
  err = run(p, batch, OUT_F32, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(quant_heads(work, batch * n, heads, dv, out, out_scales, st));
}

// Replaces _mha_flash_int8_handoff_kernel: q int8, the leading heads * dq
// columns of the qkv payload (B, N, q_row), with f32 scales qs (B, N, heads);
// kq, vq requantized per key block with scales (B, heads, nk). out_mode 2:
// int8 out with f32 out_scales (B, N, heads) through `work`, as
// flash_mha_int8_qout; 0: bf16 out; 1: fp32 out.
int flash_int8_handoff(const void* payload, const void* qs, const void* kq, const void* ks,
                       const void* vq, const void* vs, void* out, void* out_scales, void* work,
                       int batch, int n, int heads, int dq, int dv, int q_row, int bk, int nk,
                       float scale_log2, int out_mode, void* stream) {
  if (!shapes_ok(n, dq, dv, q_row, bk, nk) || out_mode < 0 || out_mode > 2 ||
      (out_mode == OUT_I8 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(n, heads, dq, dv, q_row, bk, nk, scale_log2);
  p.q8 = static_cast<const int8_t*>(payload);
  p.qs_tab = static_cast<const float*>(qs);
  p.kq = static_cast<const int8_t*>(kq);
  p.vq = static_cast<const int8_t*>(vq);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_mode != OUT_I8) {
    p.o = out;
    return static_cast<int>(run(p, batch, out_mode, st));
  }
  p.o = work;
  cudaError_t err = run(p, batch, OUT_F32, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(quant_heads(work, batch * n, heads, dv, out, out_scales, st));
}

}  // extern "C"
