// int8 flash attention for Hopper (sm_90a). One templated kernel replaces
// three TPU kernels of transparent_object_detection_tpu/ops/attention_int8.py:
//   * _mha_flash_int8_kernel (flash_attention_mha_int8): entry flash_mha_int8,
//     the function below with a bf16 output;
//   * _mha_flash_int8_qout_kernel (flash_attention_mha_int8_qout): entry
//     flash_mha_int8_qout, the same with the output quantized (O8, below);
//   * _mha_flash_int8_handoff_kernel (flash_attention_int8_handoff): entry
//     flash_int8_handoff, q int8 from the qkv projection's payload (Q8) and
//     the output int8 (O8) or bf16.
// Q8: q is read in place as int8 from the payload's leading columns (row
// stride q_row = 3C) and used as it is, no re-rounding; its scale per (row,
// head) comes from a table (B, N, heads). O8: o = acc * (1 / l), amax over the
// head's dv columns (floor 1e-30), out rint(o * (127 / amax)) and amax / 127
// into column `head` of (B, N, heads). A block holds a head's whole output
// row only when dv == 256 (one slice), so O8 refuses other widths; the amax
// is then a reduction over the 4 threads of a quad.
//
// Inputs: q bf16, head-packed, read in place (the (B, N, 3C) qkv array with
// row stride 3C, or a plain (B, N, Cq) array); kq (B, N, Cq) and vq (B, N, Cv)
// int8 with one f32 scale per (batch, head, block of bk keys), (B, H, N / bk).
// Per query row and head, with s_scale = scale * log2(e):
//   qq = rint(q * (127 / amax_row)), qs = amax_row / 127     (in the block)
//   per key block j:
//     s = float(qq . kq) * (qs * (ks_j * s_scale))          (int32 dot, exact)
//     pass 1: m_new = max(m, max of s over the WHOLE block)  (m starts -1e30)
//     pass 2: p127 = exp2(s - (m_new - log2 127)); l = l * exp2(m - m_new)
//             + sum p127 (unrounded); pv = int32 sum over the block of
//             rint(p127) * vq; acc = acc * exp2(m - m_new) + float(pv) * vs_j
//   out = acc * (1 / l), bf16.
// p is rounded against the maximum of its whole quantization block, as the
// TPU kernel does (its key block is the whole quantization block). A
// textbook online softmax over 64-key tiles would round against a running
// maximum and keep weights below 1/254 of the row's peak that come before it:
// another function. So each block costs a second pass of the int8 q.k^T:
// +50% of the MMA work on the neck heads (dq = dv), +11% on dark3 (dq 64,
// dv 512).
//
// Bound. At phi='s' 640x640 per image: h2 2 * 6,400^2 * 2 * 1,536 = 252 G
// int8 operations (one q.k^T and one p.v pass), dark3 47 G, h1 21 G, h4 16 G;
// inputs and outputs are tens of MB, so the work is bound by operations:
// >= 0.17 ms an image at the H100 SXM data sheet's 1,979 int8 TOPS.
//
// Design. A block owns 64 query rows (16 per warp) of one head and one
// 256-wide slice of its v columns (dark3's 512 splits across 2 blocks, which
// recompute q.k^T). q is quantized into shared memory once. Keys stream in
// tiles of 64 through a 2-stage cp.async ring, both passes and all blocks in
// one sequence of steps. Both products are mma.sync m16n8k32 s8 x s8 -> s32.
// The s32 C fragment of that instruction holds 2 adjacent key columns of an
// 8-wide tile, the s8 A fragment wants 4, so rint(p127) goes through a small
// shared tile (one per warp's rows) and comes back with ldmatrix. The B
// operand of p.v needs keys contiguous per v column: each v tile is
// transposed in shared memory (4 x 4 byte blocks with byte permutes).
// pv stays int32 over a whole block (128 registers a thread); with more than
// one block the fp32 acc lives in shared memory, touched once per block (one
// block of 157 KB an SM); with one block, the serving path's, it is formed
// from pv at the end (95.5 KB, two blocks an SM). Requires N and bk to be
// multiples of 64 (the wrapper checks; the serving path's are 1,600 / 6,400).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // query rows per block
constexpr int BN = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr int DVT = 256;     // v columns one block accumulates
constexpr int PADB = 16;     // byte padding of a shared row (bank spread)
constexpr float LOG2_127 = 6.988684686772166f;
constexpr float INV127 = (float)(1.0 / 127.0);

struct Params {
  const __nv_bfloat16* q;   // bf16 q (Q8 false)
  const int8_t* q8;         // int8 q, the qkv payload (Q8 true)
  const float* qs_tab;      // its per-(row, head) scales (B, N, heads)
  const int8_t* kq;
  const int8_t* vq;
  const float* ks;
  const float* vs;
  __nv_bfloat16* o;         // bf16 out (O8 false)
  int8_t* o8;               // int8 out (O8 true)
  float* os;                // its per-(row, head) scales (B, N, heads)
  int n, heads, dq, dv, q_row, bk, nk, dv_splits;
  float scale_log2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
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

template <int DQ, bool MULTI>
struct Smem {
  static constexpr int Q = BM * (DQ + PADB);          // quantized q
  static constexpr int K = BN * (DQ + PADB);          // one k stage
  static constexpr int VRAW = BN * (DVT + PADB);      // v tile as loaded
  static constexpr int VT = DVT * (BN + PADB);        // v tile transposed
  static constexpr int P = BM * (BN + PADB);          // rint(p127)
  static constexpr int ACC = MULTI ? BM * DVT * 4 : 0; // fp32 acc (nk > 1)
  static constexpr int QS = BM * 4;                   // q row scales
  static constexpr int TOTAL = Q + 2 * K + VRAW + VT + P + ACC + QS;
};

// MULTI: more than one key block (nk > 1), the fp32 acc in shared memory.
// With one block (the serving path: bk = N) acc is float(pv) * vs, formed at
// the end; the block then needs 95.5 KB of shared memory and two fit an SM.
// Q8: q arrives int8 (the handoff), with its scale from the table. O8: the
// output is quantized per (row, head); the block holds the head's whole dv.
template <int DQ, bool MULTI, bool Q8, bool O8>
__global__ void __launch_bounds__(THREADS, MULTI ? 1 : 2) flash_int8_kernel(const Params p) {
  using S = Smem<DQ, MULTI>;
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
  const int cq = p.heads * DQ, cv = p.heads * p.dv;
  const __nv_bfloat16* qg = p.q + (long long)b * p.n * p.q_row + head * DQ;
  const int8_t* q8g = p.q8 + (long long)b * p.n * p.q_row + head * DQ;
  const int8_t* kg = p.kq + (long long)b * p.n * cq + head * DQ;
  const int8_t* vg = p.vq + (long long)b * p.n * cv + head * p.dv + split * DVT;
  const float* ksg = p.ks + ((long long)b * p.heads + head) * p.nk;
  const float* vsg = p.vs + ((long long)b * p.heads + head) * p.nk;
  __nv_bfloat16* og = p.o + (long long)b * p.n * cv + head * p.dv + split * DVT;

  const int tiles = p.bk / BN;   // key tiles per quantization block
  const int steps = 2 * tiles * p.nk;
  // step s: block s / (2 tiles), pass (s / tiles) & 1, key tile
  auto key0 = [&](int s) { return ((s / (2 * tiles)) * tiles + s % tiles) * BN; };
  auto is_pass2 = [&](int s) { return ((s / tiles) & 1) == 1; };
  auto load = [&](int s) {
    const int k0 = key0(s);
    int8_t* dk = sK + (s & 1) * S::K;
    for (int c = threadIdx.x; c < BN * (DQ / 16); c += THREADS) {
      const int r = c / (DQ / 16), col = (c % (DQ / 16)) * 16;
      cp_async16(dk + r * (DQ + PADB) + col, kg + (long long)(k0 + r) * cq + col);
    }
    if (is_pass2(s)) {
      for (int c = threadIdx.x; c < BN * (DVT / 16); c += THREADS) {
        const int r = c / (DVT / 16), col = (c % (DVT / 16)) * 16;
        cp_async16(sVraw + r * (DVT + PADB) + col, vg + (long long)(k0 + r) * cv + col);
      }
    }
    cp_async_commit();
  };
  load(0);

  // q: per (row, head) int8 in shared memory; each warp its 16 rows
  for (int r = warp * 16; r < warp * 16 + 16 && Q8; ++r) {
    // int8 q from the payload as it is, no re-rounding; scale from the table
    if (lane * 16 < DQ)
      *reinterpret_cast<uint4*>(sQ + r * (DQ + PADB) + lane * 16) =
          *reinterpret_cast<const uint4*>(q8g + (long long)(m0 + r) * p.q_row + lane * 16);
    if (lane == 0) sQs[r] = p.qs_tab[((long long)b * p.n + m0 + r) * p.heads + head];
  }
  for (int r = warp * 16; r < warp * 16 + 16 && !Q8; ++r) {
    float f[8];
    float amax = 0.f;
    const bool mine = lane * 8 < DQ;
    if (mine) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(qg + (long long)(m0 + r) * p.q_row + lane * 8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
        amax = fmaxf(amax, fmaxf(fabsf(t.x), fabsf(t.y)));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, o));
    amax = fmaxf(amax, 1e-12f);
    if (mine) {
      const float inv = 127.f / amax;
      char4 lo, hi;
      lo.x = __float2int_rn(f[0] * inv); lo.y = __float2int_rn(f[1] * inv);
      lo.z = __float2int_rn(f[2] * inv); lo.w = __float2int_rn(f[3] * inv);
      hi.x = __float2int_rn(f[4] * inv); hi.y = __float2int_rn(f[5] * inv);
      hi.z = __float2int_rn(f[6] * inv); hi.w = __float2int_rn(f[7] * inv);
      char4* dst = reinterpret_cast<char4*>(sQ + r * (DQ + PADB) + lane * 8);
      dst[0] = lo;
      dst[1] = hi;
    }
    if (lane == 0) sQs[r] = amax * INV127;
  }
  if (MULTI)
    for (int i = threadIdx.x; i < BM * DVT; i += THREADS) sAcc[i] = 0.f;
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const float qs0 = sQs[r0], qs1 = sQs[r1];
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};
  float m_new[2], rs[2], bmax[2], lsum[2], vsc = 0.f;
  int pv[DVT / 8][4];

  for (int s = 0; s < steps; ++s) {
    const int blk = s / (2 * tiles);
    const bool pass2 = is_pass2(s);
    const bool first = s % tiles == 0;
    cp_async_wait_all();
    __syncthreads();
    if (pass2) {
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
    if (s + 1 < steps) load(s + 1);

    if (first) {
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

    // S = qq . kq^T for this warp's 16 rows x 64 keys (int32)
    int sc[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0;
    const int8_t* sk = sK + (s & 1) * S::K;
#pragma unroll
    for (int kk = 0; kk < DQ / 32; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sQ + (warp * 16 + (lane & 15)) * (DQ + PADB) + kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t bf[4];
        ldsm_x4(bf, sk + (nn * 16 + ((lane >> 4) << 3) + (lane & 7)) * (DQ + PADB) + kk * 32 +
                        ((lane >> 3) & 1) * 16);
        mma_s8(sc[2 * nn], a, bf[0], bf[1]);
        mma_s8(sc[2 * nn + 1], a, bf[2], bf[3]);
      }
    }

    if (!pass2) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bmax[e >> 1] = fmaxf(bmax[e >> 1], __fmul_rn(static_cast<float>(sc[i][e]), rs[e >> 1]));
      if (s % tiles == tiles - 1) {  // end of pass 1: the block's row max
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
        pe[e] = exp2f(x - ((e >> 1) ? sub1 : sub0));
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

    if (s % tiles == tiles - 1) {  // end of the block: fold into l and acc
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
  // one block: acc = 0 * corr + float(pv) * vs, as the plain version forms it
  auto acc_at = [&](int i, int e) {
    return MULTI ? sAcc[((e >> 1) ? r1 : r0) * DVT + i * 8 + 2 * t4 + (e & 1)]
                 : __fmul_rn(static_cast<float>(pv[i][e]), vsc);
  };
  if (O8) {
    // o = acc / l per (row, head); amax over the head's dv columns, which
    // the 4 threads of a quad hold between them; rint(o * (127 / amax))
    float amax[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DVT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        amax[e >> 1] = fmaxf(amax[e >> 1],
                             fabsf(__fmul_rn(acc_at(i, e), (e >> 1) ? inv1 : inv0)));
    float qmul[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffff, amax[r], 1));
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffff, amax[r], 2));
      amax[r] = fmaxf(amax[r], 1e-30f);
      qmul[r] = 127.f / amax[r];
    }
    int8_t* o8g = p.o8 + (long long)b * p.n * cv + head * p.dv;
#pragma unroll
    for (int i = 0; i < DVT / 8; ++i) {
      const int col = i * 8 + 2 * t4;
      char2 v0, v1;
      v0.x = static_cast<char>(__float2int_rn(__fmul_rn(__fmul_rn(acc_at(i, 0), inv0), qmul[0])));
      v0.y = static_cast<char>(__float2int_rn(__fmul_rn(__fmul_rn(acc_at(i, 1), inv0), qmul[0])));
      v1.x = static_cast<char>(__float2int_rn(__fmul_rn(__fmul_rn(acc_at(i, 2), inv1), qmul[1])));
      v1.y = static_cast<char>(__float2int_rn(__fmul_rn(__fmul_rn(acc_at(i, 3), inv1), qmul[1])));
      *reinterpret_cast<char2*>(o8g + (long long)(m0 + r0) * cv + col) = v0;
      *reinterpret_cast<char2*>(o8g + (long long)(m0 + r1) * cv + col) = v1;
    }
    if (t4 == 0) {
      p.os[((long long)b * p.n + m0 + r0) * p.heads + head] = amax[0] * INV127;
      p.os[((long long)b * p.n + m0 + r1) * p.heads + head] = amax[1] * INV127;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < DVT / 8; ++i) {
    const int col = i * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(og + (long long)(m0 + r0) * cv + col) =
        __floats2bfloat162_rn(acc_at(i, 0) * inv0, acc_at(i, 1) * inv0);
    *reinterpret_cast<__nv_bfloat162*>(og + (long long)(m0 + r1) * cv + col) =
        __floats2bfloat162_rn(acc_at(i, 2) * inv1, acc_at(i, 3) * inv1);
  }
}

template <int DQ, bool MULTI, bool Q8, bool O8>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = Smem<DQ, MULTI>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(flash_int8_kernel<DQ, MULTI, Q8, O8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.n / BM, p.heads * p.dv_splits, batch);
  flash_int8_kernel<DQ, MULTI, Q8, O8><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DQ, bool Q8, bool O8>
cudaError_t launch_blocks(const Params& p, int batch, cudaStream_t stream) {
  return p.nk == 1 ? launch<DQ, false, Q8, O8>(p, batch, stream)
                   : launch<DQ, true, Q8, O8>(p, batch, stream);
}

// The shape checks shared by the entry points; the int8-out forms need a
// head's whole dv in one block (dv == DVT), the variants q/k width 256.
bool shapes_ok(int n, int dq, int dv, int bk, int nk, bool variant, bool int8_out) {
  if (n % BM || bk % BN || bk * nk != n || dv % DVT) return false;
  if (variant && dq != 256) return false;
  return !int8_out || dv == DVT;
}

Params make_params(int n, int heads, int dq, int dv, int q_row, int bk, int nk,
                   float scale_log2) {
  Params p = {};
  p.n = n; p.heads = heads; p.dq = dq; p.dv = dv; p.q_row = q_row; p.bk = bk; p.nk = nk;
  p.dv_splits = dv / DVT;
  p.scale_log2 = scale_log2;
  return p;
}

}  // namespace

extern "C" {

// q bf16 (B, N, *) with row stride q_row, head h at column h * dq; kq
// (B, N, heads * dq), vq (B, N, heads * dv) int8; ks, vs (B, heads, nk) f32;
// out (B, N, heads * dv) bf16; scale_log2 = scale * log2(e), rounded to f32
// from double as JAX rounds its weakly typed constant. n % 64 == 0,
// bk % 64 == 0, n == bk * nk, dq in {64, 256}, dv % 256 == 0. Returns the
// cudaError_t of the launch.
int flash_mha_int8(const void* q, const void* kq, const void* ks, const void* vq,
                   const void* vs, void* out, int batch, int n, int heads, int dq, int dv,
                   int q_row, int bk, int nk, float scale_log2, void* stream) {
  if (!shapes_ok(n, dq, dv, bk, nk, false, false)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(n, heads, dq, dv, q_row, bk, nk, scale_log2);
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kq = static_cast<const int8_t*>(kq);
  p.vq = static_cast<const int8_t*>(vq);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dq) {
    case 64: return static_cast<int>(launch_blocks<64, false, false>(p, batch, st));
    case 256: return static_cast<int>(launch_blocks<256, false, false>(p, batch, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Replaces _mha_flash_int8_qout_kernel: flash_mha_int8's arguments, the
// output int8 (B, N, heads * dv) with f32 scales (B, N, heads) per (row,
// head). dq == 256, dv == 256.
int flash_mha_int8_qout(const void* q, const void* kq, const void* ks, const void* vq,
                        const void* vs, void* out, void* out_scales, int batch, int n,
                        int heads, int dq, int dv, int q_row, int bk, int nk, float scale_log2,
                        void* stream) {
  if (!shapes_ok(n, dq, dv, bk, nk, true, true)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(n, heads, dq, dv, q_row, bk, nk, scale_log2);
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kq = static_cast<const int8_t*>(kq);
  p.vq = static_cast<const int8_t*>(vq);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.o8 = static_cast<int8_t*>(out);
  p.os = static_cast<float*>(out_scales);
  return static_cast<int>(launch_blocks<256, false, true>(p, batch,
                                                          static_cast<cudaStream_t>(stream)));
}

// Replaces _mha_flash_int8_handoff_kernel: q int8, the leading heads * dq
// columns of the qkv payload (B, N, q_row), with f32 scales qs (B, N, heads);
// kq, vq requantized per key block with scales (B, heads, nk). quant_out:
// int8 out with f32 out_scales (B, N, heads) (dv == 256), else bf16 out and
// out_scales unused. dq == 256.
int flash_int8_handoff(const void* payload, const void* qs, const void* kq, const void* ks,
                       const void* vq, const void* vs, void* out, void* out_scales, int batch,
                       int n, int heads, int dq, int dv, int q_row, int bk, int nk,
                       float scale_log2, int quant_out, void* stream) {
  if (!shapes_ok(n, dq, dv, bk, nk, true, quant_out != 0) || q_row % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(n, heads, dq, dv, q_row, bk, nk, scale_log2);
  p.q8 = static_cast<const int8_t*>(payload);
  p.qs_tab = static_cast<const float*>(qs);
  p.kq = static_cast<const int8_t*>(kq);
  p.vq = static_cast<const int8_t*>(vq);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quant_out) {
    p.o8 = static_cast<int8_t*>(out);
    p.os = static_cast<float*>(out_scales);
    return static_cast<int>(launch_blocks<256, true, true>(p, batch, st));
  }
  p.o = static_cast<__nv_bfloat16*>(out);
  return static_cast<int>(launch_blocks<256, true, false>(p, batch, st));
}

}  // extern "C"
