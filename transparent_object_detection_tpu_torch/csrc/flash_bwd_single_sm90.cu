// Flash-attention backward for Hopper (sm_90a), bf16, one head: wgmma fed
// by TMA through mbarrier rings, two consumer warpgroups and one producer
// warpgroup a block, two kernels, no atomics.
//
// Replaces, for bf16 calls with one head (dark3 at phi 'n', 's' and 'm':
// q/k 32, 64, 128 and v 256, 512, 1,024; the folded heads of phi 'n' and
// 'm' as the fold copy pads them: 288 and 600), the two TPU kernels of
// transparent_object_detection_tpu/ops/attention_vjp.py (flash_bwd with
// num_heads == 1):
//   * _bwd_dq_kernel  -> flash_bwd_dq_single_kernel:  dq = sum_k dS K
//   * _bwd_dkv_kernel -> flash_bwd_dkv_single_kernel: dk = sum_q dS^T Q,
//                                                     dv = sum_q P^T dO
// ops/attention_vjp.py::bwd_form states the rule and bwd_single_sm90_plan
// the plans; csrc/flash_bwd_sm90.cu keeps packed heads of 128 to 384,
// csrc/flash_bwd_f32_sm90.cu fp32, csrc/flash_bwd_wide_sm90.cu the rest
// (phi 'l' and 'x' dark3, packed heads of 448 and wider).
//
// Arithmetic, that of flash_bwd_dq_plain / flash_bwd_dkv_plain and of the
// Pallas kernels (_recompute_p_ds and its two callers), per (query, key)
// tile: S = Q K^T in fp32; P = exp2(S * scale * log2 e - lse * log2 e); dP =
// dO V^T; dS = P * (dP - D) * scale; P and dS rounded to bf16 before their
// products; dq, dk and dv summed in fp32 and stored in bf16. Where the two
// warpgroups each sum part of a contraction (below), the parts are added
// in one fixed order, so the result has the same bits from run to run.
//
// Bound. The Pallas count is 2 * N^2 * (4 * dqk + 3 * dv) operations an
// image: dq 2N^2 (2 dqk + dv), dk/dv 2N^2 (2 dqk + 2 dv). These kernels do
// it once, plus S^T once more for every dv slice (a DV block, below): 2N^2
// dqk a slice, one slice at every site but phi='m' dark3 (two: +3.6% of
// the Pallas count). Against a few tens of MB of inputs and outputs, the
// tensor cores bound it (989 TFLOP/s bf16; phi='m' dark3 + folded h1 at
// batch 2: 0.94 ms); what holds it back is the latency of short m64n64k16
// chains, drained slab by slab, and the hand-over between the warpgroups
// in every tile (PERF.md).
//
// Design. A block owns 64 rows: 64 queries (dq) or 64 keys (dk/dv; keys are
// the wgmma M dimension, so S^T = K Q^T and dP^T = V dO^T come out of the
// accumulator in the A layout of dK += dS^T Q and dV += P^T dO). It walks
// the other axis in tiles of T tokens: 128 where three ring stages of them
// fit beside the resident rows (dark3 of phi 'n' and 's'), else 64. Per
// tile there are two kinds of product:
//   * the contractions, S over the q/k slabs ("X") and dP over the v slabs
//     ("Y"), as SS m64nTk16 products: the block's rows resident (A), the
//     tile's rows streamed (B), both K-major; a chain of short products
//     waits on each step's latency, so the longer tile does twice the work
//     a step (faster at dark3 of phi 'n' and 's' than tiles of 64);
//   * the gradient product, dS or P (bf16, from shared memory) times the
//     tile's rows of K, Q or dO read MN-major, 64-column output slabs two
//     at a time (independent accumulators of 32 registers a slab).
// The two consumer warpgroups split both. The contraction's slabs, X then
// Y in one list, are cut at `split` (ops/attention_vjp.py::single_split):
// warpgroup 0 sums all of X and the first part of Y, warpgroup 1 the rest,
// and warpgroup 1 hands its fp32 part over through shared memory;
// warpgroup 0 adds it (its own part first), forms P and dS, and writes the
// bf16 operand of the gradient product over the hand-over buffer. The
// output slabs are cut in two (all of them warpgroup 0's for dq and dK up
// to two slabs), so no gradient is summed across warpgroups and nothing is
// reduced at the end. Warpgroup 1 runs one contraction ahead: tile t + 1's
// while warpgroup 0 forms tile t's operand. Each warpgroup has its own ring
// of T x 64 slabs (128-byte swizzle) filled by its own producer thread in
// the order it consumes them; a slab is released once the wgmma group that
// read it has retired.
//   * dark3's asymmetry (v = 8 q/k). dV = P^T dO needs only S^T, which
//     contracts over the narrow q/k; dK and dQ need dP, which contracts over
//     the wide v. So dk/dv is one launch of two block kinds: blockIdx.y 0 is
//     the DK block (S^T once, dP^T accumulated over v's slabs once, dK of
//     q/k's width; at phi='m' warpgroup 0 sums S^T's 2 slabs and 5 of
//     dP^T's 16 beside its elementwise pass and the dK product, warpgroup 1
//     the other 11), blockIdx.y >= 1 the DV blocks, one a slice of up to ten
//     v slabs (five a warpgroup), each recomputing only S^T (its q/k slabs
//     split between the warpgroups). dP^T is never recomputed. dq: S and dP
//     split likewise, dQ of q/k's width. Where dQ or dK is one or two slabs,
//     warpgroup 0's gradient product reads the X slabs of its contraction
//     again (K's for dq, Q's for dK), held in the ring, instead of new
//     copies.
//   * Residency. The block's rows stay resident: at phi='m' dark3 K (16 KB)
//     and V (128 KB) in the DK block, Q and dO in dq. The tile's rows
//     stream, slab by slab, through the rings: one tile of dO or V at
//     phi='m' is 128 KB, more than the rings could hold beside the resident
//     rows, and streaming the tile side reads each of the block's own rows
//     once.
//   * Folded heads of 288 and 600 (5 and 10 slabs, the last one partial).
//     The tensor maps' inner dimension is the real width: TMA zero-fills
//     the columns of the last slab past it, so no pad copy is needed, the
//     zero columns add nothing to S or dP, and the output columns past the
//     width are never stored. At 600 a warpgroup owns five output slabs
//     (160 registers) of dQ, dK or dV: one pass, no output recomputed;
//     warpgroup 0 sums S (10 slabs), warpgroup 1 dP (10 slabs).
//   * setmaxnreg: the producer warpgroup gives up 144 registers a thread
//     (168 -> 24), the consumers take exactly that (168 -> 240); more would
//     hang the launch.
//   Tried and dropped, slower on the H100 (PERF.md): blocks in clusters of
//   two (or four) sharing each streamed slab by TMA multicast; two
//   accumulator chains in the contractions; two slabs a wgmma group;
//   keeping a group in flight across slabs; dV slices of four slabs at
//   dark3; other contraction splits.
//
// Trouble spots, each handled where its tag appears below:
//   [ragged N]   keys and queries past N: TMA zero-fills them, a zero-filled
//                token scores 0 (not -inf), so P is set to 0 there; lse and
//                D are never read past N; rows past N are never stored
//   [columns]    the zero-filled columns past a width that is not a multiple
//                of 64, and the output columns past it never stored
//   [exchange]   the fp32 hand-over and the bf16 operand in one buffer
//   [fences]     wgmma fences, pinned accumulators and drained groups (else
//                ptxas serializes the wgmma pipeline), the generic -> async
//                proxy fence, mbarrier phases
//   [ring]       slab order and release, no deadlock at two stages
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int SLAB = 64;                 // columns of a slab; rows of a block
constexpr int SLAB_BYTES = 64 * 64 * 2;  // a resident slab (64 rows), bf16
constexpr int THREADS_SM90 = 384;        // consumer warpgroups 0 and 1, producer 2
constexpr int MAX_STAGES = 8;            // a ring's stages
constexpr int MAX_OUT_SLABS = 5;         // output slabs a warpgroup accumulates
constexpr int MAX_SLICE_SLABS = 2 * MAX_OUT_SLABS;
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block may use
constexpr int ALIGN = 1024;              // a swizzle atom: 8 rows of 128 bytes
constexpr int BARRIER_BYTES = 2048;      // the barriers, then the statistics
constexpr int STATS_OFFSET = 1024;       // 2 * T floats
// A tile of T tokens (64, or 128 where the shared memory allows): a ring
// entry holds its T rows of one 64-column slab; the fp32 hand-over (64 x T)
// holds the bf16 operand of the gradient product too.
__host__ __device__ constexpr int entry_bytes(int t) { return t * 128; }
__host__ __device__ constexpr int xchg_bytes(int t) { return 64 * t * 4; }

// named barriers (never 0: __syncthreads)
enum { BAR_F_FULL = 1, BAR_F_EMPTY = 2, BAR_B_FULL = 3, BAR_WG0 = 4 };
enum { KIND_DQ = 0, KIND_DK = 1, KIND_DV = 2 };

struct SingleParams {
  const float* lse;   // (B, N)
  const float* dcap;  // (B, N)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dq_batch, dq_row, dk_batch, dk_row, dv_batch, dv_row;
  int n, dqk, dv_width;
  int qs, vs;         // 64-column slabs of the q/k and v widths
  int split;          // contraction slabs of warpgroup 0 (dq, DK blocks)
  int slice_slabs;    // v slabs of a DV block
  int stages;         // each ring's
  float scale, scale_log2;
};

// What one warpgroup does on every tile: contraction slabs [lo, hi) of the
// list X (q/k slabs 0..qs-1) then Y (v slabs, qs..qs+vs-1), and output
// slabs [g0, g0 + gn) of its gradient's width.
struct Work {
  int lo, hi, g0, gn;
};

// dQ's or dK's output slabs of warpgroup 0: all of them up to two (then
// warpgroup 1 has none, and runs its next tile's contraction while
// warpgroup 0 finishes this one), else the larger half
__host__ __device__ __forceinline__ int out_slabs_of(int qs) { return qs <= 2 ? qs : (qs + 1) / 2; }

__device__ __forceinline__ Work work_of(int kind, int wg, int slice, const SingleParams& p) {
  Work w;
  if (kind == KIND_DV) {  // X only: S^T's q/k slabs halved; the slice's v slabs halved
    const int a = p.qs / 2;
    w.lo = wg == 0 ? 0 : a;
    w.hi = wg == 0 ? a : p.qs;
    const int s0 = slice * p.slice_slabs;
    const int sn = min(p.slice_slabs, p.vs - s0);
    const int h = (sn + 1) / 2;
    w.g0 = s0 + (wg == 0 ? 0 : h);
    w.gn = wg == 0 ? h : sn - h;
  } else {  // warpgroup 0 all of X and Y's first part (split >= qs)
    w.lo = wg == 0 ? 0 : p.split;
    w.hi = wg == 0 ? p.split : p.qs + p.vs;
    const int h = out_slabs_of(p.qs);
    w.g0 = wg == 0 ? 0 : h;
    w.gn = wg == 0 ? h : p.qs - h;
  }
  return w;
}

// a barrier over warpgroup 0's 128 threads alone
__device__ __forceinline__ void wg0_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(static_cast<int>(BAR_WG0)) : "memory");
}

// one arrival a warp, after the warp's wgmma.wait_group covered its reads
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// A warpgroup's ring of slabs: stage g % stages, phase (g / stages) & 1.
struct Ring {
  uint32_t full, empty, data, unit;
  int stages;
  // [fences] waits until slab g has landed
  __device__ __forceinline__ uint32_t at(int g) const {
    const int st = g % stages;
    mbar_wait(full + 8 * st, (g / stages) & 1);
    return data + st * unit;
  }
  __device__ __forceinline__ void free(int g) const { release(empty + 8 * (g % stages)); }
};

// [fences] An accumulator's registers pinned at this point of the program:
// the compiler may move no ordinary instruction that reads or writes them
// across it. After a wgmma.wait_group, ordinary reads stay behind the wait;
// before a wgmma.fence, ordinary writes stay ahead of it. (Otherwise ptxas
// finds such instructions inside the wgmma pipeline and serializes it.)
template <int N>
__device__ __forceinline__ void pin(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(a[i])::"memory");
}

// [ring] acc = the contraction slabs [c0, c1) of the ring's slabs g, g + 1,
// ...: A the resident slab `res + (c - cbase) * SLAB_BYTES`, B the ring's
// (T tokens), one m64nTk16 chain (its first step overwrites acc). Each slab is
// released as soon as its group retires: [fences] no group is ever left in
// flight past a runtime branch (ptxas serializes every wgmma of a pipeline
// it cannot prove drained before an ordinary instruction reads an
// accumulator: measured slower), and holding one slab a
// warpgroup leaves the producer the rest of the ring. (Two slabs a group,
// or two accumulator chains, measured no faster.)
// With `hold` the slabs stay in the ring (for the gradient product to read
// again) and the caller frees them.
template <int T>
__device__ __forceinline__ void contract(float (&acc)[T / 2], uint32_t res, int cbase, int c0,
                                         int c1, const Ring& ring, int& g, bool hold = false) {
  pin(acc);
  wgmma_fence();  // [fences] acc was last read by ordinary instructions
  for (int c = c0; c < c1; ++c) {
    const uint32_t b = ring.at(g);
    const uint32_t a = res + (c - cbase) * SLAB_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_sw128(a + kk * 32, 16, 1024);
      const uint64_t db = desc_sw128(b + kk * 32, 16, 1024);
      if constexpr (T == 64) wgmma_ss_n64(acc, da, db, !(c == c0 && kk == 0));
      if constexpr (T == 128) wgmma_ss_n128(acc, da, db, !(c == c0 && kk == 0));
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (!hold) ring.free(g);
    ++g;
  }
  pin(acc);
}

// acc[j] += (dS or P, bf16 in `a_tile`: 64 x T, K-major in 64-column
// tiles) x the ring's output slabs g .. g + gn - 1 (T tokens x 64 columns),
// two slabs (independent accumulators, their k16 steps interleaved) a
// group; each slab freed once read
template <int G, int T>
__device__ __forceinline__ void grad_product(float (&acc)[G][32], uint32_t a_tile, int gn,
                                             const Ring& ring, int g) {
#pragma unroll
  for (int j = 0; j < G; ++j) pin(acc[j]);
  wgmma_fence();  // [fences] acc was last written by ordinary instructions or a retired group
#pragma unroll
  for (int j = 0; j < G; j += 2) {
    if (j < gn) {
      const bool two = j + 1 < gn;
      const uint32_t b0 = ring.at(g + j);
      const uint32_t b1 = two ? ring.at(g + j + 1) : b0;
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        const uint64_t da = desc_sw128(a_tile + (kk >> 2) * SLAB_BYTES + (kk & 3) * 32, 16, 1024);
        wgmma_ss_n64_tb(acc[j], da, desc_sw128(b0 + kk * 16 * 128, SLAB_BYTES, 1024));
        if (two)  // j + 1 < gn <= G: the index below is j + 1
          wgmma_ss_n64_tb(acc[j + 1 < G ? j + 1 : j], da,
                          desc_sw128(b1 + kk * 16 * 128, SLAB_BYTES, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      ring.free(g + j);
      if (two) ring.free(g + j + 1);
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) pin(acc[j]);
}

// [exchange] the bf16 A operand of the gradient product, 64 x T K-major in
// 64-column tiles with the 128-byte swizzle (16-byte chunk q of row r at
// chunk q ^ (r % 8)), from a 64 x T fp32 accumulator layout: element 4i +
// 2h + e is row r0 + 8h, column 8i + 2 * (lane % 4) + e
template <int T>
__device__ __forceinline__ void write_operand(unsigned char* tile, const float (&x)[T / 2],
                                              int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < T / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      *reinterpret_cast<uint32_t*>(tile + (i >> 3) * SLAB_BYTES + r * 128 +
                                   (((i & 7) ^ (r & 7)) << 4) + 4 * (lane & 3)) =
          pack_bf16(x[4 * i + 2 * h], x[4 * i + 2 * h + 1]);
    }
}

// The output slabs [g0, g0 + gn) of a 64 x (64 * G) accumulator -> bf16 rows
// of `out` (row stride `row`), rows from row0; [ragged N] rows at or past n
// and [columns] columns at or past `width` skipped
template <int G>
__device__ __forceinline__ void store_slabs(const float (&acc)[G][32], __nv_bfloat16* out,
                                            long long row, int row0, int n, int width, int g0,
                                            int gn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= gn) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = (g0 + j) * SLAB + 8 * i + 2 * (lane & 3);
      if (col >= width) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = row0 + 8 * h;
        if (rr < n)
          *reinterpret_cast<__nv_bfloat162*>(out + rr * row + col) =
              __floats2bfloat162_rn(acc[j][4 * i + 2 * h], acc[j][4 * i + 2 * h + 1]);
      }
    }
  }
}

// One block of KIND: rows row0 .. row0 + 63 (queries for DQ, keys for DK and
// DV), G output slabs a warpgroup at most, Y0 when warpgroup 0 also sums
// part of Y, tiles of T tokens. Maps: rx, ry the block's resident rows (A of
// X and Y; 64-row boxes), sx, sy the tile's streamed rows (B of X and Y;
// T-row boxes), sg the gradient product's streamed operand. Shared memory
// from a 1024-aligned base: barriers and statistics | resident X (qs slabs)
// | resident Y (vs slabs; unused by DV blocks) | hand-over (64 x T fp32) |
// ring 0 | ring 1.
template <int KIND, int G, bool Y0, int T>
__device__ __forceinline__ void block_body(const CUtensorMap* rx, const CUtensorMap* ry,
                                           const CUtensorMap* sx, const CUtensorMap* sy,
                                           const CUtensorMap* sg, int slice,
                                           const SingleParams& p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t bar_res = base;
  const uint32_t bar_full = base + 8;                       // [ring][stage]
  const uint32_t bar_empty = base + 8 + 8 * 2 * MAX_STAGES;  // [ring][stage]
  const uint32_t res_x = base + BARRIER_BYTES;
  const uint32_t res_y = res_x + p.qs * SLAB_BYTES;
  const uint32_t xchg = res_y + p.vs * SLAB_BYTES;
  const uint32_t ring0 = xchg + xchg_bytes(T);
  unsigned char* xchg_ptr = smem_raw + (xchg - raw);
  float* xf = reinterpret_cast<float*>(xchg_ptr);
  // dk/dv's per-column statistics of a tile: lse * log2 e, then D (after the barriers)
  float* stats = reinterpret_cast<float*>(smem_raw + (base + STATS_OFFSET - raw));

  const int row0 = blockIdx.x * SLAB;
  const int b = blockIdx.z;
  const int n_tiles = (p.n + T - 1) / T;
  // dq and DK blocks whose output slabs are all warpgroup 0's (q/k of one or
  // two slabs): its gradient product reads the X slabs of its contraction
  // again (K's for dq, Q's for dK), held in the ring, instead of new copies
  const bool reuse = KIND != KIND_DV && p.qs <= 2;
  // warp-uniform as far as the compiler can tell (a broadcast), so the
  // warpgroups' wgmma paths are not divergent ones: ptxas would serialize
  // every wgmma in a path it takes for divergent
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < 2 * MAX_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4);  // one arrival a warp of the ring's warpgroup
    }
    // [fences] the initialised barriers visible to the async proxy (TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else for the whole block: the roles never reconverge, so ptxas
  // honours setmaxnreg.
  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<24>();
    const int pt = threadIdx.x - 256;
    if (pt == 0 || pt == 32) {  // one thread a ring, in warps of their own
      const int w = pt / 32;
      if (w == 0) {
        const int ny = KIND == KIND_DV ? 0 : p.vs;
        mbar_expect_tx(bar_res, (p.qs + ny) * SLAB_BYTES);
        for (int c = 0; c < p.qs; ++c)
          tma_load(res_x + c * SLAB_BYTES, rx, bar_res, c * SLAB, 0, row0, b);
        for (int c = 0; c < ny; ++c)
          tma_load(res_y + c * SLAB_BYTES, ry, bar_res, c * SLAB, 0, row0, b);
      }
      const Work wk = work_of(KIND, w, slice, p);
      const uint32_t data = ring0 + w * p.stages * entry_bytes(T);
      const uint32_t full = bar_full + 8 * MAX_STAGES * w, empty = bar_empty + 8 * MAX_STAGES * w;
      int st = 0, ph = 0;
      auto put = [&](const CUtensorMap* map, int col, int t) {
        mbar_wait(empty + 8 * st, ph ^ 1);
        mbar_expect_tx(full + 8 * st, entry_bytes(T));
        // [ragged N] [columns] rows past N and columns past the width land
        // zero-filled (the barrier counts them)
        tma_load(data + st * entry_bytes(T), map, full + 8 * st, col, 0, t * T, b);
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      };
      // [ring] the consumer's order. Warpgroup 0 with `reuse`: Y's slabs,
      // then X's, which its gradient product reads again; warpgroup 1: the
      // contraction of tile t + 1 before the gradient product of tile t.
      auto contraction = [&](int t) {
        if (w == 0 && reuse) {
          for (int c = p.qs; c < wk.hi; ++c) put(sy, (c - p.qs) * SLAB, t);
          for (int c = 0; c < p.qs; ++c) put(sx, c * SLAB, t);
        } else {
          for (int c = wk.lo; c < wk.hi; ++c)
            put(c < p.qs ? sx : sy, (c < p.qs ? c : c - p.qs) * SLAB, t);
        }
      };
      auto gradient = [&](int t) {
        if (w == 0 && reuse) return;
        for (int j = 0; j < wk.gn; ++j) put(sg, (wk.g0 + j) * SLAB, t);
      };
      if (w == 1) contraction(0);
      for (int t = 0; t < n_tiles; ++t) {
        if (w == 0)
          contraction(t);
        else if (t + 1 < n_tiles)
          contraction(t + 1);
        gradient(t);
      }
    }
    return;
  }
  // ------------------------------ consumers -------------------------------
  setmaxnreg_inc<240>();
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x & 127;
  const int r0 = tid / 32 * 16 + (lane >> 2);  // rows r0, r0 + 8 of the block's 64
  const Work wk = work_of(KIND, wg, slice, p);
  const Ring ring{bar_full + 8 * MAX_STAGES * wg, bar_empty + 8 * MAX_STAGES * wg,
                  ring0 + wg * p.stages * entry_bytes(T), entry_bytes(T), p.stages};
  const float* lse_g = p.lse + static_cast<long long>(b) * p.n;
  const float* d_g = p.dcap + static_cast<long long>(b) * p.n;

  float acc[G][32];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  mbar_wait(bar_res, 0);
  int g = 0;  // this warpgroup's ring slabs consumed

  if (wg == 0) {
    // [ragged N] dq's per-row statistics, never read past N
    float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
    if (KIND == KIND_DQ) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r0 + 8 * h;
        rl[h] = row < p.n ? lse_g[row] * LOG2E : 0.f;
        rd[h] = row < p.n ? d_g[row] : 0.f;
      }
    }
    const int x_end = wk.hi < p.qs ? wk.hi : p.qs;  // DV: a = qs / 2 slabs, maybe none
    for (int t = 0; t < n_tiles; ++t) {
      // dk/dv: tile t's per-column statistics, T of lse * log2 e, then T of
      // D, loaded before the products and staged in shared memory for the
      // elementwise pass; [ragged N] never read past N
      float stat[T / 64];
#pragma unroll
      for (int j = 0; j < T / 64; ++j) {
        const int idx = tid + 128 * j, col = t * T + idx % T;
        stat[j] = 0.f;
        if (KIND != KIND_DQ && col < p.n)
          stat[j] = idx < T ? lse_g[col] * LOG2E : (KIND == KIND_DK ? d_g[col] : 0.f);
      }
      float x[T / 2], y[T / 2];
      int g_x = g;  // with `reuse`, X's slabs: held for the gradient product
      if (reuse) {
        if constexpr (Y0) contract<T>(y, res_y, p.qs, p.qs, wk.hi, ring, g);
        g_x = g;
        contract<T>(x, res_x, 0, 0, p.qs, ring, g, true);
      } else {
        contract<T>(x, res_x, 0, 0, x_end, ring, g);
        if constexpr (Y0) contract<T>(y, res_y, p.qs, p.qs, wk.hi, ring, g);
      }
      const bool own_x = x_end > 0;
#pragma unroll
      for (int j = 0; j < T / 64; ++j)
        if (KIND != KIND_DQ) stats[tid + 128 * j] = stat[j];  // read after the barrier below
      // [exchange] warpgroup 1's part: Y's rest (dq, DK) or X's (DV)
      named_sync(BAR_F_FULL);
      const float* part = xf + tid;
#pragma unroll
      for (int i = 0; i < T / 2; ++i) {
        const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const bool valid = t * T + c < p.n;  // [ragged N] a zero-filled token scores 0: P = 0
        const float lse_l = KIND == KIND_DQ ? rl[(i >> 1) & 1] : stats[c];
        const float dd = KIND == KIND_DQ ? rd[(i >> 1) & 1] : stats[T + c];
        const float other = part[i * 128];
        const float s = KIND == KIND_DV ? (own_x ? x[i] + other : other) : x[i];
        const float pv = valid ? fast_exp2(s * p.scale_log2 - lse_l) : 0.f;
        if (KIND == KIND_DV) {
          x[i] = pv;
        } else {
          const float dp = Y0 ? y[i] + other : other;
          x[i] = pv * (dp - dd) * p.scale;
        }
      }
      wg0_sync();  // [exchange] every part and statistic read before they are overwritten
      write_operand<T>(xchg_ptr, x, r0);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // [fences] for wgmma
      named_sync(BAR_B_FULL);
      grad_product<G, T>(acc, xchg, wk.gn, ring, reuse ? g_x : g);  // frees what it reads
      if (!reuse) g += wk.gn;
      if (t + 1 < n_tiles) named_arrive(BAR_F_EMPTY);  // hand-over buffer free again
    }
  } else {
    // warpgroup 1's slabs: all in X (DV) or in Y; it runs one contraction
    // ahead, tile t + 1's while warpgroup 0 forms tile t's operand
    const uint32_t res = KIND == KIND_DV ? res_x : res_y;
    const int cbase = KIND == KIND_DV ? 0 : p.qs;
    float part[T / 2];
    contract<T>(part, res, cbase, wk.lo, wk.hi, ring, g);
    for (int t = 0; t < n_tiles; ++t) {
      if (t > 0) named_sync(BAR_F_EMPTY);  // tile t - 1's operand read by both
#pragma unroll
      for (int i = 0; i < T / 2; ++i) xf[i * 128 + tid] = part[i];
      named_arrive(BAR_F_FULL);
      if (wk.gn == 0) named_arrive(BAR_B_FULL);  // nothing of tile t to wait for
      if (t + 1 < n_tiles) contract<T>(part, res, cbase, wk.lo, wk.hi, ring, g);
      if (wk.gn > 0) {
        named_sync(BAR_B_FULL);
        grad_product<G, T>(acc, xchg, wk.gn, ring, g);
        g += wk.gn;
      }
    }
  }

  __nv_bfloat16* out;
  long long row_stride;
  int width;
  if (KIND == KIND_DQ) {
    out = p.dq + static_cast<long long>(b) * p.dq_batch;
    row_stride = p.dq_row;
    width = p.dqk;
  } else if (KIND == KIND_DK) {
    out = p.dk + static_cast<long long>(b) * p.dk_batch;
    row_stride = p.dk_row;
    width = p.dqk;
  } else {
    out = p.dv + static_cast<long long>(b) * p.dv_batch;
    row_stride = p.dv_row;
    width = p.dv_width;
  }
  store_slabs<G>(acc, out, row_stride, row0 + r0, p.n, width, wk.g0, wk.gn);
}

// Grid (ceil(N / 64), 1, B): 64 query rows a block; Q and dO resident, the
// K and V slabs of each key tile of T streamed (K again for dQ += dS K).
template <int G, bool Y0, int T>
__global__ void __launch_bounds__(THREADS_SM90, 1)
    flash_bwd_dq_single_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo, const SingleParams p) {
  block_body<KIND_DQ, G, Y0, T>(&tq, &tdo, &tk, &tv, &tk, 0, p);
}

// Grid (ceil(N / 64), 1 + dv slices, B): 64 keys a block; blockIdx.y 0 the
// DK block (K and V resident; Q and dO streamed, Q again for dK += dS^T Q),
// blockIdx.y 1.. the DV blocks, one a slice of v (K resident; Q streamed for
// S^T, the slice's dO slabs for dV += P^T dO); query tiles of T.
template <int GK, int GV, bool Y0, int T>
__global__ void __launch_bounds__(THREADS_SM90, 1)
    flash_bwd_dkv_single_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo, const SingleParams p) {
  if (blockIdx.y == 0)
    block_body<KIND_DK, GK, Y0, T>(&tk, &tv, &tq, &tdo, &tq, 0, p);
  else
    block_body<KIND_DV, GV, false, T>(&tk, &tv, &tq, &tdo, &tdo, blockIdx.y - 1, p);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Dynamic shared memory of a plan (ops/attention_vjp.py::bwd_single_smem_bytes
// computes the same): alignment slack, barriers and statistics, the resident
// slabs of q/k and v, the hand-over, two rings of T-token entries.
int single_smem(int qs, int vs, int stages, int t) {
  return ALIGN + BARRIER_BYTES + (qs + vs) * SLAB_BYTES + xchg_bytes(t) +
         2 * stages * entry_bytes(t);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const CUtensorMap (&maps)[4], const SingleParams& p, dim3 grid,
                   int smem, cudaStream_t stream) {
  // per call, not cached: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS_SM90, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

// The instantiations, (output slabs a warpgroup, Y0, tile), the forms of
// the training sites: dark3 of phi 'n' (q/k 32, v 256: Y0 false) and 's'
// (64, 512) on tiles of 128, of phi 'm' (128, 1,024) on tiles of 64, the
// folded heads of 288 and 600 (three and five output slabs).
// ops/attention_vjp.py::SINGLE_BWD_FORMS lists the same.
template <int T>
cudaError_t run_dq(int g, bool y0, const CUtensorMap (&m)[4], const SingleParams& p, dim3 grid,
                   int smem, cudaStream_t s) {
  if (T == 128 && g == 1)
    return y0 ? launch(flash_bwd_dq_single_kernel<1, true, 128>, m, p, grid, smem, s)
              : launch(flash_bwd_dq_single_kernel<1, false, 128>, m, p, grid, smem, s);
  if (T == 64 && g == 2 && y0)
    return launch(flash_bwd_dq_single_kernel<2, true, 64>, m, p, grid, smem, s);
  if (T == 64 && g == 3 && !y0)
    return launch(flash_bwd_dq_single_kernel<3, false, 64>, m, p, grid, smem, s);
  if (T == 64 && g == 5 && !y0)
    return launch(flash_bwd_dq_single_kernel<5, false, 64>, m, p, grid, smem, s);
  return cudaErrorInvalidValue;
}

template <int T>
cudaError_t run_dkv(int gk, int gv, bool y0, const CUtensorMap (&m)[4], const SingleParams& p,
                    dim3 grid, int smem, cudaStream_t s) {
  if (T == 128 && gk == 1 && gv == 4 && y0)
    return launch(flash_bwd_dkv_single_kernel<1, 4, true, 128>, m, p, grid, smem, s);
  if (T == 128 && gk == 1 && gv == 2 && !y0)
    return launch(flash_bwd_dkv_single_kernel<1, 2, false, 128>, m, p, grid, smem, s);
  if (T == 64 && gk == 2 && gv == 4 && y0)
    return launch(flash_bwd_dkv_single_kernel<2, 4, true, 64>, m, p, grid, smem, s);
  if (T == 64 && gk == 3 && gv == 3 && !y0)
    return launch(flash_bwd_dkv_single_kernel<3, 3, false, 64>, m, p, grid, smem, s);
  if (T == 64 && gk == 5 && gv == 5 && !y0)
    return launch(flash_bwd_dkv_single_kernel<5, 5, false, 64>, m, p, grid, smem, s);
  return cudaErrorInvalidValue;
}

// Indices of a launch plan, ops/attention_vjp.py::bwd_single_sm90_plan.
enum {
  PLAN_ROWS,
  PLAN_SLAB,
  PLAN_QS,
  PLAN_VS,
  PLAN_SPLIT,
  PLAN_OUT_SLABS,
  PLAN_SLICES,
  PLAN_SLICE_SLABS,
  PLAN_STAGES,
  PLAN_TILE,
  PLAN_SMEM,
  PLAN_LEN
};

// The contraction slabs of warpgroup 0 (dq, DK blocks): all of X's and half
// of the rest less what its extra work is worth (the elementwise pass, about
// one slab, and the output slab it has more than warpgroup 1).
int split_of(int qs, int vs) {
  const int g0 = out_slabs_of(qs), g1 = qs - g0;
  const int half = (qs + vs - 1 - (g0 - g1)) / 2;
  return half > qs ? half : qs;
}

// The plan check both entry points share, recomputed from the widths: 64
// rows and 64-column slabs; `split_of` (v at least as wide as q/k); output
// slabs `out_slabs_of` for dq and dK; dk/dv's v in ceil(vs / 10) slices of
// equal slabs (dq: none); tiles of 64 or 128 tokens; 2 to MAX_STAGES stages
// a ring; the shared memory the plan names, as computed here, within the
// card's 227 KB.
bool plan_ok(const int* plan, int dqk, int dv, bool dkv) {
  const int qs = (dqk + SLAB - 1) / SLAB, vs = (dv + SLAB - 1) / SLAB;
  const int slices = dkv ? (vs + MAX_SLICE_SLABS - 1) / MAX_SLICE_SLABS : 0;
  const int slice_slabs = dkv ? (vs + slices - 1) / slices : 0;
  const int stages = plan[PLAN_STAGES], tile = plan[PLAN_TILE];
  const int smem = single_smem(qs, vs, stages, tile);
  return vs >= qs && (tile == 64 || tile == 128) && plan[PLAN_ROWS] == SLAB &&
         plan[PLAN_SLAB] == SLAB && plan[PLAN_QS] == qs &&
         plan[PLAN_VS] == vs && plan[PLAN_SPLIT] == split_of(qs, vs) &&
         plan[PLAN_OUT_SLABS] == out_slabs_of(qs) && plan[PLAN_OUT_SLABS] <= MAX_OUT_SLABS &&
         plan[PLAN_SLICES] == slices && plan[PLAN_SLICE_SLABS] == slice_slabs && stages >= 2 &&
         stages <= MAX_STAGES && plan[PLAN_SMEM] == smem && smem <= SMEM_LIMIT;
}

bool shape_ok(int batch, int n, int dqk, int dv) {
  return batch >= 1 && n >= 1 && dqk >= 8 && dv >= 8 && dqk % 8 == 0 && dv % 8 == 0;
}

// Four 4-D maps (q, k, v, dO as (B, N, width) views, one head) with boxes of
// 64 columns by 64 rows (the block's resident rows) or by `tile` rows (the
// streamed tiles: k and v for dq, q and dO for dk/dv); [columns] the inner
// dimension is the real width.
bool make_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
               const void* dO, int batch, int n, int dqk, int dv, const long long* strides,
               bool dkv, int tile) {
  const int qo = dkv ? tile : SLAB, kv = dkv ? SLAB : tile;
  return make_map(&m[0], q, dqk, 1, n, batch, strides[1], strides[0], qo) &&
         make_map(&m[1], k, dqk, 1, n, batch, strides[3], strides[2], kv) &&
         make_map(&m[2], v, dv, 1, n, batch, strides[5], strides[4], kv) &&
         make_map(&m[3], dO, dv, 1, n, batch, strides[7], strides[6], qo);
}

SingleParams params_of(const int* plan, const float* lse, const float* dcap, int n, int dqk,
                              int dv, float scale) {
  SingleParams p = {};
  p.lse = lse;
  p.dcap = dcap;
  p.n = n;
  p.dqk = dqk;
  p.dv_width = dv;
  p.qs = plan[PLAN_QS];
  p.vs = plan[PLAN_VS];
  p.split = plan[PLAN_SPLIT];
  p.slice_slabs = plan[PLAN_SLICE_SLABS];
  p.stages = plan[PLAN_STAGES];
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  return p;
}

}  // namespace

extern "C" {

// dq of the bf16 flash backward of one head, q/k width dqk and v width dv
// (multiples of 8): q, k, v, dO by pointer, their (batch, row) strides in
// elements in `strides` (q, k, v, dO: 8 values, 16-byte multiples), lse and
// dcap (B, N) fp32 contiguous, dq written through its batch and row strides.
// `plan` (PLAN_LEN ints) must be the one this library computes and has an
// instantiation for; anything else returns cudaErrorInvalidValue, as does a
// failed tensor-map encode. Returns the cudaError_t of the launch.
int flash_bwd_dq_single_sm90(const void* q, const void* k, const void* v, const void* dO,
                             const float* lse, const float* dcap, void* dq, int batch, int n,
                             int dqk, int dv, const long long* strides, long long dq_batch,
                             long long dq_row, float scale, const int* plan, void* stream) {
  if (!shape_ok(batch, n, dqk, dv) || !plan_ok(plan, dqk, dv, false))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  if (!make_maps(m, q, k, v, dO, batch, n, dqk, dv, strides, false, plan[PLAN_TILE]))
    return static_cast<int>(cudaErrorInvalidValue);
  SingleParams p = params_of(plan, lse, dcap, n, dqk, dv, scale);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_batch = dq_batch;
  p.dq_row = dq_row;
  const dim3 grid((n + SLAB - 1) / SLAB, 1, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool y0 = p.split > p.qs;
  return static_cast<int>(
      plan[PLAN_TILE] == 128
          ? run_dq<128>(plan[PLAN_OUT_SLABS], y0, m, p, grid, plan[PLAN_SMEM], s)
          : run_dq<64>(plan[PLAN_OUT_SLABS], y0, m, p, grid, plan[PLAN_SMEM], s));
}

// dk and dv of the same backward in one launch (the DK blocks and the DV
// slices' blocks), written through their strides. Arguments and plan as
// flash_bwd_dq_single_sm90.
int flash_bwd_dkv_single_sm90(const void* q, const void* k, const void* v, const void* dO,
                              const float* lse, const float* dcap, void* dk, void* dv_out,
                              int batch, int n, int dqk, int dv, const long long* strides,
                              long long dk_batch, long long dk_row, long long dv_batch,
                              long long dv_row, float scale, const int* plan, void* stream) {
  if (!shape_ok(batch, n, dqk, dv) || !plan_ok(plan, dqk, dv, true))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  if (!make_maps(m, q, k, v, dO, batch, n, dqk, dv, strides, true, plan[PLAN_TILE]))
    return static_cast<int>(cudaErrorInvalidValue);
  SingleParams p = params_of(plan, lse, dcap, n, dqk, dv, scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv_out);
  p.dk_batch = dk_batch;
  p.dk_row = dk_row;
  p.dv_batch = dv_batch;
  p.dv_row = dv_row;
  const int gv = (p.slice_slabs + 1) / 2;
  const dim3 grid((n + SLAB - 1) / SLAB, 1 + plan[PLAN_SLICES], batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool y0 = p.split > p.qs;
  return static_cast<int>(
      plan[PLAN_TILE] == 128
          ? run_dkv<128>(plan[PLAN_OUT_SLABS], gv, y0, m, p, grid, plan[PLAN_SMEM], s)
          : run_dkv<64>(plan[PLAN_OUT_SLABS], gv, y0, m, p, grid, plan[PLAN_SMEM], s));
}

}  // extern "C"
