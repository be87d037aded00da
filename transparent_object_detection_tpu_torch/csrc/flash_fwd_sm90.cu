// Flash-attention forward for Hopper (sm_90a), bf16, the packed multi-head
// form: wgmma fed by a TMA ring, one producer warpgroup and two consumer
// warpgroups a block.
//
// Replaces, for bf16 heads whose q/k and v widths are multiples of 64 (every
// packed site a route reaches: heads of 128 to 3,584, all multiples of 128):
//   * transparent_object_detection_tpu/ops/attention.py::_mha_flash_kernel
//     (flash_attention_mha_packed): serving, q/k/v read in place out of the
//     packed (B, N, 3C) qkv array, out (B, N, C);
//   * transparent_object_detection_tpu/ops/attention_vjp.py::_fwd_lse_kernel
//     (flash_fwd_lse), its packed multi-head form: training, the same kernel
//     with the lse store enabled, q/k/v given by pointer and strides (column
//     views of the qkv projection output).
// csrc/flash_attn_fwd.cu keeps the single-head and folded forms, fp32, and
// packed widths that are multiples of 8 but not of 64 (no route reaches
// those); ops/attention.py::packed_fwd_form states the rule.
//
// Arithmetic, that of flash_attn_fwd.cu and of the Pallas kernels, per query
// row i: s_ij = (q_i . k_j) * scale * log2(e) with q.k^T accumulated in fp32;
// an exp2-domain online softmax whose running max starts at -1e30; p_ij =
// exp2(s_ij - m) rounded to bf16 before P.V; l and acc in fp32; out = acc *
// (1 / l) in bf16; with lse, lse_i = (m + log2 l) * ln 2 in fp32, one per
// (batch, head, row). The key tile (128 or 64) and v slice sizes only change
// the order of fp32 sums.
//
// Bound. 2 * N^2 * (dqk + dv) operations a (batch, head) against a few tens
// of MB of inputs and outputs: the tensor cores bound it (phi='s' 640x640
// batch 2, h1 + h2 + h4: 0.58 ms at the data sheet's 989 TFLOP/s bf16).
//
// Design.
//   * TMA loads. One thread of the producer warpgroup loads Q once (heads up
//     to 384 wide stay resident: 128 rows x 384 x 2 = 96 KB), then, per key
//     tile, K in 64-column slabs through a ring of `stages` slabs (wider
//     heads: each stage also carries the matching 64-column Q slab) and V
//     (the block's v columns) through a 2-stage ring, each stage guarded by
//     a full and an empty mbarrier. Every TMA box is 64 columns (128 bytes)
//     wide with the 128-byte swizzle, the layout wgmma reads.
//   * S = Q K^T: each consumer warpgroup owns 64 query rows and issues
//     wgmma m64nKTk16 (KT, the key tile: 128 for v slices up to 128, else 64)
//     with both operands in shared memory (K-major), four a 64-column slab,
//     keeping one slab's group in flight while the next is issued and
//     releasing each stage as its group retires.
//   * The online softmax runs on the S accumulator in registers; P is
//     converted to bf16 in place: the accumulator layout of m64nKT is the A
//     register layout of the next product.
//   * O += P V: wgmma m64nDVk16 with A = P from registers (the RS form) and
//     B = V straight from shared memory with the transpose bit (MN-major,
//     which bf16 allows): no ldmatrix.trans and no shared-memory transpose.
//   * setmaxnreg gives the consumers 240 registers (O alone is DV / 2 fp32
//     registers a thread: 128 at DV 256) and the producer 24.
//   * Heads wider than 256 and up to 512 (phi='m' 384): the split form,
//     64-row blocks whose two warpgroups share one S; warpgroup 0 computes
//     S and the softmax and hands P (bf16, swizzled as TMA would) and the
//     row rescale to warpgroup 1 through shared memory; each runs P V on
//     its half of v (192 at 384). Wider heads: v in 256-column slices
//     across 128-row blocks, each recomputing S. The split is taken by
//     measurement at phi='m' 8 x 384 (PERF.md; kernels/time_serving.py
//     --wide-heads times both forms).
//   Tried and dropped, slower on the H100 at phi='s' h2: S of tile t + 1
//   issued before the softmax of tile t, or the softmax of tile t under
//   P V of tile t - 1 (each leaves a wgmma group in flight across the
//   softmax, and ptxas then serializes every wgmma of the kernel, C7513);
//   and the two warpgroups taking turns on S through named barriers.
//
// Trouble spots, each handled where its tag appears below:
//   [ragged N]    keys and query rows past N
//   [columns]     boxes that would run past a head inside the packed array
//   [tensor maps] the driver call, the parameter space, alignment
//   [lse]         the contract with the backward
//   [small grids] rows a block against the card's 132 SMs
//   [fences]      wgmma fences, groups and mbarrier phases
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace flash;
using namespace sm90;

// [small grids] 128 rows a block (two consumer warpgroups sharing each K/V
// tile) halves the L2 traffic of 64-row blocks, at one block an SM (the
// shared memory). phi='s' h4 at batch 1 is 78 blocks on 132 SMs, at batch 2
// 156 (1.18 waves); kernels/time_serving.py times each site at batch 1 and
// 2 against the mma_sync template's (PERF.md: faster at both).
constexpr int BM = 128;            // query rows a block
constexpr int SLAB = 64;           // q/k columns a ring stage (one 128-byte swizzle row)
constexpr int CONSUMERS = 2;       // consumer warpgroups, 64 rows each
constexpr int THREADS_SM90 = 128 * (CONSUMERS + 1);
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
constexpr int ALIGN = 1024;         // a swizzle atom: 8 rows of 128 bytes
constexpr int BARRIER_BYTES = 1024;
constexpr int ROW_BYTES = SLAB * 2;  // one row of a box

// Named barriers of the split form (sm90_common.cuh's named_sync and
// named_arrive): P_FULL, P_EMPTY two buffers each, then the row sums.
enum { BAR_P_FULL = 1, BAR_P_EMPTY = 3, BAR_L = 5 };

struct Sm90Params {
  __nv_bfloat16* o;  // (B, N, heads * dv)
  float* lse;        // (B, heads, N), or null (serving)
  int n, heads, dqk, dv;
  int slabs;         // dqk / SLAB
  int dv_splits;     // v slices a head, one a block
  int stages;        // K ring stages
  int q_resident;    // Q loaded once (else a Q slab in every K stage)
  float scale_log2;  // scale * log2(e)
};

// d[96] += A (64x16, smem, K-major) * B (16x192, smem, MN-major)
__device__ __forceinline__ void wgmma_sst_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// d[128] += A (64x16, smem, K-major) * B (16x256, smem, MN-major)
__device__ __forceinline__ void wgmma_sst_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d[64] = A (64x16, smem, K-major) * B (128x16, smem, K-major) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int KT>
__device__ __forceinline__ void wgmma_ss(float (&d)[KT / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (KT == 64) wgmma_ss_n64(d, da, db, scale_d);
  if constexpr (KT == 128) wgmma_ss_n128(d, da, db, scale_d);
}

template <int DV>
__device__ __forceinline__ void wgmma_sst(float (&d)[DV / 2], uint64_t da, uint64_t db) {
  if constexpr (DV == 192) wgmma_sst_n192(d, da, db);
  if constexpr (DV == 256) wgmma_sst_n256(d, da, db);
}

template <int DV>
__device__ __forceinline__ void wgmma_rs(float (&d)[DV / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DV == 64) wgmma_rs_n64(d, a, db);
  if constexpr (DV == 128) wgmma_rs_n128(d, a, db);
  if constexpr (DV == 192) wgmma_rs_n192(d, a, db);
  if constexpr (DV == 256) wgmma_rs_n256(d, a, db);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Grid (ceil(N / rows), heads * dv_splits, B); block: consumer warpgroups 0
// and 1, producer warpgroup 2. Sliced form (SPLIT false): 128 rows, the
// consumers own rows 0-63 and 64-127 of the block's v slice. Split form
// (SPLIT true): 64 rows, both consumers on the same rows, warpgroup 0 on v
// columns [0, DV) and warpgroup 1 on [DV, 2 DV) of the head. Shared memory,
// from a 1024-aligned base: barriers (and the split form's row rescale and
// row sums) | Q (resident form) | K ring | V ring | P (split form).
template <int DV, bool SPLIT, int KT>
__global__ void __launch_bounds__(THREADS_SM90, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Sm90Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int ROWS = SPLIT ? 64 : BM;
  constexpr int V_BOXES = (SPLIT ? 2 : 1) * DV / SLAB;
  constexpr uint32_t V_BYTES = V_BOXES * KT * ROW_BYTES;
  constexpr uint32_t P_BYTES = 64 * KT * 2;
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t bar_q = base;
  const uint32_t bar_kfull = base + 8, bar_kempty = bar_kfull + 8 * MAX_STAGES;
  const uint32_t bar_vfull = bar_kempty + 8 * MAX_STAGES, bar_vempty = bar_vfull + 16;
  // split form: the row rescale of two tiles and the final row sums
  float* corr_s = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + 256);
  float* l_s = corr_s + 2 * 64;
  const uint32_t q_smem = base + BARRIER_BYTES;
  const uint32_t q_bytes = p.q_resident ? p.slabs * ROWS * ROW_BYTES : 0;
  const uint32_t stage_bytes = KT * ROW_BYTES + (p.q_resident ? 0 : ROWS * ROW_BYTES);
  const uint32_t k_smem = q_smem + q_bytes;
  const uint32_t v_smem = k_smem + p.stages * stage_bytes;
  const uint32_t p_smem = v_smem + 2 * V_BYTES;

  const int m0 = blockIdx.x * ROWS;
  const int head = blockIdx.y / p.dv_splits;
  const int split = blockIdx.y % p.dv_splits;
  const int b = blockIdx.z;
  const int n_tiles = (p.n + KT - 1) / KT;
  const int wg = threadIdx.x / 128;
  // the split form's K and Q are read by warpgroup 0 alone
  constexpr int K_READERS = (SPLIT ? 1 : CONSUMERS) * 4;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar_kfull + 8 * s, 1);
      mbar_init(bar_kempty + 8 * s, K_READERS);  // one arrival a reading warp
    }
    for (int s = 0; s < 2; ++s) {
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
      if (p.q_resident) {
        mbar_expect_tx(bar_q, q_bytes);
        for (int c = 0; c < p.slabs; ++c)
          tma_load(q_smem + c * ROWS * ROW_BYTES, &tq, bar_q, c * SLAB, head, m0, b);
      }
      int st = 0, ph = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int c = 0; c < p.slabs; ++c) {
          mbar_wait(bar_kempty + 8 * st, ph ^ 1);
          const uint32_t dst = k_smem + st * stage_bytes;
          mbar_expect_tx(bar_kfull + 8 * st, stage_bytes);
          tma_load(dst, &tk, bar_kfull + 8 * st, c * SLAB, head, t * KT, b);
          if (!p.q_resident) tma_load(dst + KT * ROW_BYTES, &tq, bar_kfull + 8 * st, c * SLAB,
                                      head, m0, b);
          if (++st == p.stages) {
            st = 0;
            ph ^= 1;
          }
        }
        const int vs = t & 1;
        mbar_wait(bar_vempty + 8 * vs, ((t >> 1) & 1) ^ 1);
        mbar_expect_tx(bar_vfull + 8 * vs, V_BYTES);
        // [columns] a slice past dv (the last slice of a width that is not
        // a multiple of DV) reads zero-filled columns, not the next head's
        for (int c = 0; c < V_BOXES; ++c)
          tma_load(v_smem + vs * V_BYTES + c * KT * ROW_BYTES, &tv, bar_vfull + 8 * vs,
                   split * DV + c * SLAB, head, t * KT, b);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const uint32_t q_rows = SPLIT ? 0 : wg * 64 * ROW_BYTES;  // this warpgroup's rows in Q
    const uint32_t v_half = SPLIT ? wg * (DV / SLAB) * KT * ROW_BYTES : 0;
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-1e30f, -1e30f};
    float l_run[2] = {0.f, 0.f};  // this thread's share, summed over the quad at the end
    const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the 64
    int st = 0, ph = 0;  // K ring position
    if (p.q_resident && (!SPLIT || wg == 0)) mbar_wait(bar_q, 0);  // Q has landed

    // S = Q K^T of one tile, slab `c` of it, into acc (the first slab
    // overwrites acc: scale-d 0)
    auto issue_slab = [&](float(&acc)[KT / 2], int c) {
      mbar_wait(bar_kfull + 8 * st, ph);
      const uint32_t kb = k_smem + st * stage_bytes;
      const uint32_t qb =
          (p.q_resident ? q_smem + c * ROWS * ROW_BYTES : kb + KT * ROW_BYTES) + q_rows;
      wgmma_fence();  // [fences] before the first wgmma that touches acc
#pragma unroll
      for (int kk = 0; kk < SLAB / 16; ++kk)
        wgmma_ss<KT>(acc, desc_sw128(qb + kk * 32, 16, 1024), desc_sw128(kb + kk * 32, 16, 1024),
                     c > 0 || kk > 0);
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
    };
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

    // online softmax of tile t in the exp2 domain on the accumulator, P in
    // bf16 into pa: s[4i + e] is row r0 + 8 * (e / 2), key 8i + 2 * (lane % 4)
    // + e % 2; key block kk of pa is the accumulator's 8-key chunks 2kk and
    // 2kk + 1 (the A register layout of m64k16)
    auto softmax = [&](float(&s)[KT / 2], int t, uint32_t(&pa)[KT / 16][4], float(&corr)[2]) {
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
      for (int i = 0; i < KT / 2; ++i) {
        const float pe = fast_exp2(s[i] - m_run[(i >> 1) & 1]);
        s[i] = pe;
        l_run[(i >> 1) & 1] += pe;
      }
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // split form: hand P(t) (bf16, 64 rows x KT keys, laid out as TMA's
    // 128-byte swizzle lays a K-major tile: 16-byte chunk c of a row at
    // chunk c ^ (row % 8)) and the row rescale to warpgroup 1
    auto handoff = [&](int t, const uint32_t(&pa)[KT / 16][4], const float(&corr)[2]) {
      const int pb = t & 1;
      if (t >= 2) named_sync(BAR_P_EMPTY + pb);  // warpgroup 1 is done with P(t - 2)
      unsigned char* pt = smem_raw + (p_smem - smem_u32(smem_raw)) + pb * P_BYTES;
      const int sw = r0 & 7, col = 4 * (lane & 3);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // rows r0 (j even), r0 + 8; chunks 2kk, 2kk + 1
          const int row = r0 + 8 * (j & 1), chunk = 2 * (kk % 4) + (j >> 1);
          *reinterpret_cast<uint32_t*>(pt + (kk / 4) * 64 * ROW_BYTES + row * ROW_BYTES +
                                       ((chunk ^ sw) << 4) + col) = pa[kk][j];
        }
      }
      if ((lane & 3) == 0) {
        corr_s[pb * 64 + r0] = corr[0];
        corr_s[pb * 64 + r0 + 8] = corr[1];
      }
      // [fences] the generic-proxy stores visible to warpgroup 1's wgmma
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_arrive(BAR_P_FULL + pb);
    };
    // O += P(t) V(t), issued and committed, not waited for
    auto issue_pv = [&](int t, const uint32_t(&pa)[KT / 16][4]) {
      mbar_wait(bar_vfull + 8 * (t & 1), (t >> 1) & 1);
      const uint32_t vb = v_smem + (t & 1) * V_BYTES;
      wgmma_fence();  // [fences] o and pa were written by ordinary instructions
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_rs<DV>(o, pa[kk], desc_sw128(vb + kk * 16 * ROW_BYTES, KT * ROW_BYTES, 1024));
      wgmma_commit();
    };

    if (!SPLIT || wg == 0) {
      // Tile by tile: S slab by slab with one slab's group in flight while
      // the next is issued, each stage released as its group retires; then
      // the softmax, then P V. (A group left in flight across the softmax
      // makes ptxas serialize every wgmma of the kernel, C7513: the softmax
      // writes registers that later wgmmas read.)
      for (int t = 0; t < n_tiles; ++t) {
        float s[KT / 2];
        int prev = -1;
        for (int c = 0; c < p.slabs; ++c) {
          const int cur = st;
          issue_slab(s, c);
          wgmma_commit();
          if (prev >= 0) {
            wgmma_wait<1>();
            release(bar_kempty + 8 * prev);
          }
          prev = cur;
        }
        wgmma_wait<0>();
        release(bar_kempty + 8 * prev);
        uint32_t pa[KT / 16][4];
        float corr[2];
        softmax(s, t, pa, corr);
        rescale(corr);
        if (SPLIT) handoff(t, pa, corr);
        issue_pv(t, pa);
        wgmma_wait<0>();
        release(bar_vempty + 8 * (t & 1));
      }
    } else if constexpr (SPLIT) {
      // warpgroup 1: O += P V on the second half, P from shared memory
      for (int t = 0; t < n_tiles; ++t) {
        const int pb = t & 1;
        named_sync(BAR_P_FULL + pb);
        const float corr[2] = {corr_s[pb * 64 + r0], corr_s[pb * 64 + r0 + 8]};
        rescale(corr);
        mbar_wait(bar_vfull + 8 * pb, (t >> 1) & 1);
        const uint32_t pt = p_smem + pb * P_BYTES;
        const uint32_t vb = v_smem + pb * V_BYTES + v_half;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          wgmma_sst<DV>(o, desc_sw128(pt + (kk / 4) * 64 * ROW_BYTES + (kk % 4) * 32, 16, 1024),
                        desc_sw128(vb + kk * 16 * ROW_BYTES, KT * ROW_BYTES, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        if (t + 2 < n_tiles) named_arrive(BAR_P_EMPTY + pb);  // one arrival a sync
        release(bar_vempty + 8 * pb);
      }
    }

    // out = acc / l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 2);
    }
    if (SPLIT) {  // warpgroup 1 takes the row sums of warpgroup 0
      if (wg == 0) {
        if ((lane & 3) == 0) {
          l_s[r0] = l_run[0];
          l_s[r0 + 8] = l_run[1];
        }
        named_arrive(BAR_L);
      } else {
        named_sync(BAR_L);
        l_run[0] = l_s[r0];
        l_run[1] = l_s[r0 + 8];
      }
    }
    const int row0 = m0 + (SPLIT ? 0 : wg * 64) + r0;
    const int rows[2] = {row0, row0 + 8};
    // [lse] the natural-log logsumexp of the scaled scores, (m + log2 l) *
    // ln 2, written once a row: by the first v slice (every slice computes
    // the same m and l) and, split, by warpgroup 0, which owns m; the
    // backward (flash_attn_bwd.cu) recomputes P from it
    if (p.lse != nullptr && split == 0 && (!SPLIT || wg == 0) && (lane & 3) == 0) {
      float* lse = p.lse + (static_cast<long long>(b) * p.heads + head) * p.n;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < p.n) lse[rows[r]] = (m_run[r] + log2f(l_run[r])) * LN2;
    }
    const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
    const long long o_row = static_cast<long long>(p.heads) * p.dv;
    const int col0 = (SPLIT ? wg : split) * DV;  // this warpgroup's first v column
    __nv_bfloat16* og = p.o + static_cast<long long>(b) * p.n * o_row + head * p.dv + col0;
    const int v_cols = p.dv - col0;  // valid columns from col0
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int col = 8 * i + 2 * (lane & 3);
      if (col >= v_cols) continue;  // dv is a multiple of 64: the pair is whole
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // [ragged N] query rows past N were computed on zero-filled q and
        // are not stored
        if (rows[r] < p.n)
          *reinterpret_cast<__nv_bfloat162*>(og + rows[r] * o_row + col) =
              __floats2bfloat162_rn(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Dynamic shared memory of a plan: alignment slack, barriers, Q (resident
// form), the K ring (each stage with a Q slab in the streamed form), the V
// ring (both halves in the split form), P (split form, two tiles).
// ops/attention.py::sm90_smem_bytes computes the same.
int plan_smem(int dqk, int keys, int v_slice, int stages, int q_resident, int wg_split) {
  const int rows = wg_split ? 64 : BM;
  const int stage = keys * ROW_BYTES + (q_resident ? 0 : rows * ROW_BYTES);
  return ALIGN + BARRIER_BYTES + (q_resident ? rows * dqk * 2 : 0) + stages * stage +
         2 * (wg_split ? 2 : 1) * v_slice * keys * 2 + (wg_split ? 2 * 64 * keys * 2 : 0);
}

template <int DV, bool SPLIT, int KT>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Sm90Params& p, int batch, int smem, cudaStream_t stream) {
  // per call, not cached: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DV, SPLIT, KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = SPLIT ? 64 : BM;
  const dim3 grid((p.n + rows - 1) / rows, p.heads * p.dv_splits, batch);
  flash_fwd_sm90_kernel<DV, SPLIT, KT><<<grid, THREADS_SM90, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// The instantiations, one a plan the rule picks: sliced v slices up to 128
// on 128-key tiles, 192 and 256 on 64-key tiles (the S accumulator of
// 128 keys no longer fits beside O); the split form on 64-key tiles.
cudaError_t launch_plan(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                        const Sm90Params& p, int batch, int smem, int v_slice, int wg_split,
                        cudaStream_t st) {
  if (wg_split)
    return v_slice == 192 ? launch<192, true, 64>(tq, tk, tv, p, batch, smem, st)
                          : launch<256, true, 64>(tq, tk, tv, p, batch, smem, st);
  switch (v_slice) {
    case 64: return launch<64, false, 128>(tq, tk, tv, p, batch, smem, st);
    case 128: return launch<128, false, 128>(tq, tk, tv, p, batch, smem, st);
    case 192: return launch<192, false, 64>(tq, tk, tv, p, batch, smem, st);
    default: return launch<256, false, 64>(tq, tk, tv, p, batch, smem, st);
  }
}

}  // namespace

extern "C" {

// Indices of the launch plan, ops/attention.py::sm90_plan.
enum { PLAN_ROWS, PLAN_KEYS, PLAN_SLAB, PLAN_V_SLICE, PLAN_STAGES, PLAN_Q_RESIDENT,
       PLAN_DV_SPLITS, PLAN_WG_SPLIT, PLAN_SMEM, PLAN_LEN };

// bf16 forward of `heads` packed heads: q, k (B, N, heads * dqk) and v (B, N,
// heads * dv) given by pointer, batch stride and row stride in elements (head
// h at column h * dqk or h * dv; the packed qkv's sections are such views)
// -> out (B, N, heads * dv) bf16 contiguous, and with lse non-null lse (B,
// heads, N) fp32. `plan` (PLAN_LEN ints) must be one this library was built
// for: 64-column slabs; either v in dv_splits slices of 64, 128, 192 or 256
// columns across blocks of 128 rows (wg_split 0; 128-key tiles for slices
// up to 128, else 64), or (wg_split 1, one slice, 64-key tiles) v split
// between the two consumer warpgroups of a 64-row block, 192 or 256 columns
// each, q resident; 1-8 stages; the shared memory it needs within the
// card's 227 KB. Anything else returns
// cudaErrorInvalidValue, as does a failed tensor-map encode.
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* out, float* lse,
                   int batch, int n, int heads, int dqk, int dv, long long q_batch,
                   long long q_row, long long k_batch, long long k_row, long long v_batch,
                   long long v_row, float scale, const int* plan, void* stream) {
  const int vs = plan[PLAN_V_SLICE], stages = plan[PLAN_STAGES], splits = plan[PLAN_DV_SPLITS];
  const int q_res = plan[PLAN_Q_RESIDENT], wg_split = plan[PLAN_WG_SPLIT];
  const int smem = plan[PLAN_SMEM], keys = plan[PLAN_KEYS];
  const int cover = (wg_split ? 2 : 1) * vs;  // v columns a block covers
  const bool sliced_ok = wg_split == 0 && plan[PLAN_ROWS] == BM &&
                         (vs == 64 || vs == 128 || vs == 192 || vs == 256);
  const bool split_ok = wg_split == 1 && plan[PLAN_ROWS] == 64 && (vs == 192 || vs == 256) &&
                        q_res == 1 && splits == 1;
  const bool keys_ok = keys == (!wg_split && vs <= 128 ? 128 : 64);
  if (!(sliced_ok || split_ok) || !keys_ok || plan[PLAN_SLAB] != SLAB ||
      stages < 1 || stages > MAX_STAGES || (q_res != 0 && q_res != 1) || batch < 1 || n < 1 ||
      heads < 1 || dqk < SLAB || dqk % SLAB || dv < SLAB || dv % SLAB || splits < 1 ||
      splits * cover < dv || (splits - 1) * cover >= dv || (wg_split && vs >= dv) ||
      smem != plan_smem(dqk, keys, vs, stages, q_res, wg_split) || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, dqk, heads, n, batch, q_row, q_batch, plan[PLAN_ROWS]) ||
      !make_map(&tk, k, dqk, heads, n, batch, k_row, k_batch, keys) ||
      !make_map(&tv, v, dv, heads, n, batch, v_row, v_batch, keys))
    return static_cast<int>(cudaErrorInvalidValue);
  Sm90Params p;
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  p.n = n;
  p.heads = heads;
  p.dqk = dqk;
  p.dv = dv;
  p.slabs = dqk / SLAB;
  p.dv_splits = splits;
  p.stages = stages;
  p.q_resident = q_res;
  p.scale_log2 = scale * LOG2E;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_plan(tq, tk, tv, p, batch, smem, vs, wg_split, st));
}

}  // extern "C"
