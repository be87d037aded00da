// Exact greedy NMS for Hopper (sm_90a): the keep set of torchvision's nms
// over score-sorted candidates, one block an image, with no host read.
//
// Replaces no Pallas kernel. The JAX package computes this function as a
// `lax.fori_loop` inside its compiled serving program
// (transparent_object_detection_tpu/ops/nms.py::_exact_greedy_keep). Run
// eagerly, that loop is K steps of a few launches each, bounded by a count
// the host must read; captured literally, it would put ~4 x 1,024 tiny
// kernels into the serving graph. Here the loop runs on the device, bounded
// by the device's own count of valid rows, in one launch.
//
// Function (ops/nms.py::nms_exact_plain, bit for bit): iou (B, K, K) fp32,
// valid (B, K) bool, valid rows first in each image (the candidates sorted
// by score) -> keep (B, K) bool. Row i, taken in order, is alive if it is
// valid and no alive row before it removed it; an alive row removes every
// later row j with iou[i][j] > thres (fp32 compare, as PyTorch compares a
// fp32 tensor with a Python float). A box removed by a removed box stays.
//
// Design, one block of 1,024 threads an image (K <= 1,024):
//   pass 0: thread t holds candidate t; a ballot gives the valid bits, the
//           block's barrier count the number of valid rows, `count`;
//   pass 1: each warp takes rows i < count and forms the row's over-threshold
//           bitmask of columns j > i in shared memory, K x K/32 words
//           (128 KB at K = 1,024): 32 lanes read 32 neighbouring columns,
//           16 words' loads in flight before their ballots; the words left
//           of the diagonal are zero and not read;
//   pass 2: warp 0 scans rows 0..count-1: lane w holds removed-word w; row
//           i's removed bit is broadcast from lane i/32, and an alive row
//           ORs its mask row in and sets its kept bit. Rows past count are
//           never scanned and never kept.
// Bound: bytes. The function needs the IoU entries above the diagonal of the
// valid rows (count x K x 4 bytes at most; 4 MB an image at K = 1,024) and
// valid and keep once; the scan's count steps are a chain of shared-memory
// reads and shuffles, ~30 cycles a row.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 1024;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WORDS = MAX_K / 32;
constexpr int UNROLL = 16;  // mask words whose loads a lane has in flight

__global__ void __launch_bounds__(THREADS, 1)
nms_exact_kernel(const float* __restrict__ iou, const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep, int k, float thres) {
  extern __shared__ uint32_t over[];  // row i, word w: bit t set iff j = 32w + t > i, iou > thres
  __shared__ uint32_t valid_bits[MAX_WORDS];
  __shared__ uint32_t kept_bits[MAX_WORDS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int words = (k + 31) >> 5;
  const size_t image = blockIdx.x;

  // pass 0: valid bits and the count of valid rows
  const bool v = t < k && valid[image * k + t] != 0;
  const uint32_t vw = __ballot_sync(0xffffffffu, v);
  if (lane == 0 && warp < words) valid_bits[warp] = vw;
  const int count = __syncthreads_count(v);

  // pass 1: the over-threshold bitmask of the rows the scan visits
  const float* rows = iou + image * k * k;
  for (int i = warp; i < count; i += WARPS) {
    const float* row = rows + (size_t)i * k;
    uint32_t* dst = over + i * words;
    const int first = (i + 1) >> 5;  // words before it hold columns j <= i only
    for (int w = lane; w < first; w += 32) dst[w] = 0u;
    for (int w0 = first; w0 < words; w0 += UNROLL) {
      float x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = ((w0 + u) << 5) + lane;
        x[u] = (w0 + u < words && j > i && j < k) ? row[j] : -CUDART_INF_F;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uint32_t bits = __ballot_sync(0xffffffffu, x[u] > thres);
        if (lane == 0 && w0 + u < words) dst[w0 + u] = bits;
      }
    }
  }
  __syncthreads();

  // pass 2: the greedy scan, one warp
  if (warp == 0) {
    uint32_t removed = 0u, kept = 0u;  // lane w: word w
    const uint32_t* mine = over + lane;
    for (int i = 0; i < count; ++i) {
      const int w = i >> 5;
      const uint32_t bit = 1u << (i & 31);
      const uint32_t m = lane < words ? mine[i * words] : 0u;  // issued before the chain
      const uint32_t r = __shfl_sync(0xffffffffu, removed, w);
      if ((valid_bits[w] & bit) && !(r & bit)) {  // alive: the same on every lane
        removed |= m;
        if (lane == w) kept |= bit;
      }
    }
    if (lane < words) kept_bits[lane] = kept;
  }
  __syncthreads();
  if (t < k) keep[image * k + t] = (kept_bits[t >> 5] >> (t & 31)) & 1u;
}

}  // namespace

extern "C" {

// iou fp32 (batch, k, k), valid and keep bool (batch, k), all contiguous;
// k <= 1,024, else cudaErrorInvalidValue. Launches on `stream` and returns
// the launch's error code.
int nms_exact(const void* iou, const void* valid, void* keep, int batch, int k, float thres,
              void* stream) {
  if (batch < 0 || k < 0 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || k == 0) return static_cast<int>(cudaSuccess);
  const int smem = k * ((k + 31) / 32) * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(nms_exact_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_exact_kernel<<<batch, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thres);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
