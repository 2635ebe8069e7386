// K4: good-window flags of the eref reference scan, bit-packed.  Replaces
// good_windows_pallas (palace_tpu/ops/pallas_kernels.py) and, on Phase B's
// path, its XLA twin good_windows_batch (palace_tpu/ops/window.py).
//
// Per row and position j: a coder hits when its count equals least_depth
// and its hash is not 0; single = at least one of the 3 coders hits, trio =
// all 3 hit.  Both are summed over the `window` positions ending at j
// (positions before 0 count as misses: the reference's growing prefix for
// j < window), and j is good when single_sum >= one_min and trio_sum >=
// three_min.  Output: bit j % 8 of byte j / 8, little-endian.
//
// Bound on the H100: bytes.  Per position 3 B of counts and 24 B of int64
// hashes are read and 1/8 B written; the integer work is a few operations.
// The TPU kernel walks its tiles in order and carries the previous `window`
// indicators in VMEM; Hopper's blocks run in no order, so each block (one
// row, kTile positions) reads the `window` positions before its tile again
// (window / kTile more bytes, 24 % at window 500) and needs nothing from
// any other block.  The block
//   1. loads the indicators of [t0 - window, t0 + kTile) into shared memory
//      as (trio << 16) | single, neighbouring threads on neighbouring
//      positions, so one scan serves both sums;
//   2. scans them in place: kItems consecutive entries a thread, warp
//      shuffles, then the 8 warp totals;
//   3. takes win[j] = cs[window + j] - cs[j] and packs 32 flags a warp with
//      __ballot_sync, lanes 0-3 storing its four bytes.
// Sums stay below kTile + window < 65536, so the two 16-bit fields never
// carry into each other.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // entries scanned a pass
constexpr int kTile = 2048;                // positions a block

__global__ void __launch_bounds__(kThreads) good_windows_kernel(
    const uint8_t* __restrict__ counts, const int64_t* __restrict__ hashes,
    uint8_t* __restrict__ out, int L, int window, int one_min, int three_min,
    int least_depth) {
  extern __shared__ int cs[];  // kTile + window entries
  __shared__ int warp_sums[kWarps];
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int n_ext = kTile + window;
  const long long ext0 = (long long)t0 - window;  // position of entry 0
  const size_t row_off = (size_t)row * L;

  // 1. indicators of the extended range
  for (int i = threadIdx.x; i < n_ext; i += kThreads) {
    const long long pos = ext0 + i;
    int v = 0;
    if (pos >= 0 && pos < L) {
      const size_t e = (row_off + (size_t)pos) * 3;
      int n = 0;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        n += (counts[e + c] == least_depth) & (hashes[e + c] != 0);
      v = (n > 0 ? 1 : 0) | (n == 3 ? 1 << 16 : 0);
    }
    cs[i] = v;
  }
  __syncthreads();

  // 2. inclusive scan of cs[0, n_ext) in passes of kChunk entries
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int c0 = 0; c0 < n_ext; c0 += kChunk) {
    const int base = c0 + threadIdx.x * kItems;
    int local[kItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      sum += (base + k < n_ext) ? cs[base + k] : 0;
      local[k] = sum;
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = carry, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_sums[w];
      total += warp_sums[w];
    }
    before += incl - sum;  // the exclusive prefix of this thread
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (base + k < n_ext) cs[base + k] = local[k] + before;
    carry += total;
    __syncthreads();  // cs written and warp_sums read before the next pass
  }

  // 3. windowed sums, thresholds, 32 flags a warp
  uint8_t* orow = out + (size_t)row * (L / 8);
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int pos = t0 + j;
    bool good = false;
    if (pos < L) {
      const int w = cs[window + j] - cs[j];
      good = (w & 0xffff) >= one_min && (w >> 16) >= three_min;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, good);
    const int p0 = pos - lane;  // a multiple of 32
    if (lane < 4 && p0 + 8 * lane < L) orow[p0 / 8 + lane] = (uint8_t)(bits >> (8 * lane));
  }
}

}  // namespace

extern "C" int palace_good_windows(const void* counts, const void* hashes, void* out,
                                   int NB, int L, int window, int one_min, int three_min,
                                   int least_depth, void* stream) {
  const int smem = (kTile + window) * (int)sizeof(int);
  if (smem > 47 * 1024) {  // beyond the 48 KiB default, with the static warp_sums
    cudaError_t err = cudaFuncSetAttribute(
        good_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((L + kTile - 1) / kTile, NB);
  good_windows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)counts, (const int64_t*)hashes, (uint8_t*)out, L, window, one_min,
      three_min, least_depth);
  return (int)cudaGetLastError();
}
