// K3: one layer of the scorer's conv head — Conv1d(k=8) + bias + relu,
// C input channels → 64 output channels — launched three times
// (128→64→64→64).  Replaces conv_head_pallas
// (palace_tpu/ops/pallas_kernels.py).
//
// out[b,o,p] = T(relu(Σ_{c,k} w[o,c,k]·x[b,c,p+k] + bias[o])), products
// accumulated in float32, bias and relu in float32, the result rounded to
// the working dtype T (as the TPU kernel casts after each layer).
//
// Bound on the H100: operations — 548 GFLOP for the three layers at
// B = 512 × 4096 positions, 0.554 ms at the 989 TFLOP/s of bf16 and f16
// (float32: below).
//
// 16-bit path (bf16, f16): an implicit GEMM on the tensor cores, as the TPU
// kernel writes it: for each tap k, acc(64 × N) += W_k (64 × C) · X[:, p+k].
// - mma.sync.m16n8k16 with float32 accumulators, operands through ldmatrix.
//   mma.sync and one layer a launch keep the design within reach: the
//   layers unfused move 1.9 GB a batch, 0.56 ms at 3.35 TB/s, and
//   ldmatrix's traffic (below) holds mma.sync near half the tensor peak;
//   fusing them pays only together with wgmma and TMA.
// - Shared memory holds the input tile position-major, [position][channel]
//   with 8 channels of padding: a tap shift is a shift of the row address,
//   every row stays 16-byte aligned for ldmatrix, and rows of 272 B (C = 128)
//   or 144 B (C = 64), both ≡ 16 mod 128, put 8 consecutive rows in distinct
//   banks.  The weights sit as [tap][out][channel], padded alike.
// - Blocks are persistent (one an SM for C = 128, two for C = 64): each
//   loads its layer's weights once (139 KB or 74 KB) and walks over
//   (row, 128-position) tiles, the next tile's input in flight while the
//   current one's products run.  8 warps of 32 channels × 32 positions.
//   ldmatrix moves 256 B of shared memory an mma at this warp tile, which
//   bounds the products at about half the tensor peak; larger warp tiles
//   cost the warps that hide latency, within these shared-memory budgets.
// - Layer 1's input is the channel-major (B, C, L) view of K2's output.
//   cp.async copies its tile as it lies, 16 bytes along each channel, and
//   ldmatrix.trans + stmatrix turn it [position][channel] once a tile (at
//   tap 0, where rows are aligned).  Staging it through registers instead
//   was slower: 16-byte loads from 32 channel rows a warp held up the
//   load/store pipe that ldmatrix needs.  The wrapper
//   keeps the intermediates channel-last, (B, L, 64), which cp.async copies
//   straight in, and the last layer writes the public (B, 64, L_out).
// - Accuracy: an mma rounds its sum toward zero, so one chain over a tile's
//   64 (C = 128) or 32 steps drifts from a float32 sum, enough to flip the
//   rounding of large outputs.  Each 16-channel slice's 8 taps run as a chain
//   of their own, added to the accumulators with round-to-nearest.
// - Ragged edges: input rows at or beyond L_in are zero-filled (cp.async
//   with src-size 0), nothing past a row's end is read, nothing at or
//   beyond L_out stored.  The epilogue goes through shared memory
//   (stmatrix), then 16-byte stores; the channel-major output's rows of
//   L_out = 4075 elements start at any 2-byte offset, so a warp stores a
//   row 8 bytes a lane, split by the row's alignment.
//
// float32 path (conv_tf32_kernel), the pipeline's default dtype: the same
// implicit GEMM on the tensor cores through a 3×TF32 split, mma.sync
// m16n8k8 on TF32 operands.  One TF32 product (10 mantissa bits) lands
// ~2e-2 from float32 where outputs reach 40, far outside float32's 1e-4.  So
// each operand x is split into big = tf32(x) and small = tf32(x - big), and
// each k8 step adds small·big, big·small and big·big (small·small, below
// 2^-22 of a product, is dropped).
// - Bounds for a batch of 512 × 4096 positions: the 3×TF32 products,
//   3 × 548 GFLOP at TF32's 495 TFLOP/s, 3.32 ms, the bound this route is
//   read against; all 548 GFLOP as FMAs on the CUDA cores at 67 TFLOP/s,
//   8.18 ms, the bound of the CUDA-core kernel this route replaced; bytes,
//   1.07 GB of input, the two 0.54 GB intermediates written and read back
//   and 0.53 GB of output, about 1.12 ms at 3.35 TB/s.
// - Chains: an mma rounds its sum toward zero.  Each 16-channel slice's
//   8 taps × 2 k8 steps × 3 = 48 mma are one chain, added to the float32
//   accumulators with round-to-nearest, as in the 16-bit path.  One chain
//   over a whole tile (384 mma at C = 128) drifts past 1e-4 where outputs
//   reach 40 (tests/test_torch_conv_tf32.py emulates both on the CPU).
// - The split happens once for each operand, on the card: the weights, which
//   do not fit a block whole (256 KB a plane at C = 128, 512 KB big and
//   small), by split_weights_kernel once a call, in the same launch; the
//   input once a tile as it is stored into shared memory, not once a warp
//   as it loads.
// - Each block streams a slice at a time through a two-stage ring: the
//   weights' two planes (64 KB, one contiguous cp.async copy from L2) and
//   the input's 16 channels × 264 positions.  Each thread copies its share
//   of the next slice's input as it lies (4-byte cp.async: the channel-major
//   rows of L_in floats start at any 4-byte offset) and, half way through
//   the current slice's taps, splits that same share into the next stage:
//   no barrier between copy and split, and the split runs beside other
//   warps' products.  The split is also the transpose of the channel-major
//   input (ldmatrix.trans is 16-bit only); a tap shift is a row shift.
// - Every fragment is one 16-byte ld.shared a lane: the weights are split
//   into fragment order (a[0..3] of each lane, big and small planes apart),
//   and an input row holds each channel pair as {big, big, small, small}.
//   Lane (g, q) takes channels 2q, 2q + 1 of a k8 step as the mma's k = q
//   and q + 4, in A and B alike.  (Loaded as two 8-byte halves, a[0..3]
//   comes out of order, and the register moves that ptxas adds to put it
//   right hold up the mma issue.)  An input row's 8 pairs are swizzled
//   (x_col) so that 8 consecutive rows, read by the fragments or written by
//   the split, fall in 32 distinct banks.
// - Blocks are persistent, one an SM (215,552 B of shared memory: the ring
//   and the input as copied), and walk over (row, 256-position) tiles, the
//   ring running on across tiles; a 256-position tile halves the weights'
//   L2 traffic against 128.  8 warps, each all 64 output channels × 32
//   positions.  Channel-major in and out, so one kernel takes every layer
//   (any C % 16 == 0).  The epilogue adds the bias and applies relu in
//   float32, stages the tile in the ring stage just used, and stores it a
//   channel row a warp.
#include "mma.cuh"

using namespace palace;

namespace {

constexpr int kOut = 64;      // output channels
constexpr int kTaps = 8;      // kernel width
constexpr int kTileP = 128;   // output positions a 16-bit tile

// ---------------------------------------------------------------------------
// float32: tensor cores through a 3×TF32 split
// ---------------------------------------------------------------------------

constexpr int kSlice = 16;                  // input channels a slice: one chain
constexpr int kPairs = kSlice / 2;          // channel pairs a slice
constexpr int kTileF = 256;                 // output positions a float32 tile
constexpr int kRowsF = kTileF + 8;          // input rows a tile: 256 + 7, rounded up to 8
constexpr int kWarpM = 64, kWarpN = 32;     // a warp's output channels × positions
constexpr int kMI = kWarpM / 16, kNJ = kWarpN / 8;  // m16 and n8 blocks a warp
constexpr int kWarpsM = kOut / kWarpM;
constexpr int kWarpsF = kWarpsM * (kTileF / kWarpN);
constexpr int kThreadsF = 32 * kWarpsF;
constexpr int kRowGroups = kWarpsF / kPairs;   // warps a channel pair in the split pass
constexpr int kPlaneW = kTaps * 2 * kOut * 8;  // words of a slice's weight plane
constexpr int kOutPitch = kTileF + 8;          // words an output row staged

// One stage of the ring: a slice's operands split into big and small planes,
// each laid out so that one 16-byte ld.shared gives a lane its fragment.
// w[tap][k8 step][m16 block][plane][lane][4]: the A fragment a[0..3] of lane
// (g, q), as split_weights_kernel writes it.  x[row][32]: the row's channel
// pair p of k8 step ks as {big, big, small, small} at word 16 · (ks ^ (row &
// 1)) + 4 · (p ^ ((row >> 1) & 3)), so that 8 consecutive rows, read or
// written, fall in 32 distinct banks.  After a tile's last slice, its output
// is staged in the stage's place, [out][kOutPitch] floats.
struct SliceF32 {
  uint32_t w[kTaps][2][kOut / 16][2][32][4];
  uint32_t x[kRowsF][32];
};
// the ring, then the next slice's input as it lies, [channel][kRowsF]
constexpr int kSmemF32 = 2 * (int)sizeof(SliceF32) + kSlice * kRowsF * 4;
static_assert(sizeof(SliceF32::w) == 2 * kPlaneW * 4, "a slice's weight planes");
static_assert(kOut * kOutPitch * 4 <= sizeof(SliceF32), "the output tile fits a stage");
static_assert(kWarpsF % kPairs == 0, "whole warps a channel pair in the split pass");
static_assert(kSmemF32 <= 232448, "the ring's two stages in a block's shared memory");

// x's word of channel pair p of k8 step ks in a row
__device__ __forceinline__ int x_col(int row, int ks, int p) {
  return 16 * (ks ^ (row & 1)) + 4 * (p ^ ((row >> 1) & 3));
}

// w (64, C, 8) → ws, slice s's planes at s · 2 · kPlaneW, as SliceF32::w.
// Lane (g, q) of m16 block mi holds a[e] = A[g + 8 (e & 1)][q + 4 (e >> 1)]:
// output 16 mi + g + 8 (e & 1), the mma's k = q + 4 (e >> 1) taken from
// channel 8 ks + 2q + (e >> 1) (B takes the same channels).
__global__ void split_weights_kernel(const float* __restrict__ w, uint32_t* __restrict__ ws,
                                     int C) {
  // d = (((((s · 8 + tap) · 2 + ks) · 4 + mi) · 32 + lane) · 4 + e, a word of the big plane
  const int n = kOut * C * kTaps;
  for (int d = blockIdx.x * blockDim.x + threadIdx.x; d < n; d += gridDim.x * blockDim.x) {
    const int e = d & 3, lane = (d >> 2) & 31, mi = (d >> 7) & 3, ks = (d >> 9) & 1;
    const int k = (d >> 10) & 7, s = d >> 13;
    const int o = 16 * mi + (lane >> 2) + 8 * (e & 1);
    const int c = s * kSlice + 8 * ks + 2 * (lane & 3) + (e >> 1);
    uint32_t* dst = ws + (size_t)s * 2 * kPlaneW + (((k * 2 + ks) * 4 + mi) * 2) * 128 +
                    (d & 127);
    split_tf32(w[((size_t)o * C + c) * kTaps + k], dst[0], dst[128]);
  }
}

// the weights' two planes of slice s, one contiguous 64 KB copy
__device__ __forceinline__ void load_w(SliceF32& st, const uint32_t* __restrict__ ws, int s) {
  const uint32_t* src = ws + (size_t)s * 2 * kPlaneW;
  uint32_t* dst = &st.w[0][0][0][0][0][0];
  for (int e = 4 * threadIdx.x; e < 2 * kPlaneW; e += 4 * kThreadsF)
    cp_async16(dst + e, src + e, 16);
  cp_async_commit();
}

// The input: each thread copies its share of a slice as it lies into
// raw[channel][row] and later splits that same share into a stage's x, so
// no barrier stands between the two.  Warp w takes channel pair w % 8 at
// rows lane + 32 · (w / 8 + kRowGroups · i), i < kRowIters; rows 32 apart
// share their x_col.
constexpr int kRowIters = (kRowsF + 32 * kRowGroups - 1) / (32 * kRowGroups);

// xs is the slice's first channel row (rows of L_in), p0 the tile's first
// position; zeros at or beyond L_in
__device__ __forceinline__ void load_x(float* raw, const float* __restrict__ xs, int L_in,
                                       int p0) {
  const int warp = threadIdx.x >> 5, pr = warp % kPairs;
  const int r0 = (threadIdx.x & 31) + 32 * (warp / kPairs), n = min(L_in - p0, kRowsF);
  const float* src = xs + (size_t)(2 * pr) * L_in + p0;
  float* dst = raw + 2 * pr * kRowsF;
#pragma unroll
  for (int i = 0; i < kRowIters; ++i) {
    const int r = r0 + 32 * kRowGroups * i, in = r < n;
    if (r < kRowsF) {
      cp_async4(dst + r, src + (in ? r : 0), in ? 4 : 0);
      cp_async4(dst + kRowsF + r, src + L_in + (in ? r : 0), in ? 4 : 0);
    }
  }
  cp_async_commit();
}

// ... once copied (cp_async_wait_all), split, one 16-byte store a row
__device__ __forceinline__ void split_x(SliceF32& st, const float* raw) {
  const int warp = threadIdx.x >> 5, pr = warp % kPairs;
  const int r0 = (threadIdx.x & 31) + 32 * (warp / kPairs), col = x_col(r0, pr >> 2, pr & 3);
  const float* c0 = raw + 2 * pr * kRowsF;
#pragma unroll
  for (int i = 0; i < kRowIters; ++i) {
    const int r = r0 + 32 * kRowGroups * i;
    if (r < kRowsF) {
      uint4 v;
      split_tf32(c0[r], v.x, v.z);
      split_tf32(c0[r + kRowsF], v.y, v.w);
      *reinterpret_cast<uint4*>(&st.x[r][col]) = v;
    }
  }
}

// x (B, C, L_in), ws from split_weights_kernel, bias (64,), out (B, 64,
// L_out).  Tile t is row t / tiles_per_row, positions (t % tiles_per_row) ·
// 256 onwards; a block takes tiles blockIdx.x, + gridDim.x, ..., each as
// C / 16 slices, one ring stage each.
__global__ void __launch_bounds__(kThreadsF, 1)
    conv_tf32_kernel(const float* __restrict__ x, const uint32_t* __restrict__ ws,
                     const float* __restrict__ bias, float* __restrict__ out, int C, int L_in,
                     int tiles_per_row, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  SliceF32* ring = reinterpret_cast<SliceF32*>(smem);
  float* raw = reinterpret_cast<float*>(smem + 2 * sizeof(SliceF32));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int L_out = L_in - kTaps + 1, n_slices = C / kSlice;
  const int obase = (warp % kWarpsM) * kWarpM, pbase = (warp / kWarpsM) * kWarpN;

  // the first input channel row of slice s of tile t
  auto x_at = [&](int t, int s) {
    return x + ((size_t)(t / tiles_per_row) * C + s * kSlice) * L_in;
  };
  int tile = blockIdx.x, slice = 0;
  load_w(ring[0], ws, 0);
  load_x(raw, x_at(tile, 0), L_in, (tile % tiles_per_row) * kTileF);
  cp_async_wait_all();
  split_x(ring[0], raw);
  __syncthreads();

  // acc[mi][nj]: channels obase + 16·mi + g (+ 8) × positions pbase + 8·nj
  // + 2q (+ 1) of the tile
  float acc[kMI][kNJ][4];
  for (int step = 0;; ++step) {
    SliceF32& cur = ring[step & 1];
    SliceF32& nxt = ring[(step & 1) ^ 1];
    const bool last = slice + 1 == n_slices;
    const int ntile = last ? tile + gridDim.x : tile, nslice = last ? 0 : slice + 1;
    const bool more = ntile < n_tiles;
    if (more) {  // the next slice in flight while this one's products run
      load_w(nxt, ws, nslice);
      load_x(raw, x_at(ntile, nslice), L_in, (ntile % tiles_per_row) * kTileF);
    }
    if (slice == 0) {
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    }

    // the slice's chain: for each tap, each k8 step, small·big, big·small,
    // big·big; 48 mma an output, then added to acc with round-to-nearest
    float part[kMI][kNJ][4] = {};
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bb[kNJ][2], bs[kNJ][2];  // B: input rows pbase + 8·nj + g + k
#pragma unroll
        for (int nj = 0; nj < kNJ; ++nj) {
          const int r = pbase + 8 * nj + g + k;
          const uint4 v = *reinterpret_cast<const uint4*>(&cur.x[r][x_col(r, ks, q)]);
          bb[nj][0] = v.x, bb[nj][1] = v.y, bs[nj][0] = v.z, bs[nj][1] = v.w;
        }
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {  // A: output channels obase + 16·mi + g, + 8
          const uint4 vb = *reinterpret_cast<const uint4*>(cur.w[k][ks][obase / 16 + mi][0][lane]);
          const uint4 vs = *reinterpret_cast<const uint4*>(cur.w[k][ks][obase / 16 + mi][1][lane]);
          const uint32_t ab[4] = {vb.x, vb.y, vb.z, vb.w}, as[4] = {vs.x, vs.y, vs.z, vs.w};
#pragma unroll
          for (int nj = 0; nj < kNJ; ++nj) {
            mma_tf32(part[mi][nj], as, bb[nj][0], bb[nj][1]);
            mma_tf32(part[mi][nj], ab, bs[nj][0], bs[nj][1]);
            mma_tf32(part[mi][nj], ab, bb[nj][0], bb[nj][1]);
          }
        }
        if (k == kTaps / 2 - 1 && ks == 1) {  // half way: the next input is in, split it
          cp_async_wait_all();
          if (more) split_x(nxt, raw);
        }
      }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];

    __syncthreads();  // every warp is done with cur; nxt is filled
    if (last) {  // epilogue: bias and relu, staged in cur, stored a row a warp
      float(*ost)[kOutPitch] = reinterpret_cast<float(*)[kOutPitch]>(&cur);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = obase + 16 * mi + 8 * h + g;
          const float bo = __ldg(bias + o);
#pragma unroll
          for (int nj = 0; nj < kNJ; ++nj)
            *reinterpret_cast<float2*>(&ost[o][pbase + 8 * nj + 2 * q]) =
                make_float2(fmaxf(acc[mi][nj][2 * h] + bo, 0.f),
                            fmaxf(acc[mi][nj][2 * h + 1] + bo, 0.f));
        }
      __syncthreads();
      const int p0 = (tile % tiles_per_row) * kTileF, n = min(kTileF, L_out - p0);
      float* ob = out + (size_t)(tile / tiles_per_row) * kOut * L_out + p0;
      for (int o = warp; o < kOut; o += kWarpsF)
        for (int p = lane; p < n; p += 32) ob[(size_t)o * L_out + p] = ost[o][p];
      __syncthreads();  // the next slice's weights go where the output was
    }
    if (!more) break;
    tile = ntile;
    slice = nslice;
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 136;       // input rows a tile: 128 + 7, rounded up to 8
constexpr int kGroups = kRows / 8;
constexpr int kStageCL = 72;     // channel-last staging row: 64 channels + 8
constexpr int kStageCM = 136;    // channel-major staging row: 128 positions + 8

template <int C> struct MmaShape {
  static constexpr int kPitch = C + 8;  // elements a shared row
  static constexpr int kWeightBytes = kTaps * kOut * kPitch * 2;
  static constexpr int kTileBytes = kRows * kPitch * 2;
  // a channel-major tile as it lies in memory, [channel][kRows positions]
  static constexpr int kRawBytes = C * kRows * 2;
  static constexpr int kBlocksPerSM = C == 128 ? 1 : 2;
  // a warp's tile: kWM output channels × kWN positions
  static constexpr int kWM = 32, kWN = 32;
  static constexpr int kMI = kWM / 16, kNJ = kWN / 8;  // m16 and n8 blocks a warp
  static constexpr int kWarpsM = kOut / kWM;
  static constexpr int kWarps = kWarpsM * (kTileP / kWN);
  static constexpr int kThreads = 32 * kWarps;
};
// shared memory: the weights, then two tile buffers, or for a channel-major
// input one tile buffer and the raw tile
template <int C, bool kInCM>
constexpr int conv_smem_bytes = MmaShape<C>::kWeightBytes + MmaShape<C>::kTileBytes +
                           (kInCM ? MmaShape<C>::kRawBytes : MmaShape<C>::kTileBytes);
static_assert(kTileP * kStageCL * 2 <= MmaShape<64>::kTileBytes, "staging fits a tile buffer");
static_assert(kOut * kStageCM * 2 <= MmaShape<64>::kTileBytes, "staging fits a tile buffer");
static_assert(2 * (conv_smem_bytes<64, false> + 1024) <= 233472, "two blocks an SM at C = 64");
static_assert(2 * (conv_smem_bytes<64, true> + 1024) <= 233472, "two blocks an SM at C = 64");
static_assert(conv_smem_bytes<128, true> <= 232448, "a block's shared memory at C = 128");

// Layer 1's channel-major (B, C, L_in) tile as it lies in memory, into
// raw[channel][kRows]: 16-byte copies along each channel's positions, or,
// where rows are not 16-byte aligned, element by element
template <int C>
__device__ __forceinline__ void load_channel_major(uint16_t* raw, const uint16_t* __restrict__ x,
                                                   int b, int p0, int L_in) {
  constexpr int kThreads = MmaShape<C>::kThreads;
  const uint16_t* xb = x + (size_t)b * C * L_in;
  if ((L_in & 7) == 0) {
    for (int e = threadIdx.x; e < C * kGroups; e += kThreads) {
      const int c = e / kGroups, q = (e % kGroups) * 8, p = p0 + q;
      cp_async16(raw + c * kRows + q, xb + (size_t)c * L_in + (p < L_in ? p : 0),
                 p < L_in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < C * kRows; e += kThreads) {
      const int c = e / kRows, q = e % kRows;
      raw[c * kRows + q] = p0 + q < L_in ? xb[(size_t)c * L_in + p0 + q] : 0;
    }
  }
}

// raw[channel][position] → xs[position][channel], four 8 × 8 blocks (32
// channels × 8 positions) a warp at a time: ldmatrix.trans hands each lane
// a channel pair of one position, stmatrix writes them as position rows
template <int C>
__device__ __forceinline__ void transpose_tile(uint16_t* xs, const uint16_t* raw) {
  constexpr int kPitch = MmaShape<C>::kPitch, kUnits = C / 32 * kGroups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int u = warp; u < kUnits; u += MmaShape<C>::kWarps) {
    const int c0 = (u % (C / 32)) * 32, q0 = (u / (C / 32)) * 8;
    uint32_t r[4];
    ldmatrix_x4_trans(r, smem_addr(raw + (c0 + lane) * kRows + q0));
    stmatrix_x4(smem_addr(xs + (q0 + (lane & 7)) * kPitch + c0 + (lane >> 3) * 8), r);
  }
}

// A channel-last (B, L_in, C) tile straight into shared memory
template <int C>
__device__ __forceinline__ void load_channel_last(uint16_t* xs, const uint16_t* __restrict__ x,
                                                  int b, int p0, int L_in) {
  constexpr int kPitch = MmaShape<C>::kPitch, kChunks = C / 8;
  for (int e = threadIdx.x; e < kRows * kChunks; e += MmaShape<C>::kThreads) {
    const int r = e / kChunks, ch = e % kChunks, p = p0 + r;
    const uint16_t* src = x + ((size_t)b * L_in + (p < L_in ? p : L_in - 1)) * C + ch * 8;
    cp_async16(xs + r * kPitch + ch * 8, src, p < L_in ? 16 : 0);
  }
}

// x (B, C, L_in) if kInCM else (B, L_in, C); wt (K, 64, C); bias (64,);
// out (B, 64, L_out) if kOutCM else (B, L_out, 64).  Tile t is row
// t / tiles_per_row, positions (t % tiles_per_row)·128 onwards.
template <typename T, int C, bool kInCM, bool kOutCM>
__global__ void __launch_bounds__(MmaShape<C>::kThreads, MmaShape<C>::kBlocksPerSM)
    conv_mma_kernel(const T* __restrict__ x_, const T* __restrict__ wt_,
                    const T* __restrict__ bias, T* __restrict__ out_, int L_in,
                    int tiles_per_row, int n_tiles) {
  using S = MmaShape<C>;
  constexpr int kPitch = S::kPitch, kMI = S::kMI, kNJ = S::kNJ, kThreads = S::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem);
  // two tile buffers, or for a channel-major input one and the raw tile
  auto xbuf = [&](int i) {
    return reinterpret_cast<uint16_t*>(smem + S::kWeightBytes + i * S::kTileBytes);
  };
  uint16_t* raw = xbuf(1);
  const uint16_t* x = reinterpret_cast<const uint16_t*>(x_);
  const uint16_t* wt = reinterpret_cast<const uint16_t*>(wt_);
  uint16_t* out = reinterpret_cast<uint16_t*>(out_);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L_out = L_in - kTaps + 1;
  const int obase = (warp % S::kWarpsM) * S::kWM, pbase = (warp / S::kWarpsM) * S::kWN;
  const int g = lane >> 2;  // the accumulator row of this lane

  float bias_r[kMI][2];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) bias_r[mi][h] = to_f(bias[obase + mi * 16 + h * 8 + g]);

  // the layer's weights, once
  for (int e = tid; e < kTaps * kOut * (C / 8); e += kThreads) {
    const int row = e / (C / 8), ch = e % (C / 8);
    cp_async16(ws + row * kPitch + ch * 8, wt + (size_t)row * C + ch * 8, 16);
  }
  int tile = blockIdx.x;
  if (tile < n_tiles) {
    const int b = tile / tiles_per_row, p0 = (tile % tiles_per_row) * kTileP;
    if constexpr (kInCM) {
      load_channel_major<C>(raw, x, b, p0, L_in);
    } else {
      load_channel_last<C>(xbuf(0), x, b, p0, L_in);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if constexpr (kInCM) {
    transpose_tile<C>(xbuf(0), raw);
    __syncthreads();
  }

  // per-lane ldmatrix offsets (bytes).  A (weights): matrices rows 0-7 /
  // 8-15 × channels 0-7 / 8-15 of a 16 × 16 slice; B (input): positions
  // 0-7 / 8-15 × channels 0-7 / 8-15, two n8 blocks at once.
  const uint32_t a_lane = ((obase + (lane & 15)) * kPitch + (lane >> 4) * 8) * 2;
  const uint32_t b_lane =
      ((pbase + (lane & 7) + (lane >> 4) * 8) * kPitch + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t ws_s = smem_addr(ws);

  for (int cur = 0; tile < n_tiles; tile += gridDim.x, cur ^= kInCM ? 0 : 1) {
    const int b = tile / tiles_per_row, p0 = (tile % tiles_per_row) * kTileP;
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      const int nb = next / tiles_per_row, np0 = (next % tiles_per_row) * kTileP;
      if constexpr (kInCM) {
        load_channel_major<C>(raw, x, nb, np0, L_in);
      } else {
        load_channel_last<C>(xbuf(cur ^ 1), x, nb, np0, L_in);
      }
    }
    cp_async_commit();

    float acc[kMI][kNJ][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

    // A chain of mma rounds each sum toward zero, so a long chain drifts
    // from the float32 sum.  Each 16-channel slice runs its 8 taps as a chain
    // of its own (part), added to acc with a round-to-nearest add.  The slice
    // loop stays rolled: unrolled, part's 32 registers spill.
    const uint32_t xs_s = smem_addr(xbuf(cur));
    constexpr float kZero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int c16 = 0; c16 < C / 16; ++c16) {
      float part[kMI][kNJ][4];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        uint32_t a[kMI][4], bq[kNJ / 2][4];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
          ldmatrix_x4(a[mi], ws_s + a_lane + ((k * kOut + mi * 16) * kPitch + c16 * 16) * 2);
#pragma unroll
        for (int nq = 0; nq < kNJ / 2; ++nq)
          ldmatrix_x4(bq[nq], xs_s + b_lane + ((k + nq * 16) * kPitch + c16 * 16) * 2);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int nj = 0; nj < kNJ; ++nj)
            MmaType<T>::mma(part[mi][nj], a[mi], bq[nj >> 1][(nj & 1) * 2],
                            bq[nj >> 1][(nj & 1) * 2 + 1], k ? part[mi][nj] : kZero);
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];
    }

    // epilogue: bias, relu, round, staged through the tile buffer just used.
    // Fragment (mi, nj) holds channels obase + mi·16 + [0, 16) × positions
    // pbase + nj·8 + [0, 8); one stmatrix.x4 writes nj = 2nq, 2nq + 1 as
    // [channel][position] rows, or transposed as [position][channel] rows.
    __syncthreads();
    uint16_t* st = xbuf(cur);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int nq = 0; nq < kNJ / 2; ++nq) {
        uint32_t r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // matrix j: nj = 2nq + j / 2, rows h·8.. with h = j % 2
          const float* v = acc[mi][2 * nq + (j >> 1)];
          const int h = j & 1;
          r[j] = pack2<T>(fmaxf(v[2 * h] + bias_r[mi][h], 0.f),
                          fmaxf(v[2 * h + 1] + bias_r[mi][h], 0.f));
        }
        const int j = lane >> 3, row = lane & 7;
        const int o = obase + mi * 16 + (j & 1) * 8, p = pbase + (2 * nq + (j >> 1)) * 8;
        if constexpr (kOutCM) {
          stmatrix_x4(smem_addr(st + (o + row) * kStageCM + p), r);
        } else {
          stmatrix_x4_trans(smem_addr(st + (p + row) * kStageCL + o), r);
        }
      }
    __syncthreads();
    const int n = min(kTileP, L_out - p0);  // positions of this tile
    if constexpr (kOutCM) {
      // a warp a channel row, 4 positions a lane: the row's element offset
      // mod 4, the same for the whole warp, sets the store widths
      const size_t row0 = (size_t)b * kOut * L_out + p0;
      const int p = 4 * lane;
      for (int o = warp; o < kOut; o += kThreads / 32) {
        uint16_t* orow = out + row0 + (size_t)o * L_out;
        const uint2 v = *reinterpret_cast<const uint2*>(st + o * kStageCM + p);
        const int r = (int)((row0 + (size_t)o * L_out) & 3);
        if (p + 4 <= n) {
          if (r == 0) {
            *reinterpret_cast<uint2*>(orow + p) = v;
          } else if (r == 2) {
            *reinterpret_cast<uint32_t*>(orow + p) = v.x;
            *reinterpret_cast<uint32_t*>(orow + p + 2) = v.y;
          } else {
            orow[p] = (uint16_t)v.x;
            *reinterpret_cast<uint32_t*>(orow + p + 1) = __byte_perm(v.x, v.y, 0x5432);
            orow[p + 3] = (uint16_t)(v.y >> 16);
          }
        } else {
          const uint32_t w[2] = {v.x, v.y};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (p + j < n) orow[p + j] = (uint16_t)(w[j >> 1] >> (16 * (j & 1)));
        }
      }
    } else {
      uint16_t* ob = out + ((size_t)b * L_out + p0) * kOut;
      for (int e = tid; e < kTileP * (kOut / 8); e += kThreads) {
        const int r = e / (kOut / 8), ch = e % (kOut / 8);
        if (r < n)
          *reinterpret_cast<uint4*>(ob + r * kOut + ch * 8) =
              *reinterpret_cast<const uint4*>(st + r * kStageCL + ch * 8);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if constexpr (kInCM) {  // the next tile, from the raw copy into the one tile buffer
      if (next < n_tiles) transpose_tile<C>(xbuf(0), raw);
      __syncthreads();
    }
  }
}

template <typename T_, int C_, bool kInCM_, bool kOutCM_> struct Variant {
  using T = T_;
  static constexpr int C = C_;
  static constexpr bool kInCM = kInCM_, kOutCM = kOutCM_;
  static constexpr int kSmemBytes = conv_smem_bytes<C_, kInCM_>;
};

// f(Variant<...>{}) for the layer that takes (C, in_cm, out_cm), as the
// three-layer head runs them: the first layer, C = 128 or 64, channel-major
// in and channel-last out; the second channel-last in and out; the third
// channel-last in and channel-major out, both at C = 64
template <typename T, typename F>
int with_variant(int C, bool in_cm, bool out_cm, F&& f) {
  if (in_cm && !out_cm) {
    if (C == 128) return f(Variant<T, 128, true, false>{});
    if (C == 64) return f(Variant<T, 64, true, false>{});
  } else if (!in_cm && C == 64) {
    return out_cm ? f(Variant<T, 64, false, true>{}) : f(Variant<T, 64, false, false>{});
  }
  return (int)cudaErrorInvalidValue;
}

// opt a kernel in to its dynamic shared memory; the blocks that fit an SM
template <typename K> cudaError_t configure(K kernel, int threads, int smem_bytes, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem_bytes);
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// the persistent grid for n_tiles tiles of kernel: per_sm blocks an SM, at most
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, int smem_bytes, long long n_tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = configure(kernel, threads, smem_bytes, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && n_tiles > 0x7fffffffLL) err = cudaErrorInvalidValue;
  *grid = (int)(n_tiles < (long long)per_sm * sms ? n_tiles : per_sm * sms);
  return err;
}

template <typename V>
int launch_mma(const void* x, const void* wt, const void* bias, void* out, int B, int L_in,
               cudaStream_t stream) {
  using T = typename V::T;
  auto kernel = conv_mma_kernel<T, V::C, V::kInCM, V::kOutCM>;
  const int L_out = L_in - kTaps + 1;
  const int tiles_per_row = (L_out + kTileP - 1) / kTileP;
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, MmaShape<V::C>::kThreads, V::kSmemBytes,
                                    (long long)B * tiles_per_row, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, MmaShape<V::C>::kThreads, V::kSmemBytes, stream>>>(
      (const T*)x, (const T*)wt, (const T*)bias, (T*)out, L_in, tiles_per_row,
      B * tiles_per_row);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_16bit(const void* x, const void* wt, const void* bias, void* out, int B, int C,
                 int L_in, bool in_cm, bool out_cm, cudaStream_t s) {
  return with_variant<T>(C, in_cm, out_cm, [&](auto v) {
    return launch_mma<decltype(v)>(x, wt, bias, out, B, L_in, s);
  });
}

// w (64, C, 8) split into work (2 · 64 · C · 8 words), then the layer
int launch_tf32(const void* x, const void* w, const void* bias, void* out, void* work, int B,
                int C, int L_in, cudaStream_t stream) {
  if (C < kSlice || C % kSlice != 0 || work == nullptr) return (int)cudaErrorInvalidValue;
  const int L_out = L_in - kTaps + 1;
  const int tiles_per_row = (L_out + kTileF - 1) / kTileF;
  int grid = 0;
  cudaError_t err = persistent_grid(conv_tf32_kernel, kThreadsF, kSmemF32,
                                    (long long)B * tiles_per_row, &grid);
  if (err != cudaSuccess) return (int)err;
  const int n = kOut * C * kTaps;
  split_weights_kernel<<<(n + 255) / 256, 256, 0, stream>>>((const float*)w, (uint32_t*)work, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv_tf32_kernel<<<grid, kThreadsF, kSmemF32, stream>>>(
      (const float*)x, (const uint32_t*)work, (const float*)bias, (float*)out, C, L_in,
      tiles_per_row, B * tiles_per_row);
  return (int)cudaGetLastError();
}

}  // namespace

// One layer.  float32: x (B, C, L_in), wt the (64, C, 8) weight, work 2 ·
// 64 · C · 8 words for its split, out (B, 64, L_in − 7), C % 16 == 0,
// in_cm = out_cm = 1.  bf16/f16: wt (8, 64, C), work unused; x (B, C, L_in)
// if in_cm else (B, L_in, C); out (B, 64, L_out) if out_cm else
// (B, L_out, 64); the layouts and widths with_variant takes.
extern "C" int palace_conv_layer(const void* x, const void* wt, const void* bias, void* out,
                                 void* work, int B, int C, int L_in, int dtype, int in_cm,
                                 int out_cm, void* stream) {
  if (B < 1 || L_in < kTaps) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case palace::kF32:
      if (!in_cm || !out_cm) return (int)cudaErrorInvalidValue;
      return launch_tf32(x, wt, bias, out, work, B, C, L_in, s);
    case palace::kBF16:
      return launch_16bit<__nv_bfloat16>(x, wt, bias, out, B, C, L_in, in_cm, out_cm, s);
    case palace::kF16:
      return launch_16bit<__half>(x, wt, bias, out, B, C, L_in, in_cm, out_cm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
