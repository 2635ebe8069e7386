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
// B = 512 × 4096 positions, 0.554 ms at the 989 TFLOP/s of bf16 and f16.
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
// float32 path: CUDA-core FMAs, channel-major in and out (TF32 would break
// float32's 1e-4 tolerance).  Each block computes a 64-channel × 128-position
// tile from 16-channel slices of input and weights in shared memory, a 4 × 8
// tile of accumulators a thread.
#include "mma.cuh"

using namespace palace;

namespace {

constexpr int kOut = 64;      // output channels
constexpr int kTaps = 8;      // kernel width
constexpr int kTileP = 128;   // output positions a tile
constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kChunk = 16;     // input channels per shared-memory slice
constexpr int kXStride = 136;  // input columns per slice row (≥ 128 + 7, float4-aligned)

// wt is the weight in (C, K, O) layout, so that one tap of 4 output
// channels is one float4 in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads) conv_layer_kernel(
    const T* __restrict__ x, const T* __restrict__ wt, const T* __restrict__ bias,
    T* __restrict__ out, int C, int L_in) {
  __shared__ __align__(16) float xs[kChunk][kXStride];
  __shared__ __align__(16) float ws[kChunk][kTaps][kOut];

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTileP;
  const int L_out = L_in - kTaps + 1;
  const int t = threadIdx.x;
  const int o0 = (t >> 4) * 4;  // 4 output channels
  const int q0 = (t & 15) * 8;  // 8 output positions
  const T* xb = x + (size_t)b * C * L_in;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    for (int e = t; e < kChunk * kXStride; e += kThreads) {
      const int c = e / kXStride, q = e - c * kXStride, p = p0 + q;
      xs[c][q] = p < L_in ? to_f(xb[(size_t)(c0 + c) * L_in + p]) : 0.f;
    }
    const T* wc = wt + (size_t)c0 * kTaps * kOut;
    for (int e = t; e < kChunk * kTaps * kOut; e += kThreads) (&ws[0][0][0])[e] = to_f(wc[e]);
    __syncthreads();

    for (int c = 0; c < kChunk; ++c) {
      float xr[16];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 q = *reinterpret_cast<const float4*>(&xs[c][q0 + 4 * v]);
        xr[4 * v] = q.x;
        xr[4 * v + 1] = q.y;
        xr[4 * v + 2] = q.z;
        xr[4 * v + 3] = q.w;
      }
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(&ws[c][k][o0]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], xr[j + k], acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* ob = out + (size_t)b * kOut * L_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + i;
    const float bo = to_f(bias[o]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = p0 + q0 + j;
      if (p < L_out) ob[(size_t)o * L_out + p] = from_f<T>(fmaxf(acc[i][j] + bo, 0.f));
    }
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

int launch_f32(const void* x, const void* wt, const void* bias, void* out, int B, int C,
               int L_in, cudaStream_t stream) {
  if (B > 65535 || C % kChunk != 0) return (int)cudaErrorInvalidValue;
  const int L_out = L_in - kTaps + 1;
  const dim3 grid((L_out + kTileP - 1) / kTileP, B);
  conv_layer_kernel<float><<<grid, kThreads, 0, stream>>>(
      (const float*)x, (const float*)wt, (const float*)bias, (float*)out, C, L_in);
  return (int)cudaGetLastError();
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

// opt in to the variant's shared memory; the blocks that fit an SM
template <typename V> cudaError_t configure(int* per_sm) {
  auto kernel = conv_mma_kernel<typename V::T, V::C, V::kInCM, V::kOutCM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         V::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        MmaShape<V::C>::kThreads, V::kSmemBytes);
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

template <typename V>
int launch_mma(const void* x, const void* wt, const void* bias, void* out, int B, int L_in,
               cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = configure<V>(&per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int L_out = L_in - kTaps + 1;
  const int tiles_per_row = (L_out + kTileP - 1) / kTileP;
  if ((long long)B * tiles_per_row > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_tiles = B * tiles_per_row;
  const int grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  using T = typename V::T;
  conv_mma_kernel<T, V::C, V::kInCM, V::kOutCM>
      <<<grid, MmaShape<V::C>::kThreads, V::kSmemBytes, stream>>>(
      (const T*)x, (const T*)wt, (const T*)bias, (T*)out, L_in, tiles_per_row, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_16bit(const void* x, const void* wt, const void* bias, void* out, int B, int C,
                 int L_in, bool in_cm, bool out_cm, cudaStream_t s) {
  return with_variant<T>(C, in_cm, out_cm, [&](auto v) {
    return launch_mma<decltype(v)>(x, wt, bias, out, B, L_in, s);
  });
}

}  // namespace

// One layer.  float32: x (B, C, L_in), wt (C, 8, 64), out (B, 64, L_in − 7),
// C % 16 == 0, in_cm = out_cm = 1.  bf16/f16: wt (8, 64, C); x (B, C, L_in)
// if in_cm else (B, L_in, C); out (B, 64, L_out) if out_cm else
// (B, L_out, 64); the layouts and widths with_variant takes.
extern "C" int palace_conv_layer(const void* x, const void* wt, const void* bias, void* out,
                                 int B, int C, int L_in, int dtype, int in_cm, int out_cm,
                                 void* stream) {
  if (B < 1 || L_in < kTaps) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case palace::kF32:
      if (!in_cm || !out_cm) return (int)cudaErrorInvalidValue;
      return launch_f32(x, wt, bias, out, B, C, L_in, s);
    case palace::kBF16:
      return launch_16bit<__nv_bfloat16>(x, wt, bias, out, B, C, L_in, in_cm, out_cm, s);
    case palace::kF16:
      return launch_16bit<__half>(x, wt, bias, out, B, C, L_in, in_cm, out_cm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
