// K2: both bipartite SAGE rounds of the scorer and the LayerNorm between
// them, one block per batch row.  Replaces gcn_sage_pallas
// (palace_tpu/ops/pallas_kernels.py).
//
// With f = 64 f-nodes, pn = 4096 p-nodes, gd = 128 channels, and p-node
// n = 64·a + j (it reads f-node a; it feeds the mean of f-node j):
//   round 1  x_p1[n]  = relu(lift1[a] + T(x_p0[n]·Wr1)),  lift1 = T(x_f0·Wl1 + b1)
//            agg[j]   = T(Σ_a x_p1[64a+j] / 64)            (float32 sum, in order of a)
//            x_f1[j]  = relu(T(agg[j]·Wl2) + b2 + T(x_f0[j]·Wr2f))
//   LN       x_p1n, x_f1n = T(LayerNorm(·)), statistics in float32, eps 1e-5
//   round 2  x_p2[n]  = relu(lift2[a] + T(x_p1n[n]·Wr11)), lift2 = T(x_f1n·Wl11 + b11)
// Products accumulate in float32; T(·) rounds to the working dtype where the
// TPU kernel casts, and sums of two T values round to T.
//
// Bound on the H100: bytes, the (B, 4096, 128) output: 537 MB a batch of
// 512 in bf16, 0.164 ms at 3.35 TB/s (the products, 72.5 GFLOP, take 0.073
// ms at bf16's 989 TFLOP/s).  A row's activations (1 MiB in bf16) do not
// fit in a block's shared memory as they fit in the TPU's VMEM, so the
// block makes two passes and recomputes the round-1 activations (input
// width 3, cheap) instead of storing them: pass A accumulates agg, the
// f-node side is finished in shared memory, and pass B recomputes round 1
// for 64 p-nodes at a time, normalises them, multiplies by Wr11 and writes
// the output once.
//
// 16-bit path (bf16, f16): the three 128-deep products (agg·Wl2, x_f1n·Wl11
// and pass B's x_p1n·Wr11) run on the tensor cores, mma.sync m16n8k16 with
// float32 accumulators.  Their operands are T already (agg, x_f1n and
// x_p1n are rounded before the product, the weights arrive in T), so a
// T×T→f32 product loses nothing; only the order of the float32 sums
// changes, each output's sum one chain of 8 mma, the length K3 holds to
// (an mma rounds toward zero, and long chains drift).
// - mma.sync and not wgmma: the tools K3 already has working.  Fed by
//   ldmatrix, every warp reads the whole A tile, 256 B of shared memory an
//   mma, which caps the products near half the tensor peak; the round-1
//   recompute and both LayerNorms stay on the CUDA cores either way.
//   wgmma with TMA, a group of 64 p-nodes one M tile, is the next step.
// - The elementwise phases round to T in pairs, one conversion for two
//   values (cvt to bf16x2 / f16x2).
// - Shared memory holds 16-bit tiles as [row][channel + 8]: rows of 272 B,
//   ≡ 16 mod 128, put 8 consecutive rows in distinct banks for ldmatrix
//   and stmatrix.  The weights stay [in][out] as the wrapper stacks them;
//   ldmatrix.trans turns them into B fragments.
// - Each of the 8 warps owns 16 output channels of all 64 rows of a
//   product, so its B fragments (32 registers) load once a product; in
//   pass B they stay in registers for the whole row.
// - Two blocks an SM (111 KB of shared memory, at most 128 registers a
//   thread): one block's elementwise phases and syncs overlap the other's
//   products and output stores, and 512 rows take 2 waves of 264 blocks.
// - The epilogue relu(T(lift2[a] + T(acc))) runs in float32 on the
//   fragments, packs to T, goes through shared memory (stmatrix), and
//   leaves as 16-byte stores: a group's 64 p-nodes are 16 KB contiguous in
//   the output, every 32-byte sector written whole.
//
// float32 path: the products on the CUDA cores (TF32 would break float32's
// 1e-4 tolerance), 512 threads, one block an SM, 4 × 4 outputs a thread.
#include "mma.cuh"

using namespace palace;

namespace {

constexpr int kF = 64;              // f-nodes (a row's p-nodes form 64 groups of 64)
constexpr int kPn = kF * kF;        // p-nodes
constexpr int kGd = 128;            // channels
constexpr int kD3 = 3;              // lifted input width
constexpr int kThreads = 512;       // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kXtStride = 68;       // floats per row of the transposed tile (float4 stores
                                    // from 32 lanes stay free of bank conflicts)
// rows of the stacked weights (ops/kernels.py sage_rounds)
constexpr int kRowWl2 = 3 * kD3;
constexpr int kRowWl11 = kRowWl2 + kGd;
constexpr int kRowWr11 = kRowWl11 + kGd;
constexpr int kRowBias = kRowWr11 + kGd;  // b1, b2, b11, ln scale, ln bias

// small[] rows
constexpr int kWr1 = 0, kWl1 = 3, kWr2f = 6, kB1 = 9, kB2 = 10, kB11 = 11, kLnS = 12, kLnB = 13;

struct Smem {
  float w[kGd][kGd];         // Wl2, then Wl11, then Wr11
  float lift1[kF][kGd];      // round-1 lifted f-nodes
  float a[kF][kGd];          // agg, then round-2 lifted f-nodes
  float xt[kGd][kXtStride];  // x_f1 / x_f1n ([kF][kGd] view), then pass B's tile
  float small[14][kGd];      // Wr1, Wl1, Wr2f (3 rows each), b1, b2, b11, ln scale, ln bias
  float xf0[kF][kD3];
};

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int n, int t) {
  for (int e = t; e < n; e += kThreads) dst[e] = to_f(src[e]);
}

// LayerNorm of 128 values held 4 per lane (channels lane + 32·i), in float32
__device__ __forceinline__ void layer_norm4(float v[4], const Smem& s, int lane) {
  const float mu = warp_sum(v[0] + v[1] + v[2] + v[3]) * (1.0f / kGd);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) sq += (v[i] - mu) * (v[i] - mu);
  const float r = rsqrtf(warp_sum(sq) * (1.0f / kGd) + 1e-5f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    v[i] = (v[i] - mu) * r * s.small[kLnS][c] + s.small[kLnB][c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) sage_rounds_kernel(
    const T* __restrict__ xp, const T* __restrict__ xf, const T* __restrict__ w,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T* xpb = xp + (size_t)blockIdx.x * kPn * kD3;
  const T* xfb = xf + (size_t)blockIdx.x * kF * kD3;
  T* ob = out + (size_t)blockIdx.x * kPn * kGd;

  load_rows(&s.small[0][0], w, 3 * kD3 * kGd, t);
  load_rows(&s.small[kB1][0], w + (size_t)kRowBias * kGd, 5 * kGd, t);
  load_rows(&s.xf0[0][0], xfb, kF * kD3, t);
  __syncthreads();

  // threads (c, h): channel c, rows h, h+4, ... of the f-node side
  const int c = t & (kGd - 1), h = t >> 7;
  for (int a = h; a < kF; a += 4) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kD3; ++k) acc = fmaf(s.xf0[a][k], s.small[kWl1 + k][c], acc);
    s.lift1[a][c] = rnd<T>(acc + s.small[kB1][c]);
  }
  __syncthreads();

  // pass A: agg[j] = mean over a of x_p1[64a + j]
  {
    const float w0 = s.small[kWr1][c], w1 = s.small[kWr1 + 1][c], w2 = s.small[kWr1 + 2][c];
    for (int j = h; j < kF; j += 4) {
      float acc = 0.f;
      for (int a = 0; a < kF; ++a) {
        const T* x = xpb + (a * kF + j) * kD3;
        const float r = rnd<T>(fmaf(to_f(x[2]), w2, fmaf(to_f(x[1]), w1, to_f(x[0]) * w0)));
        acc += fmaxf(rnd<T>(s.lift1[a][c] + r), 0.f);
      }
      s.a[j][c] = rnd<T>(acc * (1.0f / kF));
    }
  }
  load_rows(&s.w[0][0], w + (size_t)kRowWl2 * kGd, kGd * kGd, t);
  __syncthreads();

  // f-node update: x_f1[j] = relu(T(agg[j]·Wl2) + b2 + T(x_f0[j]·Wr2f))
  float* xf1 = &s.xt[0][0];  // [kF][kGd]
  for (int j = h; j < kF; j += 4) {
    float acc = 0.f;
    for (int k = 0; k < kGd; ++k) acc = fmaf(s.a[j][k], s.w[k][c], acc);
    float acc2 = 0.f;
#pragma unroll
    for (int k = 0; k < kD3; ++k) acc2 = fmaf(s.xf0[j][k], s.small[kWr2f + k][c], acc2);
    const float v = rnd<T>(rnd<T>(rnd<T>(acc) + s.small[kB2][c]) + rnd<T>(acc2));
    xf1[j * kGd + c] = fmaxf(v, 0.f);
  }
  __syncthreads();

  // x_f1n = T(LayerNorm(x_f1)), one warp per row
  for (int j = warp; j < kF; j += kWarps) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = xf1[j * kGd + lane + 32 * i];
    layer_norm4(v, s, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) xf1[j * kGd + lane + 32 * i] = rnd<T>(v[i]);
  }
  load_rows(&s.w[0][0], w + (size_t)kRowWl11 * kGd, kGd * kGd, t);
  __syncthreads();

  // lift2[j] = T(x_f1n[j]·Wl11 + b11), over agg's buffer
  for (int j = h; j < kF; j += 4) {
    float acc = 0.f;
    for (int k = 0; k < kGd; ++k) acc = fmaf(xf1[j * kGd + k], s.w[k][c], acc);
    s.a[j][c] = rnd<T>(acc + s.small[kB11][c]);
  }
  __syncthreads();
  load_rows(&s.w[0][0], w + (size_t)kRowWr11 * kGd, kGd * kGd, t);
  __syncthreads();

  // pass B: group a = p-nodes 64a .. 64a+63, all reading f-node a
  const int tc = (t & 31) * 4;   // output channels tc .. tc+3
  const int tn = (t >> 5) * 4;   // tile nodes tn .. tn+3
  for (int a = 0; a < kF; ++a) {
    // warp `warp` recomputes and normalises nodes 4·warp .. 4·warp+3 of the tile
    {
      float v[4][4];  // [node][channel lane + 32·i]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T* x = xpb + (a * kF + warp * 4 + q) * kD3;
        const float x0 = to_f(x[0]), x1 = to_f(x[1]), x2 = to_f(x[2]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cc = lane + 32 * i;
          const float r = rnd<T>(fmaf(x2, s.small[kWr1 + 2][cc],
                                      fmaf(x1, s.small[kWr1 + 1][cc], x0 * s.small[kWr1][cc])));
          v[q][i] = fmaxf(rnd<T>(s.lift1[a][cc] + r), 0.f);
        }
        layer_norm4(v[q], s, lane);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&s.xt[lane + 32 * i][warp * 4]) = make_float4(
            rnd<T>(v[0][i]), rnd<T>(v[1][i]), rnd<T>(v[2][i]), rnd<T>(v[3][i]));
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kGd; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&s.xt[k][tn]);
      const float4 wv = *reinterpret_cast<const float4*>(&s.w[k][tc]);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][i] = fmaf(xs[q], ws[i], acc[q][i]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = fmaxf(rnd<T>(s.a[a][tc + i] + rnd<T>(acc[q][i])), 0.f);
      store4(ob + (size_t)(a * kF + tn + q) * kGd + tc, o);
    }
    __syncthreads();  // the next group overwrites the tile
  }
}

template <typename T>
int launch(const void* xp, const void* xf, const void* w, void* out, int B, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(sage_rounds_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sage_rounds_kernel<T><<<B, kThreads, smem, stream>>>((const T*)xp, (const T*)xf,
                                                       (const T*)w, (T*)out);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kPitch = kGd + 8;     // elements a 16-bit shared row: 272 B
constexpr int kMmaThreads = 256;    // 8 warps, each 16 output channels of a product
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kBlocksPerSM = 2;
constexpr int kKSteps = kGd / 16;   // k16 steps of a 128-deep product
constexpr int kMTiles = kF / 16;    // m16 tiles of 64 rows

struct SmemMma {
  uint16_t w[kGd][kPitch];     // Wl2, then Wl11, then Wr11, [in][out]
  uint16_t xa[kF][kPitch];     // x_f1, x_f1n, then pass B's x_p1n tile: [node][channel]
  uint16_t fa[kF][kPitch];     // agg, then lift2
  uint16_t st[kF][kPitch];     // pass B's output, staged
  uint16_t lift1[kF][kGd];
  float small[14][kGd];        // Wr1, Wl1, Wr2f (3 rows each), b1, b2, b11, ln scale, ln bias
  float xf0[kF][kD3];
};
static_assert(sizeof(SmemMma) % 16 == 0, "16-byte rows");
static_assert(kBlocksPerSM * (sizeof(SmemMma) + 1024) <= 233472, "two blocks an SM");

// the low 16 bits of b, a value of T, in float32
template <typename T> __device__ __forceinline__ float from_bits(uint32_t b) {
  const uint16_t h = (uint16_t)b;
  return to_f(*reinterpret_cast<const T*>(&h));
}
// four consecutive T values (8 bytes) → float32
template <typename T> __device__ __forceinline__ void unpack4(uint2 u, float v[4]) {
  v[0] = from_bits<T>(u.x);
  v[1] = from_bits<T>(u.x >> 16);
  v[2] = from_bits<T>(u.y);
  v[3] = from_bits<T>(u.y >> 16);
}
// a and b rounded to T, with one conversion for the pair
template <typename T> __device__ __forceinline__ void rnd2(float& a, float& b) {
  const uint32_t p = pack2<T>(a, b);
  a = from_bits<T>(p);
  b = from_bits<T>(p >> 16);
}
template <typename T> __device__ __forceinline__ uint2 pack4(const float v[4]) {
  return make_uint2(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]));
}

// A 128 × 128 weight [in][out] in device memory → w, 16 bytes a copy
__device__ __forceinline__ void load_weight(uint16_t (*w)[kPitch], const uint16_t* src) {
  for (int e = threadIdx.x; e < kGd * (kGd / 8); e += kMmaThreads) {
    const int r = e / (kGd / 8), ch = e % (kGd / 8);
    cp_async16(&w[r][ch * 8], src + r * kGd + ch * 8, 16);
  }
  cp_async_commit();
}

// The B fragments of output channels nbase .. nbase+15 of a weight [in][out]:
// per k16 step, ldmatrix.trans of (k 0-7 / 8-15) × (n 0-7 / 8-15) gives
// n8 block 0's two registers, then n8 block 1's.
__device__ __forceinline__ void load_b(uint32_t (&b)[kKSteps][4], const uint16_t (*w)[kPitch],
                                       int nbase, int lane) {
  const uint32_t addr = smem_addr(&w[((lane >> 3) & 1) * 8 + (lane & 7)][nbase + (lane >> 4) * 8]);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) ldmatrix_x4_trans(b[ks], addr + ks * 16 * kPitch * 2);
}

// dst[row][col, col + 1] = f(row, col, k, acc[col], acc[col + 1]), a pair
// of T packed in 32 bits, for acc = a (64 × 128, [row][k]) · b, the warp's
// 16 output channels nbase .. of a weight (b its B fragments, load_b).  Two
// m16 tiles at a time, 2 × 2 blocks of m16n8 accumulators; each output's
// sum is one chain of 8 mma.  The epilogue goes through stmatrix: fragment
// (mi, nj) holds rows mi·16 + g, + 8 and columns nbase + nj·8 + 2q, + 1
// (g = lane / 4, q = lane % 4); k = 2·nj names the pair among the lane's
// four columns.
template <typename T, typename F>
__device__ __forceinline__ void product(uint16_t (*dst)[kPitch], const uint16_t (*a)[kPitch],
                                        const uint32_t (&b)[kKSteps][4], int nbase, int lane,
                                        F f) {
  constexpr float kZero[4] = {0.f, 0.f, 0.f, 0.f};
  const int g = lane >> 2, q = lane & 3;
  const uint32_t a_addr = smem_addr(&a[lane & 15][(lane >> 4) * 8]);
#pragma unroll
  for (int m0 = 0; m0 < kMTiles; m0 += 2) {
    float acc[2][2][4];
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t af[4];
        ldmatrix_x4(af, a_addr + ((m0 + i) * 16 * kPitch + ks * 16) * 2);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          MmaType<T>::mma(acc[i][nj], af, b[ks][2 * nj], b[ks][2 * nj + 1],
                          ks ? acc[i][nj] : kZero);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mi = m0 + i;
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // matrix j: n8 block j / 2, rows h·8.. with h = j % 2
        const int nj = j >> 1, h = j & 1;
        const int row = mi * 16 + h * 8 + g, col = nbase + nj * 8 + 2 * q;
        r[j] = f(row, col, 2 * nj, acc[i][nj][2 * h], acc[i][nj][2 * h + 1]);
      }
      stmatrix_x4(
          smem_addr(&dst[mi * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)][nbase + (lane >> 4) * 8]), r);
    }
  }
}

// LayerNorm of 128 values held 4 per lane (channels 4·lane ..), in float32
__device__ __forceinline__ void layer_norm_4c(float v[4], const float lns[4], const float lnb[4]) {
  const float mu = warp_sum(v[0] + v[1] + v[2] + v[3]) * (1.0f / kGd);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) sq += (v[i] - mu) * (v[i] - mu);
  const float r = rsqrtf(warp_sum(sq) * (1.0f / kGd) + 1e-5f);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = (v[i] - mu) * r * lns[i] + lnb[i];
}

template <typename T>
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSM) sage_mma_kernel(
    const T* __restrict__ xp, const T* __restrict__ xf, const T* __restrict__ w_,
    T* __restrict__ out_) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemMma& s = *reinterpret_cast<SmemMma*>(smem_raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c4 = 4 * lane;         // the 4 channels of a lane in the elementwise phases
  const int nbase = 16 * warp;     // the 16 output channels of a warp in the products
  const T* xpb = xp + (size_t)blockIdx.x * kPn * kD3;
  const T* xfb = xf + (size_t)blockIdx.x * kF * kD3;
  const uint16_t* w = reinterpret_cast<const uint16_t*>(w_);
  uint16_t* ob = reinterpret_cast<uint16_t*>(out_) + (size_t)blockIdx.x * kPn * kGd;

  load_weight(s.w, w + (size_t)kRowWl2 * kGd);  // in flight through pass A
  for (int e = t; e < 3 * kD3 * kGd; e += kMmaThreads) (&s.small[0][0])[e] = to_f(w_[e]);
  for (int e = t; e < 5 * kGd; e += kMmaThreads)
    (&s.small[kB1][0])[e] = to_f(w_[(size_t)kRowBias * kGd + e]);
  for (int e = t; e < kF * kD3; e += kMmaThreads) (&s.xf0[0][0])[e] = to_f(xfb[e]);
  __syncthreads();

  float wr1[kD3][4], lns[4], lnb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < kD3; ++k) wr1[k][i] = s.small[kWr1 + k][c4 + i];
    lns[i] = s.small[kLnS][c4 + i];
    lnb[i] = s.small[kLnB][c4 + i];
  }
  // round 1's p-node values of channels c4 .. c4+3 for p-node n of group a
  auto round1 = [&](int n, const float l1[4], float v[4]) {
    const T* x = xpb + n * kD3;
    const float x0 = to_f(x[0]), x1 = to_f(x[1]), x2 = to_f(x[2]);
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = fmaf(x2, wr1[2][i], fmaf(x1, wr1[1][i], x0 * wr1[0][i]));
    rnd2<T>(r[0], r[1]);
    rnd2<T>(r[2], r[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = l1[i] + r[i];
    rnd2<T>(v[0], v[1]);
    rnd2<T>(v[2], v[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
  };

  // lift1 = T(x_f0·Wl1 + b1): thread (c, h) takes channel c of rows h, h + 2, ..
  {
    const int c = t & (kGd - 1);
    for (int a = t >> 7; a < kF; a += kMmaThreads / kGd) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kD3; ++k) acc = fmaf(s.xf0[a][k], s.small[kWl1 + k][c], acc);
      s.lift1[a][c] = (uint16_t)bits<T>(acc + s.small[kB1][c]);
    }
  }
  __syncthreads();

  // pass A: agg[j] = mean over a of x_p1[64a + j], warp j, j + 8, ..
  for (int j = warp; j < kF; j += kMmaWarps) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int a = 0; a < kF; ++a) {
      float l1[4], v[4];
      unpack4<T>(*reinterpret_cast<const uint2*>(&s.lift1[a][c4]), l1);
      round1(a * kF + j, l1, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += v[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= 1.0f / kF;
    *reinterpret_cast<uint2*>(&s.fa[j][c4]) = pack4<T>(acc);
  }
  cp_async_wait_all();
  __syncthreads();

  // f-node update: x_f1[j] = relu(T(agg[j]·Wl2) + b2 + T(x_f0[j]·Wr2f))
  uint32_t bfrag[kKSteps][4];
  load_b(bfrag, s.w, nbase, lane);
  __syncthreads();  // every warp holds its Wl2 fragments: w is free
  load_weight(s.w, w + (size_t)kRowWl11 * kGd);
  auto f_node = [&](int j, int c, float v) {
    float v2 = 0.f;
#pragma unroll
    for (int k = 0; k < kD3; ++k) v2 = fmaf(s.xf0[j][k], s.small[kWr2f + k][c], v2);
    return fmaxf(rnd<T>(rnd<T>(rnd<T>(v) + s.small[kB2][c]) + rnd<T>(v2)), 0.f);
  };
  product<T>(s.xa, s.fa, bfrag, nbase, lane, [&](int j, int c, int, float v0, float v1) {
    return pack2<T>(f_node(j, c, v0), f_node(j, c + 1, v1));
  });
  __syncthreads();

  // x_f1n = T(LayerNorm(x_f1)), a warp a row
  for (int j = warp; j < kF; j += kMmaWarps) {
    float v[4];
    unpack4<T>(*reinterpret_cast<const uint2*>(&s.xa[j][c4]), v);
    layer_norm_4c(v, lns, lnb);
    *reinterpret_cast<uint2*>(&s.xa[j][c4]) = pack4<T>(v);
  }
  cp_async_wait_all();
  __syncthreads();

  // lift2[j] = T(x_f1n[j]·Wl11 + b11), over agg's buffer
  load_b(bfrag, s.w, nbase, lane);
  __syncthreads();  // w is free
  load_weight(s.w, w + (size_t)kRowWr11 * kGd);
  product<T>(s.fa, s.xa, bfrag, nbase, lane, [&](int, int c, int, float v0, float v1) {
    return pack2<T>(v0 + s.small[kB11][c], v1 + s.small[kB11][c + 1]);
  });
  cp_async_wait_all();
  __syncthreads();
  load_b(bfrag, s.w, nbase, lane);  // Wr11's fragments, for all of pass B

  // pass B: group a = p-nodes 64a .. 64a+63, all reading f-node a.  Warp w
  // recomputes and normalises nodes 8w .. 8w+7 of the group into xa; the
  // product and its epilogue go to st, which the block then writes out.
  const int q = lane & 3;
  for (int a = 0; a < kF; ++a) {
    float l1[4];
    unpack4<T>(*reinterpret_cast<const uint2*>(&s.lift1[a][c4]), l1);
#pragma unroll
    for (int n0 = 0; n0 < 8; n0 += 4) {
      float v[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) round1(a * kF + 8 * warp + n0 + u, l1, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        layer_norm_4c(v[u], lns, lnb);
        *reinterpret_cast<uint2*>(&s.xa[8 * warp + n0 + u][c4]) = pack4<T>(v[u]);
      }
    }
    __syncthreads();

    float l2[4];  // lift2[a] at the lane's four output channels
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const uint32_t p = *reinterpret_cast<const uint32_t*>(&s.fa[a][nbase + nj * 8 + 2 * q]);
      l2[2 * nj] = from_bits<T>(p);
      l2[2 * nj + 1] = from_bits<T>(p >> 16);
    }
    product<T>(s.st, s.xa, bfrag, nbase, lane, [&](int, int, int k, float v0, float v1) {
      rnd2<T>(v0, v1);
      return pack2<T>(fmaxf(l2[k] + v0, 0.f), fmaxf(l2[k + 1] + v1, 0.f));
    });
    __syncthreads();

    // the group's 64 × 128 outputs are 16 KB contiguous: 16-byte stores
    uint16_t* og = ob + (size_t)a * kF * kGd;
#pragma unroll
    for (int i = 0; i < kF * (kGd / 8) / kMmaThreads; ++i) {
      const int e = t + i * kMmaThreads, r = e >> 4, ch = e & 15;
      *reinterpret_cast<uint4*>(og + r * kGd + ch * 8) =
          *reinterpret_cast<const uint4*>(&s.st[r][ch * 8]);
    }
  }
}

template <typename T>
int launch_mma(const void* xp, const void* xf, const void* w, void* out, int B,
               cudaStream_t stream) {
  auto kernel = sage_mma_kernel<T>;
  const int smem = (int)sizeof(SmemMma);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kMmaThreads, smem, stream>>>((const T*)xp, (const T*)xf, (const T*)w, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// xp (B, 4096, 3), xf (B, 64, 3), w (3·3 + 3·128 + 5, 128) 16-byte aligned,
// out (B, 4096, 128)
extern "C" int palace_sage_rounds(const void* xp, const void* xf, const void* w, void* out,
                                  int B, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch<float>(xp, xf, w, out, B, s);
    case kBF16: return launch_mma<__nv_bfloat16>(xp, xf, w, out, B, s);
    case kF16: return launch_mma<__half>(xp, xf, w, out, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
