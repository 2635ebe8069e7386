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
// float32 path (sage_tf32_kernel), the pipeline's default dtype: the same
// two passes, 64-node groups and warps of 16 output channels, and the same
// three products on the tensor cores through a 3×TF32 split.  One TF32
// product (10 mantissa bits) lands ~1e-3 from float32 and breaks float32's
// 1e-4 tolerance.  So each float32 operand x is split into big = tf32(x)
// and small = tf32(x - big), and each k8 step adds small·big, big·small
// and big·big (mma.sync m16n8k8 .tf32) into one float32 chain: 48 mma an
// output, each product exact, each sum rounded toward zero.  On an H100
// 80GB HBM3 at 700.00 W it lands within 7e-6 of the plain version (float32
// products) and of the float64 sums, no element beyond 1e-4 (chip_smoke.py).
// - Bounds for a batch of 512: bytes, the 1.07 GB float32 output and 25 MB
//   of inputs, 0.33 ms at 3.35 TB/s; the 3×TF32 products, 3 × 70.9 GFLOP
//   at TF32's 495 TFLOP/s, 0.43 ms, the bound this route is read against;
//   all 72.5 GFLOP on the CUDA cores at 67 TFLOP/s, 1.083 ms, the bound of
//   the CUDA-core kernel this route replaced.  mma.sync reaches about two
//   thirds of TF32's peak on that card, and the pass-B product holds the
//   tensor pipe: it is most of the time (tools/k2_float32.py variants).
// - Each warp reads the whole 64-row tile, so the tile is split once, as
//   the warps that produce it store it, into big and small planes; split
//   on load it would be split 8 times, once a warp.  The planes are
//   [row][channel + 8] uint32, rows of 544 B ≡ 32 mod 128: ldmatrix is a
//   16-bit instruction, so lane (g, q) loads a fragment row with one
//   8-byte ld.shared a plane, taking columns 2q, 2q + 1 of a k8 step as
//   the mma's k = q and q + 4 (the weight's B fragments take the same
//   rows), and a half-warp's 16 loads hit 32 distinct banks.
// - The weights live in no shared memory: each warp reads its 16 channels
//   × 128 of a weight from L2 and holds them split, 128 registers.
// - One block an SM (231,168 B of shared memory, up to 255 registers).
//   At 128 registers, two blocks an SM, the B fragments spill, and the
//   kernel ran slower.  So the block keeps what two blocks would have
//   overlapped from waiting: the row's x_p (48 KB) is staged in shared
//   memory, so no phase waits on device memory; pass B's tiles are two,
//   filled and multiplied in turn with one sync a group.
// - The epilogue relu(lift2[a] + acc) runs on the fragments and streams
//   each pair of outputs as 8 bytes (st.global.cs) straight to the output:
//   the four lanes of a quad write one whole 32-byte sector of a row.
#include "mma.cuh"

using namespace palace;

namespace {

constexpr int kF = 64;              // f-nodes (a row's p-nodes form 64 groups of 64)
constexpr int kPn = kF * kF;        // p-nodes
constexpr int kGd = 128;            // channels
constexpr int kD3 = 3;              // lifted input width
constexpr int kMmaThreads = 256;    // 8 warps, each 16 output channels of a product
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMTiles = kF / 16;    // m16 tiles of 64 rows
// rows of the stacked weights (ops/kernels.py sage_rounds)
constexpr int kRowWl2 = 3 * kD3;
constexpr int kRowWl11 = kRowWl2 + kGd;
constexpr int kRowWr11 = kRowWl11 + kGd;
constexpr int kRowBias = kRowWr11 + kGd;  // b1, b2, b11, ln scale, ln bias

// small[] rows
constexpr int kWr1 = 0, kWl1 = 3, kWr2f = 6, kB1 = 9, kB2 = 10, kB11 = 11, kLnS = 12, kLnB = 13;

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

// The kernel at the largest dynamic shared memory it asks for, and with
// the carveout that lets `blocks an SM` of them share one SM.
template <typename T>
int launch_blocks(void (*kernel)(const T*, const T*, const T*, T*), int smem, const void* xp,
                  const void* xf, const void* w, void* out, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kMmaThreads, smem, stream>>>((const T*)xp, (const T*)xf, (const T*)w, (T*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kPitch = kGd + 8;     // elements a 16-bit shared row: 272 B
constexpr int kBlocksPerSM = 2;
constexpr int kKSteps = kGd / 16;   // k16 steps of a 128-deep product

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

// ---------------------------------------------------------------------------
// float32: tensor cores through a 3×TF32 split
// ---------------------------------------------------------------------------

constexpr int kPitchF = kGd + 8;  // words a float32 tile row: 544 B, ≡ 32 mod 128
constexpr int kK8 = kGd / 8;      // k8 steps of a 128-deep product

// A 64-row float32 tile split for the tensor cores: big = tf32(x), small =
// tf32(x - big), [row][channel + 8]
struct Planes {
  uint32_t big[kF][kPitchF];
  uint32_t small[kF][kPitchF];
};
struct SmemF32 {
  float xp[kPn * kD3];    // the row's p-node inputs
  Planes tile[2];         // agg, x_f1n, then pass B's x_p1n tiles, two in turn;
                          // tile[1].big holds lift1 through pass A
  float fa[kF][kPitchF];  // x_f1, then lift2
  float small[14][kGd];   // Wr1, Wl1, Wr2f (3 rows each), b1, b2, b11, ln scale, ln bias
  float xf0[kF][kD3];
};
static_assert(sizeof(SmemF32) % 16 == 0 && sizeof(SmemF32) <= 232448, "one block an SM");

// channels c .. c+3 of row r of a tile, split
__device__ __forceinline__ void store_split4(Planes& p, int r, int c, const float v[4]) {
  uint4 b, l;
  split_tf32(v[0], b.x, l.x);
  split_tf32(v[1], b.y, l.y);
  split_tf32(v[2], b.z, l.z);
  split_tf32(v[3], b.w, l.w);
  *reinterpret_cast<uint4*>(&p.big[r][c]) = b;
  *reinterpret_cast<uint4*>(&p.small[r][c]) = l;
}

// The warp's B fragments of a 128 × 128 weight [in][out] in device memory,
// split: big[ks][nj][e], small[ks][nj][e] of W[8·ks + 2q + e][nbase + 8·nj + g],
// the two k of lane (g, q) in k8 step ks (product_tf32).  128 registers,
// read through L2 (every block reads the same 64 KB).
struct BFragsF32 {
  uint32_t big[kK8][2][2], small[kK8][2][2];
};
__device__ __forceinline__ void load_b_f32(BFragsF32& b, const float* __restrict__ w, int nbase,
                                           int lane) {
  const float* p = w + 2 * (lane & 3) * kGd + nbase + (lane >> 2);
#pragma unroll
  for (int ks = 0; ks < kK8; ++ks)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split_tf32(__ldg(p + (8 * ks + e) * kGd + 8 * nj), b.big[ks][nj][e], b.small[ks][nj][e]);
}

// acc = a (64 × 128, split) · W, the warp's 16 output channels nbase .. (b),
// on the tensor cores: each k8 step adds small·big, big·small and big·big
// into one float32 chain (48 mma an output; small·small, below 2^-22 of a
// product, is dropped).  Lane (g, q) takes columns 2q, 2q + 1 of a k8 step
// as the mma's k = q and q + 4, one 8-byte load a plane and fragment row;
// b holds the same two k.  Two m16 tiles at a time.  f(row, col, nj, v0,
// v1) takes outputs (row, col) and (row, col + 1), col = nbase + 8·nj + 2q.
template <typename F>
__device__ __forceinline__ void product_tf32(const Planes& a, const BFragsF32& b, int nbase,
                                             int lane, F f) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m0 = 0; m0 < kMTiles; m0 += 2) {
    float acc[2][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < kK8; ++ks)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (m0 + i) * 16 + g, k = 8 * ks + 2 * q;
        const uint2 bl = *reinterpret_cast<const uint2*>(&a.big[r][k]);
        const uint2 bh = *reinterpret_cast<const uint2*>(&a.big[r + 8][k]);
        const uint2 sl = *reinterpret_cast<const uint2*>(&a.small[r][k]);
        const uint2 sh = *reinterpret_cast<const uint2*>(&a.small[r + 8][k]);
        const uint32_t ab[4] = {bl.x, bh.x, bl.y, bh.y}, as[4] = {sl.x, sh.x, sl.y, sh.y};
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma_tf32(acc[i][nj], as, b.big[ks][nj][0], b.big[ks][nj][1]);
          mma_tf32(acc[i][nj], ab, b.small[ks][nj][0], b.small[ks][nj][1]);
          mma_tf32(acc[i][nj], ab, b.big[ks][nj][0], b.big[ks][nj][1]);
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f((m0 + i) * 16 + h * 8 + g, nbase + 8 * nj + 2 * q, nj, acc[i][nj][2 * h],
            acc[i][nj][2 * h + 1]);
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1) sage_tf32_kernel(
    const float* __restrict__ xp, const float* __restrict__ xf, const float* __restrict__ w,
    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemF32& s = *reinterpret_cast<SmemF32*>(smem_raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c4 = 4 * lane;         // the 4 channels of a lane in the elementwise phases
  const int nbase = 16 * warp;     // the 16 output channels of a warp in the products
  const float* xpb = xp + (size_t)blockIdx.x * kPn * kD3;
  const float* xfb = xf + (size_t)blockIdx.x * kF * kD3;
  float* ob = out + (size_t)blockIdx.x * kPn * kGd;

  for (int e = t; e < kPn * kD3 / 4; e += kMmaThreads) cp_async16(&s.xp[4 * e], xpb + 4 * e, 16);
  cp_async_commit();
  for (int e = t; e < 3 * kD3 * kGd; e += kMmaThreads) (&s.small[0][0])[e] = w[e];
  for (int e = t; e < 5 * kGd; e += kMmaThreads)
    (&s.small[kB1][0])[e] = w[(size_t)kRowBias * kGd + e];
  for (int e = t; e < kF * kD3; e += kMmaThreads) (&s.xf0[0][0])[e] = xfb[e];
  cp_async_wait_all();
  __syncthreads();

  auto w4 = [&](int row) { return *reinterpret_cast<const float4*>(&s.small[row][c4]); };
  // lift1[a] = x_f0[a]·Wl1 + b1 at channel c
  auto lift1_at = [&](int a, int c) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kD3; ++k) acc = fmaf(s.xf0[a][k], s.small[kWl1 + k][c], acc);
    return acc + s.small[kB1][c];
  };
  // round 1's p-node values of channels c4 .. c4+3 for p-node n of group a,
  // from lift1[a] and Wr1's rows
  auto round1 = [&](int n, const float l1[4], float4 r0, float4 r1, float4 r2, float v[4]) {
    const float x0 = s.xp[n * kD3], x1 = s.xp[n * kD3 + 1], x2 = s.xp[n * kD3 + 2];
    v[0] = fmaxf(l1[0] + fmaf(x2, r2.x, fmaf(x1, r1.x, x0 * r0.x)), 0.f);
    v[1] = fmaxf(l1[1] + fmaf(x2, r2.y, fmaf(x1, r1.y, x0 * r0.y)), 0.f);
    v[2] = fmaxf(l1[2] + fmaf(x2, r2.z, fmaf(x1, r1.z, x0 * r0.z)), 0.f);
    v[3] = fmaxf(l1[3] + fmaf(x2, r2.w, fmaf(x1, r1.w, x0 * r0.w)), 0.f);
  };
  auto ln4 = [&](float v[4]) {  // LayerNorm with the lane's scale and bias
    const float4 sc = w4(kLnS), bi = w4(kLnB);
    const float lns[4] = {sc.x, sc.y, sc.z, sc.w}, lnb[4] = {bi.x, bi.y, bi.z, bi.w};
    layer_norm_4c(v, lns, lnb);
  };

  // lift1, through pass A: thread (c, h) takes channel c of rows h, h + 2, ..
  float (*lift1)[kGd] = reinterpret_cast<float (*)[kGd]>(&s.tile[1].big[0][0]);
  for (int a = t >> 7; a < kF; a += kMmaThreads / kGd)
    lift1[a][t & (kGd - 1)] = lift1_at(a, t & (kGd - 1));
  __syncthreads();

  // pass A: agg[j] = mean over a of x_p1[64a + j], warp j, j + 8, ..
  {
    const float4 r0 = w4(kWr1), r1 = w4(kWr1 + 1), r2 = w4(kWr1 + 2);
    for (int j = warp; j < kF; j += kMmaWarps) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int a = 0; a < kF; ++a) {
        const float4 l = *reinterpret_cast<const float4*>(&lift1[a][c4]);
        const float l1[4] = {l.x, l.y, l.z, l.w};
        float v[4];
        round1(a * kF + j, l1, r0, r1, r2, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += v[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] *= 1.0f / kF;
      store_split4(s.tile[0], j, c4, acc);
    }
  }
  BFragsF32 bfrag;
  load_b_f32(bfrag, w + (size_t)kRowWl2 * kGd, nbase, lane);
  __syncthreads();

  // f-node update: x_f1[j] = relu(agg[j]·Wl2 + b2 + x_f0[j]·Wr2f)
  auto f_node = [&](int j, int c, float v) {
    float v2 = 0.f;
#pragma unroll
    for (int k = 0; k < kD3; ++k) v2 = fmaf(s.xf0[j][k], s.small[kWr2f + k][c], v2);
    return fmaxf(v + s.small[kB2][c] + v2, 0.f);
  };
  product_tf32(s.tile[0], bfrag, nbase, lane, [&](int j, int c, int, float v0, float v1) {
    *reinterpret_cast<float2*>(&s.fa[j][c]) = make_float2(f_node(j, c, v0), f_node(j, c + 1, v1));
  });
  load_b_f32(bfrag, w + (size_t)kRowWl11 * kGd, nbase, lane);
  __syncthreads();

  // x_f1n = LayerNorm(x_f1), a warp a row
  for (int j = warp; j < kF; j += kMmaWarps) {
    const float4 u = *reinterpret_cast<const float4*>(&s.fa[j][c4]);
    float v[4] = {u.x, u.y, u.z, u.w};
    ln4(v);
    store_split4(s.tile[0], j, c4, v);
  }
  __syncthreads();

  // lift2[j] = x_f1n[j]·Wl11 + b11, over x_f1's buffer
  product_tf32(s.tile[0], bfrag, nbase, lane, [&](int j, int c, int, float v0, float v1) {
    *reinterpret_cast<float2*>(&s.fa[j][c]) =
        make_float2(v0 + s.small[kB11][c], v1 + s.small[kB11][c + 1]);
  });
  load_b_f32(bfrag, w + (size_t)kRowWr11 * kGd, nbase, lane);  // Wr11's, for all of pass B

  // pass B: group a = p-nodes 64a .. 64a+63, all reading f-node a.  Warp w
  // recomputes and normalises nodes 8w .. 8w+7 of group a + 1 into one tile
  // while the block multiplies group a's tile: one sync a group.  Warps k
  // and k + 4 share an SM sub-partition, so warps 0-3 fill their rows
  // before they multiply and warps 4-7 after: each sub-partition runs one
  // warp's elementwise work beside the other's mma.  The epilogue streams a
  // group's outputs straight from the fragments (st.global.cs): a quad's 8
  // floats of a row are one whole 32-byte sector.
  auto elementwise = [&](int a, Planes& dst) {
    float l1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) l1[i] = lift1_at(a, c4 + i);
    const float4 r0 = w4(kWr1), r1 = w4(kWr1 + 1), r2 = w4(kWr1 + 2);
#pragma unroll
    for (int n0 = 0; n0 < 8; n0 += 4) {
      float v[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) round1(a * kF + 8 * warp + n0 + u, l1, r0, r1, r2, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ln4(v[u]);
        store_split4(dst, 8 * warp + n0 + u, c4, v[u]);
      }
    }
  };
  __syncthreads();  // tile[0] is free, and lift2 is in fa
  elementwise(0, s.tile[0]);
  __syncthreads();
  const int q = lane & 3;
  const bool fill_first = warp < kMmaWarps / 2;
  for (int a = 0; a < kF; ++a) {
    const bool more = a + 1 < kF;
    if (more && fill_first) elementwise(a + 1, s.tile[(a + 1) & 1]);
    float2 l2[2];  // lift2[a] at the lane's four output channels
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      l2[nj] = *reinterpret_cast<const float2*>(&s.fa[a][nbase + 8 * nj + 2 * q]);
    float* og = ob + (size_t)a * kF * kGd;
    product_tf32(s.tile[a & 1], bfrag, nbase, lane, [&](int r, int c, int nj, float v0, float v1) {
      __stcs(reinterpret_cast<float2*>(og + r * kGd + c),
             make_float2(fmaxf(l2[nj].x + v0, 0.f), fmaxf(l2[nj].y + v1, 0.f)));
    });
    if (more && !fill_first) elementwise(a + 1, s.tile[(a + 1) & 1]);
    __syncthreads();  // group a + 2 overwrites this tile
  }
}

}  // namespace

// xp (B, 4096, 3), xf (B, 64, 3), w (3·3 + 3·128 + 5, 128) 16-byte aligned,
// out (B, 4096, 128)
extern "C" int palace_sage_rounds(const void* xp, const void* xf, const void* w, void* out,
                                  int B, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch_blocks<float>(sage_tf32_kernel, (int)sizeof(SmemF32), xp, xf, w, out, B, s);
    case kBF16:
      return launch_blocks<__nv_bfloat16>(sage_mma_kernel<__nv_bfloat16>, (int)sizeof(SmemMma),
                                          xp, xf, w, out, B, s);
    case kF16:
      return launch_blocks<__half>(sage_mma_kernel<__half>, (int)sizeof(SmemMma), xp, xf, w,
                                   out, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
