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
// Bound on the H100: bytes (the (B, 4096, 128) output).  A row's
// activations (1 MiB in bf16) do not fit in a block's shared memory as they
// fit in the TPU's VMEM, so the block makes two passes and recomputes the
// round-1 activations (input width 3, cheap) instead of storing them:
// pass A accumulates agg, the f-node side is finished in shared memory, and
// pass B recomputes round 1 for 64 p-nodes at a time, normalises them into a
// transposed shared tile, multiplies by Wr11 held in shared memory (4 × 4
// outputs per thread) and writes the output once.  The products run on the
// CUDA cores in float32.
#include "common.cuh"

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

}  // namespace

// xp (B, 4096, 3), xf (B, 64, 3), w (3·3 + 3·128 + 5, 128), out (B, 4096, 128)
extern "C" int palace_sage_rounds(const void* xp, const void* xf, const void* w, void* out,
                                  int B, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch<float>(xp, xf, w, out, B, s);
    case kBF16: return launch<__nv_bfloat16>(xp, xf, w, out, B, s);
    case kF16: return launch<__half>(xp, xf, w, out, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
