// K3: one layer of the scorer's conv head — Conv1d(k=8) + bias + relu,
// C input channels → 64 output channels — launched three times
// (128→64→64→64).  Replaces conv_head_pallas
// (palace_tpu/ops/pallas_kernels.py).
//
// out[b,o,p] = T(relu(Σ_{c,k} w[o,c,k]·x[b,c,p+k] + bias[o])), products
// accumulated in float32, bias and relu in float32, the result rounded to
// the working dtype T (as the TPU kernel casts after each layer).
//
// Bound on the H100: operations (about 548 GFLOP for the three layers at
// B=512).  A row's input (1 MiB in bf16) and the weights (256 KB in bf16)
// do not fit in a block's shared memory as they fit in the TPU's VMEM, so
// each block computes a 64-channel × 128-position output tile of one layer:
// 16-channel slices of the input tile (with its 7-column halo) and of the
// weights stream through shared memory, and each thread keeps a 4 × 8 tile
// of accumulators in registers, reusing each loaded input across the 8 taps.
// This first version runs on the CUDA cores in float32.
#include "common.cuh"

using namespace palace;

namespace {

constexpr int kOut = 64;       // output channels
constexpr int kTaps = 8;       // kernel width
constexpr int kTileP = 128;    // output positions per block
constexpr int kChunk = 16;     // input channels per shared-memory slice
constexpr int kXStride = 136;  // input columns per slice row (≥ 128 + 7, float4-aligned)
constexpr int kThreads = 256;

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

template <typename T>
int launch(const void* x, const void* wt, const void* bias, void* out, int B, int C,
           int L_in, cudaStream_t stream) {
  const int L_out = L_in - kTaps + 1;
  const dim3 grid((L_out + kTileP - 1) / kTileP, B);
  conv_layer_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)wt, (const T*)bias, (T*)out, C, L_in);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, C, L_in), wt (C, 8, 64), bias (64,), out (B, 64, L_in − 7); C % 16 == 0
extern "C" int palace_conv_layer(const void* x, const void* wt, const void* bias, void* out,
                                 int B, int C, int L_in, int dtype, void* stream) {
  if (B > 65535 || C % kChunk != 0 || L_in < kTaps) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case palace::kF32: return launch<float>(x, wt, bias, out, B, C, L_in, s);
    case palace::kBF16: return launch<__nv_bfloat16>(x, wt, bias, out, B, C, L_in, s);
    case palace::kF16: return launch<__half>(x, wt, bias, out, B, C, L_in, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
