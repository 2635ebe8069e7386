// Shared helpers of the port's CUDA kernels: the working dtypes and their
// rounding.  Kernels compute in float32 and round to the working dtype T
// (float, __nv_bfloat16 or __half) exactly where the TPU kernels cast with
// .astype(dt).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace palace {

// dtype codes passed from Python (ops/kernels.py _DTYPE_CODES)
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);  // round to nearest even
}

// v rounded to T and back: the TPU kernel's .astype(dt) on a float32 value
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// four consecutive values of T from float32, in one 16- or 8-byte store
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T> __device__ __forceinline__ void store4(T* p, const float v[4]) {
  __align__(8) T h[4];
  for (int i = 0; i < 4; ++i) h[i] = from_f<T>(v[i]);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace palace
