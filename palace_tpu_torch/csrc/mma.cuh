// Tensor-core building blocks shared by the kernels (K2, K3): mma.sync
// m16n8k16 (bf16, f16) and m16n8k8 (TF32) with float32 accumulators, the
// TF32 rounding and the 3×TF32 split, ldmatrix / stmatrix between shared
// memory and the 16-bit mma fragments, cp.async copies, and packing of
// float32 values into 16-bit pairs.
#pragma once

#include "common.cuh"

namespace palace {

template <typename T> struct MmaType;
template <> struct MmaType<__nv_bfloat16> {
  // d = a·b + c
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                             uint32_t b1, const float* c) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  }
};
template <> struct MmaType<__half> {
  // d = a·b + c
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                             uint32_t b1, const float* c) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  }
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero; the result is a float32 bit pattern whose low 13 bits are 0
__device__ __forceinline__ uint32_t cvt_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small + r: big is x rounded to TF32, small the rest rounded to
// TF32, |r| <= 2^-22 |x| (the 3×TF32 split of the float32 routes)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = cvt_tf32(x);
  small = cvt_tf32(x - __uint_as_float(big));
}

// d = a·b + d, m16n8k8 with TF32 operands (cvt_tf32) and float32
// accumulators.  Lane (g, q) = (lane / 4, lane % 4) holds a[0..3] = A[g][q],
// A[g + 8][q], A[g][q + 4], A[g + 8][q + 4]; b0 = B[q][g], b1 = B[q + 4][g];
// d[0..3] = D[g][2q], D[g][2q + 1], D[g + 8][2q], D[g + 8][2q + 1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8 × 8 matrices of 16-bit values from shared memory: lanes 8j..8j+7
// give the row addresses of matrix j; with .trans each lane receives its
// elements from the matrix's columns instead of its rows
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global → shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes global → shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 × 8 matrices of 16-bit values from the mma fragments to shared
// memory: lanes 8j..8j+7 give the row addresses of matrix j, whose rows
// are the fragment's rows, or with .trans its columns
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t* r) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t* r) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

template <typename T> __device__ __forceinline__ uint32_t bits(float v) {
  const T h = from_f<T>(v);
  return *reinterpret_cast<const uint16_t*>(&h);
}
// two float32 values rounded to T, the first in the low half: one conversion
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace palace
