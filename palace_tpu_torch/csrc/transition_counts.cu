// K1: 3-mer transition counts, fused with the 2-bit unpack and the
// ×100/len scale.  Replaces transition_counts_pallas
// (palace_tpu/ops/pallas_kernels.py) and the unpack and scale around it
// (palace_tpu/ops/encoder.py features_from_packed).
//
// For d ∈ {0,1,2}: M_d[u,v] = #{i < n_locs − 3 − d : loc[i] = u,
// loc[i+3+d] = v}, with loc[i] = 16·c[i] + 4·c[i+1] + c[i+2] over the
// row's base codes c and n_locs = max(n_codes − 2, 0).  Output row b is
// the three flattened matrices times 100 / max(seq_len[b], 1), float32.
//
// Bound on the H100: bytes (the 48 KiB float32 output row per contig);
// shared-memory atomics set the pace in practice.  One block per contig
// row keeps the 3 × 4096 int32 bins in 48 KiB of dynamic shared memory;
// each thread unpacks the codes it needs from the packed row (served from
// L1), so the one-hot matrices of the TPU kernel never exist.
#include "common.cuh"

using namespace palace;

namespace {

constexpr int kCodes = 64;
constexpr int kMat = kCodes * kCodes;
constexpr int kBins = 3 * kMat;
constexpr int kThreads = 512;

__device__ __forceinline__ int base_at(const uint8_t* row, int j) {
  return (row[j >> 2] >> ((j & 3) * 2)) & 3;
}

__device__ __forceinline__ int loc_at(const uint8_t* row, int i) {
  return base_at(row, i) * 16 + base_at(row, i + 1) * 4 + base_at(row, i + 2);
}

__global__ void __launch_bounds__(kThreads) transition_features_kernel(
    const uint8_t* __restrict__ packed, const int* __restrict__ n_codes,
    const int* __restrict__ seq_lens, float* __restrict__ out, int P) {
  extern __shared__ int hist[];
  const int b = blockIdx.x;
  const uint8_t* row = packed + (size_t)b * P;
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) hist[k] = 0;
  __syncthreads();

  // codes beyond the packed row do not exist: clamp, so no read leaves it
  const int nc = min(n_codes[b], 4 * P);
  const int n_locs = max(nc - 2, 0);
  // pair (i, i+shift) is valid iff i < n_locs − shift (encode.pyx:33)
  for (int i = threadIdx.x; i < n_locs - 3; i += blockDim.x) {
    const int src = loc_at(row, i) * kCodes;
    atomicAdd(&hist[src + loc_at(row, i + 3)], 1);
    if (i < n_locs - 4) atomicAdd(&hist[kMat + src + loc_at(row, i + 4)], 1);
    if (i < n_locs - 5) atomicAdd(&hist[2 * kMat + src + loc_at(row, i + 5)], 1);
  }
  __syncthreads();

  // IEEE division (no fast math): equal to 100.0 / max(len, 1.0) in float32
  const float scale = 100.0f / fmaxf((float)seq_lens[b], 1.0f);
  float* o = out + (size_t)b * kBins;
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) o[k] = (float)hist[k] * scale;
}

}  // namespace

extern "C" int palace_transition_features(const void* packed, const void* n_codes,
                                          const void* seq_lens, void* out, int B, int P,
                                          void* stream) {
  const int smem = kBins * (int)sizeof(int);  // 49,152 bytes
  cudaError_t err = cudaFuncSetAttribute(
      transition_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  transition_features_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int*)n_codes, (const int*)seq_lens, (float*)out, P);
  return (int)cudaGetLastError();
}
