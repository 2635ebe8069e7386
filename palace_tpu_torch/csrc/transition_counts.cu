// K1: 3-mer transition counts, in two entries.
//
// palace_transition_features, the scorer's: straight from a batch of ASCII
// rows.  It replaces transition_counts_pallas (palace_tpu/ops/
// pallas_kernels.py) together with the host packing before it
// (palace_tpu/ops/encoder.py pack_contigs) and the unpack and scale around
// it (features_from_packed).
//
// palace_transition_counts_codes, at the Pallas kernel's own interface:
// padded (B, L) int32 3-mer codes and (B,) int32 n_locs → (B, 3, 64, 64)
// float32 M_d[u,v] = #{i : i + 3 + d < n, loc[i] = u, loc[i+3+d] = v} with
// n = min(n_locs, L); a pair with a code outside [0, 64) counts nothing.
// The codes need not be a sequence's overlapping 3-mers.  A row is cut
// into tiles of `tile` codes, one block a tile; a block turns its codes
// and the 5 past its tile into bytes in shared memory (a bad code as
// kBadCode) and counts them as the byte entry does, into its shared
// histogram through the last-4-bins register cache.  A row of one tile
// stores its histogram as float32; a row of several adds its non-zero
// bins into its output row, zeroed before and held as int32, and the last
// of its tiles to finish converts it in place.  Integer work: the result
// equals the plain version bit for bit.
//
// The byte entry in detail:
// Input: the rows' bytes concatenated, row b = data[offsets[b],
// offsets[b+1]), and each row's length in characters (seq_lens).  Bytes
// other than ACGTacgt are dropped, shifting positions (encode.pyx:8-20);
// the kept bases give the row's codes c[0..n).  For d ∈ {0,1,2}:
// M_d[u,v] = #{i : i + 5 + d < n, loc[i] = u, loc[i+3+d] = v}, with
// loc[i] = 16·c[i] + 4·c[i+1] + c[i+2].  Output row b is the three
// flattened matrices times 100 / max(seq_len[b], 1), float32.
//
// Bound on the H100: bytes (the ASCII in, the 48 KiB float32 row out).
// Design:
// - A row is cut into tiles of `tile` bytes, one block a tile, so a long
//   row spreads over many SMs and short rows are not padded.  A plan pass
//   gives each row its first tile (one block scans the rows) and zeroes
//   the output rows that span several tiles.
// - A block compacts its bytes in chunks of 8 KiB into shared memory (a
//   block prefix sum over 16 bytes a thread) and reads on past its tile
//   until it holds the 7 codes that the windows of its last positions
//   need, or the row ends.  Positions are counted by the tile that holds
//   their first code, so no compacted stream goes to device memory and no
//   scan runs across blocks.
// - Each thread counts 16 consecutive positions and keeps the last 4 bins
//   of each gap with their pending counts in registers, adding to the
//   shared 3 × 4096 int32 histogram only when a bin leaves: a
//   low-complexity row (poly-A, (AT)n) would otherwise send every atomic
//   of a warp to one or two bins.
// - A row of one tile scales its histogram into its output row.  A row of
//   several tiles adds each tile's non-zero bins into its output row, held
//   as int32, and the last of its tiles to finish scales it in place.
// Counts are integers and the scale an IEEE division (no fast math), so
// the result equals the plain version bit for bit.
#include "common.cuh"

namespace {

constexpr int kCodes = 64;
constexpr int kMat = kCodes * kCodes;
constexpr int kBins = 3 * kMat;
constexpr int kThreads = 512;
constexpr int kChunk = 16 * kThreads;  // bytes compacted a step
constexpr int kBuf = kChunk + 64;      // codes: up to 7 kept + a chunk + window reads
constexpr int kPlanThreads = 256;
constexpr int kMaxCodeTile = 65536;  // codes a block of the codes entry

__device__ __forceinline__ int tiles_of(int64_t len, int tile) {
  return len > tile ? (int)((len + tile - 1) / tile) : 1;
}

// row b's bytes [lo, hi), held inside data[0, n_bytes) so that no read
// leaves it whatever the offsets say
struct Span {
  int64_t lo, hi;
};
__device__ __forceinline__ Span row_span(const int64_t* offsets, int b, int64_t n_bytes) {
  const int64_t lo = min(max(offsets[b], (int64_t)0), n_bytes);
  return {lo, min(max(offsets[b + 1], lo), n_bytes)};
}

// Block 0: tile_first[b] = tiles of the rows before b, tile_first[B] = all.
// Block 1 + b: done[b] = 0 and, for a row of several tiles, its output
// row zeroed as the int32 sum the tiles add into.
__global__ void __launch_bounds__(kPlanThreads) plan_kernel(
    const int64_t* __restrict__ offsets, int* __restrict__ tile_first, int* __restrict__ done,
    float* __restrict__ out, int B, int64_t n_bytes, int tile) {
  if (blockIdx.x > 0) {
    const int b = blockIdx.x - 1;
    const Span row = row_span(offsets, b, n_bytes);
    if (threadIdx.x == 0) done[b] = 0;
    if (row.hi - row.lo > tile) {
      int4* o = reinterpret_cast<int4*>(out + (size_t)b * kBins);
      for (int k = threadIdx.x; k < kBins / 4; k += blockDim.x) o[k] = make_int4(0, 0, 0, 0);
    }
    return;
  }
  __shared__ int warp_excl[kPlanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  for (int base = 0; base < B; base += kPlanThreads) {
    const int b = base + threadIdx.x;
    int n = 0;
    if (b < B) {
      const Span row = row_span(offsets, b, n_bytes);
      n = tiles_of(row.hi - row.lo, tile);
    }
    int incl = n;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_excl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < kPlanThreads / 32 ? warp_excl[lane] : 0;
      int s = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += u;
      }
      if (lane < kPlanThreads / 32) warp_excl[lane] = s - v;
    }
    __syncthreads();
    const int excl = carry + warp_excl[warp] + incl - n;
    if (b < B) tile_first[b] = excl;
    __syncthreads();
    if (threadIdx.x == kPlanThreads - 1) carry = excl + n;
    __syncthreads();
  }
  if (threadIdx.x == 0) tile_first[B] = carry;
}

// The last 4 bins one thread counted into and their pending counts.
struct Recent {
  int bin[4], n[4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < 4; ++k) bin[k] = -1, n[k] = 0;
  }
  __device__ __forceinline__ void add(int* hist, int b) {
    bool hit = false;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (!hit && bin[k] == b) ++n[k], hit = true;
    if (hit) return;
    if (n[3]) atomicAdd(&hist[bin[3]], n[3]);
    bin[3] = bin[2], n[3] = n[2];
    bin[2] = bin[1], n[2] = n[1];
    bin[1] = bin[0], n[1] = n[0];
    bin[0] = b, n[0] = 1;
  }
  __device__ __forceinline__ void flush(int* hist) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (n[k]) atomicAdd(&hist[bin[k]], n[k]);
  }
};

// this thread's 16 bytes at data[my, my + 16) ∩ [pos, end) → their ACGT
// codes, compacted, 2 bits each; returns how many
__device__ __forceinline__ int thread_codes(const uint8_t* __restrict__ data, int64_t my,
                                            int64_t pos, int64_t end, unsigned& packed) {
  packed = 0;
  if (my >= end || my + 16 <= pos) return 0;
  uint32_t w[4] = {0, 0, 0, 0};
  if (my >= pos && my + 16 <= end) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(data + my));  // 16-byte aligned
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {  // the chunk's ragged ends: only the bytes inside it
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (my + j >= pos && my + j < end) w[j >> 2] |= (uint32_t)data[my + j] << (8 * (j & 3));
  }
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // ACGTacgt are the bytes whose lower case is one of acgt; a0 c1 g2 t3
    const unsigned c = ((w[j >> 2] >> (8 * (j & 3))) & 0xFFu) | 0x20u;
    unsigned code = (c >> 1) & 3u;
    code ^= code >> 1;
    if (c == 'a' || c == 'c' || c == 'g' || c == 't') packed |= code << (2 * cnt++);
  }
  return cnt;
}

__global__ void __launch_bounds__(kThreads, 2) transition_features_kernel(
    const uint8_t* __restrict__ data, const int64_t* __restrict__ offsets,
    const int* __restrict__ seq_lens, const int* __restrict__ tile_first, int* __restrict__ done,
    float* __restrict__ out, int B, int64_t n_bytes, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hist = reinterpret_cast<int*>(smem);
  uint8_t* buf = smem + kBins * sizeof(int);
  __shared__ int warp_excl[kThreads / 32];
  __shared__ int s_total, s_last;

  const int t = blockIdx.x;
  if (t >= tile_first[B]) return;  // the grid is an upper bound on the tiles
  int b = 0;  // the row of tile t: the last b with tile_first[b] <= t
  for (int hi_b = B - 1; b < hi_b;) {
    const int mid = (b + hi_b + 1) >> 1;
    if (tile_first[mid] <= t) b = mid; else hi_b = mid - 1;
  }
  const int n_tiles = tile_first[b + 1] - tile_first[b];
  const Span row = row_span(offsets, b, n_bytes);
  const int64_t row_hi = row.hi;
  const int64_t lo = row.lo + (int64_t)(t - tile_first[b]) * tile;
  const int64_t hi = min(lo + tile, row_hi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int k = 4 * threadIdx.x; k < kBins; k += 4 * kThreads)
    *reinterpret_cast<int4*>(hist + k) = make_int4(0, 0, 0, 0);
  Recent recent[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) recent[d].init();

  // buf[0, keep) holds codes not counted yet, the first keep_own of them
  // this tile's own; positions are indices into buf
  int keep = 0, keep_own = 0;
  int64_t pos = lo;
  for (;;) {
    // the chunk [pos, end): the tile's own bytes, then the row's beyond it
    const int64_t limit = pos < hi ? hi : row_hi;
    const int64_t a0 = pos - (int64_t)(((uintptr_t)data + pos) & 15);
    const int64_t end = min(a0 + kChunk, limit);
    unsigned packed;
    const int cnt = thread_codes(data, a0 + 16 * (int64_t)threadIdx.x, pos, end, packed);

    int incl = cnt;  // block exclusive scan of the threads' counts
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_excl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < kThreads / 32 ? warp_excl[lane] : 0;
      int s = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += u;
      }
      if (lane < kThreads / 32) warp_excl[lane] = s - v;
      if (lane == 31) s_total = s;
    }
    __syncthreads();
    uint8_t* dst = buf + keep + warp_excl[warp] + incl - cnt;
    for (int k = 0; k < cnt; ++k) dst[k] = (packed >> (2 * k)) & 3u;
    const int have = keep + s_total;
    const int own = keep_own + (pos < hi ? s_total : 0);
    pos = end;
    __syncthreads();

    // count the own positions whose windows are complete; at the row's end
    // every own position, each gap d only where code p + 5 + d exists
    const bool final_step = pos >= row_hi;
    const int n_pos = final_step ? own : min(own, max(have - 7, 0));
    for (int p0 = 16 * threadIdx.x; p0 < n_pos; p0 += kChunk) {
      const uint4 v = *reinterpret_cast<const uint4*>(buf + p0);
      const uint2 x = *reinterpret_cast<const uint2*>(buf + p0 + 16);
      const uint32_t wd[6] = {v.x, v.y, v.z, v.w, x.x, x.y};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (p0 + j >= n_pos) break;
#define CODE(k) ((wd[(k) >> 2] >> (8 * ((k) & 3))) & 3u)
#define LOC(k) (CODE(k) * 16 + CODE((k) + 1) * 4 + CODE((k) + 2))
        const int src = LOC(j) * 64;
        if (p0 + j + 5 < have) recent[0].add(hist, src + LOC(j + 3));
        if (p0 + j + 6 < have) recent[1].add(hist, kMat + src + LOC(j + 4));
        if (p0 + j + 7 < have) recent[2].add(hist, 2 * kMat + src + LOC(j + 5));
#undef LOC
#undef CODE
      }
    }
    // done once the tile's own bytes are read and its positions counted; a
    // chunk of the tile with no base (an N gap) leaves own == 0 mid-tile
    if (pos >= hi && n_pos == own) break;
    // not done: keep the codes not counted, at most the windows' 7 tails
    const int n_keep = have - n_pos;
    const uint8_t kept = threadIdx.x < n_keep ? buf[n_pos + threadIdx.x] : 0;
    __syncthreads();
    if (threadIdx.x < n_keep) buf[threadIdx.x] = kept;
    keep = n_keep;
    keep_own = own - n_pos;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) recent[d].flush(hist);
  __syncthreads();

  // IEEE division (no fast math): equal to 100.0 / max(len, 1.0) in float32
  const float scale = 100.0f / fmaxf((float)seq_lens[b], 1.0f);
  float* o = out + (size_t)b * kBins;
  if (n_tiles == 1) {
    for (int k = 4 * threadIdx.x; k < kBins; k += 4 * kThreads) {
      const int4 h = *reinterpret_cast<const int4*>(hist + k);
      *reinterpret_cast<float4*>(o + k) =
          make_float4(h.x * scale, h.y * scale, h.z * scale, h.w * scale);
    }
    return;
  }
  int* acc = reinterpret_cast<int*>(o);
  for (int k = threadIdx.x; k < kBins; k += kThreads)
    if (hist[k]) atomicAdd(&acc[k], hist[k]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&done[b], 1) == n_tiles - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int k = 4 * threadIdx.x; k < kBins; k += 4 * kThreads) {
    const int4 h = __ldcg(reinterpret_cast<const int4*>(acc + k));  // the sums, from L2
    *reinterpret_cast<float4*>(o + k) =
        make_float4(h.x * scale, h.y * scale, h.z * scale, h.w * scale);
  }
}

constexpr unsigned kBadCode = 0xFFu;  // a code outside [0, 64) in the staged bytes

__global__ void __launch_bounds__(kThreads, 2) transition_counts_codes_kernel(
    const int* __restrict__ locs, const int* __restrict__ n_locs, int* __restrict__ done,
    float* __restrict__ out, int64_t L, int tile, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hist = reinterpret_cast<int*>(smem);
  uint8_t* buf = smem + kBins * sizeof(int);
  __shared__ int s_last;

  const int b = blockIdx.x / tiles;
  const int64_t lo = (int64_t)(blockIdx.x % tiles) * tile;
  const int64_t n = min(max((int64_t)n_locs[b], (int64_t)0), L);
  // own positions [lo, lo + own); codes staged [lo, lo + have), 5 past the
  // tile for the pairs of its last positions
  const int own = (int)max(min(lo + tile, n) - lo, (int64_t)0);
  const int have = (int)max(min(lo + tile + 5, n) - lo, (int64_t)0);
  const int* row = locs + b * L + lo;

  for (int k = 4 * threadIdx.x; k < kBins; k += 4 * kThreads)
    *reinterpret_cast<int4*>(hist + k) = make_int4(0, 0, 0, 0);
  for (int k = threadIdx.x; k < have; k += kThreads) {
    const int c = __ldg(row + k);
    buf[k] = (unsigned)c < (unsigned)kCodes ? (uint8_t)c : (uint8_t)kBadCode;
  }
  __syncthreads();

  Recent recent[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) recent[d].init();
  for (int p0 = 16 * threadIdx.x; p0 < own; p0 += 16 * kThreads) {
    const uint4 v = *reinterpret_cast<const uint4*>(buf + p0);
    const uint2 x = *reinterpret_cast<const uint2*>(buf + p0 + 16);
    const uint32_t wd[6] = {v.x, v.y, v.z, v.w, x.x, x.y};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (p0 + j >= own) break;
#define CODE(k) ((wd[(k) >> 2] >> (8 * ((k) & 3))) & 0xFFu)
      const unsigned u = CODE(j);
      if (u == kBadCode) continue;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const unsigned w = CODE(j + 3 + d);
        if (p0 + j + 3 + d < have && w != kBadCode)
          recent[d].add(hist, d * kMat + (int)(u * kCodes + w));
      }
#undef CODE
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) recent[d].flush(hist);
  __syncthreads();

  float* o = out + (size_t)b * kBins;
  if (tiles == 1) {
    for (int k = 4 * threadIdx.x; k < kBins; k += 4 * kThreads) {
      const int4 h = *reinterpret_cast<const int4*>(hist + k);
      *reinterpret_cast<float4*>(o + k) =
          make_float4((float)h.x, (float)h.y, (float)h.z, (float)h.w);
    }
    return;
  }
  int* acc = reinterpret_cast<int*>(o);
  for (int k = threadIdx.x; k < kBins; k += kThreads)
    if (hist[k]) atomicAdd(&acc[k], hist[k]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&done[b], 1) == tiles - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int k = 4 * threadIdx.x; k < kBins; k += 4 * kThreads) {
    const int4 h = __ldcg(reinterpret_cast<const int4*>(acc + k));  // the sums, from L2
    *reinterpret_cast<float4*>(o + k) =
        make_float4((float)h.x, (float)h.y, (float)h.z, (float)h.w);
  }
}

}  // namespace

// K1 at the Pallas kernel's interface.  scratch: B int32 (each row's
// finished tiles); `tile` codes a block, at most kMaxCodeTile.
extern "C" int palace_transition_counts_codes(const void* locs, const void* n_locs, void* scratch,
                                              void* out, int B, long long L, int tile,
                                              void* stream) {
  if (B == 0) return 0;
  if (tile < 16 || tile > kMaxCodeTile || L < 0) return (int)cudaErrorInvalidValue;
  const long long tiles = L > tile ? (L + tile - 1) / tile : 1;
  if ((long long)B * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // the histogram, then the tile's codes and 5 more as bytes, read 24 at a time
  const int smem = kBins * (int)sizeof(int) + (tile + 15) / 16 * 16 + 32;
  cudaError_t err = cudaFuncSetAttribute(
      transition_counts_codes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiles > 1) {  // rows of several tiles add into their zeroed output rows
    err = cudaMemsetAsync(scratch, 0, (size_t)B * sizeof(int), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(out, 0, (size_t)B * kBins * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  transition_counts_codes_kernel<<<(unsigned)(B * tiles), kThreads, smem, s>>>(
      (const int*)locs, (const int*)n_locs, (int*)scratch, (float*)out, (int64_t)L, tile,
      (int)tiles);
  return (int)cudaGetLastError();
}

// scratch: 2B + 1 int32 (each row's first tile, then its finished tiles)
extern "C" int palace_transition_features(const void* data, const void* offsets,
                                          const void* seq_lens, void* scratch, void* out, int B,
                                          long long n_bytes, int tile, void* stream) {
  if (B == 0) return 0;
  const int smem = kBins * (int)sizeof(int) + kBuf;  // 57,408 bytes
  cudaError_t err = cudaFuncSetAttribute(
      transition_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int* tile_first = (int*)scratch;
  int* done = tile_first + B + 1;
  cudaStream_t s = (cudaStream_t)stream;
  plan_kernel<<<B + 1, kPlanThreads, 0, s>>>((const int64_t*)offsets, tile_first, done,
                                              (float*)out, B, n_bytes, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a row of len bytes has at most len / tile + 1 tiles
  const long long grid = n_bytes / tile + B;
  transition_features_kernel<<<(unsigned)grid, kThreads, smem, s>>>(
      (const uint8_t*)data, (const int64_t*)offsets, (const int*)seq_lens, tile_first, done,
      (float*)out, B, n_bytes, tile);
  return (int)cudaGetLastError();
}
