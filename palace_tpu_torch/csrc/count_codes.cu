// Phase A's count: a batch of the reader's base codes counted into the
// saturating k-mer count table, in one launch.  Replaces, on one device, the
// host packing (ops/kmer.py pack_codes_mask), the device unpack, the hashing
// in plain tensor ops (kmer_hashes) and the update through torch.unique and a
// gather and scatter (ops/count_table.py CountTable.add_packed / add_kmers).
// No TPU kernel computes it: the JAX package counts with XLA's sort and
// scatter (palace_tpu/ops/count_table.py), which the port's plain version
// repeats.
//
//   palace_count_codes  (B, L) uint8 codes, 0-3 a base (A C G T), 4 or more
//                       invalid or pad → every k-mer's three canonical
//                       hashes, each one saturating increment of the
//                       (2^k,) uint8 table; a k-mer with an invalid base, and
//                       any hash of 0, counts at slot 0.
//
// The table equals the plain route's byte for byte, slot 0 included: serial
// saturating increments give min(old + multiplicity, cap) in any order, and
// that is what torch.unique's multiplicity, a clamp and a scatter write.
//
// A block takes rows of the batch:
//   1. their codes as three bit-planes a row in shared memory, bit t of word w
//      for position 32 w + t: lo and hi (the code's two bits) and invalid
//      (code >= 4, or past the row); a warp makes a word with three
//      __ballot_sync of its lanes' codes, so the codes are read once, 32 bytes
//      a warp-load;
//   2. each thread hashes kBatch k-mers with scan_chunk's step 1b
//      (csrc/good_windows.cu hash3: funnel shifts, a bit reversal and the 18
//      masks of ops/kmer.py coder_masks; no hash goes to device memory), then
//      reads the aligned 32-bit word of each of their 3 kBatch slots, all
//      issued together;
//   3. a slot whose byte reads cap is skipped: counts only grow, so the skip
//      is exact; the others get one atomicCAS each of the word read with the
//      byte one higher (at most cap), all issued together, and a CAS that
//      finds the word changed by another thread retries from the word it
//      returned until the byte is one higher or at cap;
//   4. the block's hashes of 0 (invalid k-mers, the pad) are summed and added
//      to slot 0 by one saturating update a block, so slot 0 does not take a
//      CAS a k-mer.
// Two counters a launch, summed over the blocks into `counters` when it is
// not null: [0] the updates issued as a CAS, [1] those skipped at cap (slot
// 0's excluded).  How the two split depends on the order the threads run.
//
// Bound on the H100: 1 B a code read once (5.2 MB for a batch of 32,768 rows
// of 160), the table touched only at the updates; the floor of its table
// traffic is a 32-byte sector read a nonzero hash plus a CAS for each one
// below cap.  The card reads 1-byte values at random addresses of a 4 GiB
// table at 30.6 G/s (the K4 scan_hits row of PERF.md's kernel table), so the
// 12.7 M hashes of such a batch (129 k-mers a row, 3 hashes each) take at
// least 0.41 ms to read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;               // k-mers a thread hashes before it reads the table
constexpr int kMaxPlaneWords = 8192;    // 32 KiB of bit-planes a block at most

// Host-made coder masks, [slot][coder]: f has bit z set iff perm[z][slot] ==
// coder, r bit p iff perm[k-1-p][slot] == coder (ops/kmer.py coder_masks).
struct CoderMasks {
  uint32_t f[3][3];
  uint32_t r[3][3];
};

struct Hash3 {
  uint32_t v[3];
};

// The k-mer at q positions past the planes' first word: its three canonical
// hashes, 0 where one of its bases is invalid (good_windows.cu hash3).
__device__ __forceinline__ Hash3 hash3(const uint32_t* lo_p, const uint32_t* hi_p,
                                       const uint32_t* inv_p, int q, int k,
                                       const CoderMasks& cm) {
  Hash3 h{{0, 0, 0}};
  const uint32_t kmask = k == 32 ? 0xffffffffu : (1u << k) - 1u;
  const int w = q >> 5, s = q & 31;
  const uint32_t inv = __funnelshift_r(inv_p[w], inv_p[w + 1], s);
  if ((inv & kmask) == 0) {
    const uint32_t lo = __funnelshift_r(lo_p[w], lo_p[w + 1], s);
    const uint32_t hi = __funnelshift_r(hi_p[w], hi_p[w + 1], s);
    const uint32_t c0 = ~(lo ^ hi), c1 = ~hi, c2 = ~lo;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint32_t x = (c0 & cm.f[i][0]) | (c1 & cm.f[i][1]) | (c2 & cm.f[i][2]);
      const uint32_t fwd = __brev(x) >> (32 - k);
      const uint32_t rc = (c0 & cm.r[i][0]) | (hi & cm.r[i][1]) | (lo & cm.r[i][2]);
      h.v[i] = min(fwd, rc);
    }
  }
  return h;
}

// `word` with its byte at `shift` raised by n, to at most cap (a byte above
// cap becomes cap, as the plain route's clamp makes it).
__device__ __forceinline__ uint32_t raised(uint32_t word, int shift, unsigned long long n,
                                           uint32_t cap) {
  const uint32_t v = (word >> shift) & 0xffu;
  const uint32_t nv = v >= cap || n >= cap - v ? cap : v + (uint32_t)n;
  return (word & ~(0xffu << shift)) | (nv << shift);
}

// Slot `slot` raised by n, to at most cap, starting from `word`, a read of
// its aligned 32-bit word: CAS until it holds or the byte reads cap.
__device__ __forceinline__ void add_saturating(uint32_t* table32, uint32_t slot, uint32_t word,
                                               unsigned long long n, uint32_t cap) {
  uint32_t* a = table32 + (slot >> 2);
  const int shift = (slot & 3) * 8;
  while (((word >> shift) & 0xffu) != cap) {
    const uint32_t prev = atomicCAS(a, word, raised(word, shift, n, cap));
    if (prev == word) return;
    word = prev;
  }
}

__global__ void __launch_bounds__(kThreads) count_codes_kernel(
    const uint8_t* __restrict__ codes, uint8_t* table, const CoderMasks cm,
    unsigned long long* __restrict__ counters, int B, int L, int k, int rows_per_block,
    int nw, uint32_t cap) {
  extern __shared__ uint32_t planes[];  // rows_per_block × (lo, hi, inv) × nw
  __shared__ unsigned int block_sums[3];  // hashes of 0, CAS updates, skipped at cap
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows_per_block;
  const int nr = max(0, min(rows_per_block, B - r0));
  if (threadIdx.x < 3) block_sums[threadIdx.x] = 0;

  // 1. bit-planes: a warp a (row, word), a lane a position
  for (int rw = warp; rw < nr * nw; rw += kThreads / 32) {
    const int r = rw / nw, w = rw - r * nw;
    const int p = 32 * w + lane;
    const uint32_t c = p < L ? codes[(size_t)(r0 + r) * L + p] : 4u;
    const bool bad = c >= 4;
    const uint32_t lo = __ballot_sync(0xffffffffu, !bad && (c & 1));
    const uint32_t hi = __ballot_sync(0xffffffffu, !bad && (c & 2));
    const uint32_t inv = __ballot_sync(0xffffffffu, bad);
    if (lane == 0) {
      uint32_t* row = planes + (size_t)r * 3 * nw;
      row[w] = lo;
      row[nw + w] = hi;
      row[2 * nw + w] = inv;
    }
  }
  __syncthreads();

  // 2-3. kBatch k-mers a thread a round: hashed, their words read, updated
  uint32_t* table32 = reinterpret_cast<uint32_t*>(table);
  const int M = L - k + 1;  // k-mers a row (the wrapper launches only for M > 0)
  const int n = nr * M;
  unsigned int zeros = 0, updates = 0, at_cap = 0;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    Hash3 h[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      h[b] = Hash3{{0, 0, 0}};
      if (i < n) {
        const int r = i / M;
        const uint32_t* row = planes + (size_t)r * 3 * nw;
        h[b] = hash3(row, row + nw, row + 2 * nw, i - r * M, k, cm);
#pragma unroll
        for (int s = 0; s < 3; ++s) zeros += h[b].v[s] == 0;
      }
    }
    uint32_t word[kBatch][3];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int s = 0; s < 3; ++s)
        word[b][s] = h[b].v[s] ? __ldcg(table32 + (h[b].v[s] >> 2)) : 0u;
    // first CAS of each slot below cap; a slot done is set to hash 0
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const uint32_t slot = h[b].v[s];
        if (!slot) continue;
        const int shift = (slot & 3) * 8;
        if (((word[b][s] >> shift) & 0xffu) == cap) {
          ++at_cap;
          h[b].v[s] = 0;
          continue;
        }
        ++updates;
        const uint32_t prev =
            atomicCAS(table32 + (slot >> 2), word[b][s], raised(word[b][s], shift, 1, cap));
        if (prev == word[b][s]) h[b].v[s] = 0;
        else word[b][s] = prev;
      }
    // the CAS that found its word changed: again from the word it returned
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int s = 0; s < 3; ++s)
        if (h[b].v[s]) add_saturating(table32, h[b].v[s], word[b][s], 1, cap);
  }

  // 4. the block's sums: slot 0 once, the counters once
  zeros = __reduce_add_sync(0xffffffffu, zeros);
  updates = __reduce_add_sync(0xffffffffu, updates);
  at_cap = __reduce_add_sync(0xffffffffu, at_cap);
  if (lane == 0) {
    atomicAdd(&block_sums[0], zeros);
    atomicAdd(&block_sums[1], updates);
    atomicAdd(&block_sums[2], at_cap);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (block_sums[0]) add_saturating(table32, 0, __ldcg(table32), block_sums[0], cap);
    if (counters) {
      atomicAdd(counters, (unsigned long long)block_sums[1]);
      atomicAdd(counters + 1, (unsigned long long)block_sums[2]);
    }
  }
}

}  // namespace

// coder_masks: 18 uint32, f[slot][coder] then r[slot][coder].  codes (B, L)
// uint8, table (2^k,) uint8 with k >= 2, counters null or 2 uint64 (added
// to), 0 < L - k + 1 and L <= 2^16 (the wrapper checks).
extern "C" int palace_count_codes(const void* codes, void* table, const void* coder_masks,
                                  void* counters, int B, int L, int k, int cap,
                                  void* stream) {
  CoderMasks cm;
  const uint32_t* m = (const uint32_t*)coder_masks;
  for (int i = 0; i < 9; ++i) {
    cm.f[i / 3][i % 3] = m[i];
    cm.r[i / 3][i % 3] = m[9 + i];
  }
  // words a row: the funnel shift of the last k-mer reads the word after its start's
  const int nw = (L + 31) / 32 + 1;
  const int M = L - k + 1;
  int rows = (kThreads * kBatch) / M;
  if (rows > kMaxPlaneWords / (3 * nw)) rows = kMaxPlaneWords / (3 * nw);
  if (rows < 1) rows = 1;
  const int smem = rows * 3 * nw * (int)sizeof(uint32_t);  // within 48 KiB for L <= 2^16
  const int blocks = B > 0 ? (B + rows - 1) / rows : 1;
  count_codes_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (uint8_t*)table, cm, (unsigned long long*)counters, B, L, k, rows,
      nw, (uint32_t)cap);
  return (int)cudaGetLastError();
}
