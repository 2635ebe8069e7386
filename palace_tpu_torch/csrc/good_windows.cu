// K4: good-window flags of the eref reference scan, bit-packed.  Replaces
// good_windows_pallas (palace_tpu/ops/pallas_kernels.py) and, on Phase B's
// path, its XLA twin good_windows_batch (palace_tpu/ops/window.py) together
// with the unpack, hash and lookup before it (palace_tpu/search/eref.py
// _scan_body).  Five entries share the hashing and the window stage:
//
//   palace_good_windows  counts and hashes (NB, L, 3) → flags: the one-to-one
//                        counterpart of good_windows_pallas;
//   palace_scan_chunk    one Phase B chunk straight from the packed phagedb:
//                        codes → 3 canonical hashes → 3 count-table reads →
//                        flags, nothing but the flags in device memory;
//   palace_scan_hits     the same chunk against one rank's shard of a table
//                        split by hash range over a mesh: the hit bit of each
//                        position and coder whose hash lies in the shard's
//                        range [lo, hi), as three bit-planes (rows, 3, L / 8);
//                        each bit has one owning rank, so a sum of the ranks'
//                        planes is their OR (JAX's _scan_ref_fused_sharded
//                        joins int32 counts with a psum instead);
//   palace_window_hits   the OR-ed planes → flags: single = p0 | p1 | p2 and
//                        trio = p0 & p1 & p2, 32 positions a word, and the
//                        window sums as differences of word popcounts;
//   palace_hit_filter    a shard → the bitmap scan_hits reads before it, once
//                        a Phase B (the table does not change while it runs).
//
// Per row and position j: a coder hits when its count equals least_depth
// and its hash is not 0; single = at least one of the 3 coders hits, trio =
// all 3 hit.  Both are summed over the `window` positions ending at j
// (positions before 0 count as misses: the reference's growing prefix for
// j < window), and j is good when single_sum >= one_min and trio_sum >=
// three_min.  Output: bit j % 8 of byte j / 8, little-endian.
//
// The window stage.  The TPU kernel walks its tiles in order and carries
// the previous `window` indicators in VMEM; Hopper's blocks run in no
// order, so each block (one row, a tile of positions) also takes the
// `window` positions before its tile and needs nothing from any other
// block.  The block
//   1. puts the indicators of [t0 - window, t0 + tile) into shared memory as
//      (trio << 16) | single, neighbouring threads on neighbouring
//      positions, so one scan serves both sums;
//   2. scans them in place: kItems consecutive entries a thread, warp
//      shuffles, then the 8 warp totals;
//   3. takes win[j] = cs[window + j] - cs[j] and packs 32 flags a warp with
//      __ballot_sync, lanes 0-3 storing its four bytes.
// Sums stay below tile + window < 65536, so the two 16-bit fields never
// carry into each other.
//
// palace_good_windows is bound by bytes: 3 B of counts and 24 B of int64
// hashes read a position; its 2048-position tile rereads window / tile of
// them (24 % at window 500).
//
// palace_scan_chunk reads 0.375 B a position of packed phagedb (2-bit codes
// and the invalid bit) and writes 0.125 B of flags; what bounds it is the
// table: three 1-byte reads a valid position at random addresses of a
// 2^k-byte table (4 GiB at k = 32) that no cache holds, each a 32-byte
// sector from device memory.  So every thread hashes kBatch positions (3
// hashes each) before it reads any count, and a block's 24 × 256 reads are
// in flight together; a hash of 0 reads nothing.  Step 1 becomes:
//   1a. the block's codes as three bit-planes in shared memory, bit t of
//       word w for position 32 w + t: lo and hi (the code's two bits; A=0,
//       C=1, G=2, T=3) and invalid (the mask bit, or at or past ref_len);
//   1b. for each position, the k-bit windows of the planes by a funnel
//       shift; the coders are planes of their own (coder0 = ~(lo ^ hi),
//       coder1 = ~hi, coder2 = ~lo; complemented: coder0, hi, lo), and slot
//       i's forward hash is brev32(OR_c win_c & F[i][c]) >> (32 - k), its
//       reverse complement OR_c wincomp_c & R[i][c] with no reversal, for
//       the host's masks F[i][c] (bit z: perm[z][i] == c) and R[i][c]
//       (bit p: perm[k-1-p][i] == c).
// The window's halo repeats the hashes and table reads of the `window`
// positions before a tile.  Of the two ways out, a larger tile or a second
// pass over 2-bit indicators in device memory, this takes the larger tile:
// 8192 positions, so 6 % more reads at window 500 (24 % at 2048), one
// launch a chunk, and no indicator round trip; a 4.19 M-position chunk
// still makes 512 blocks for the card's 132 SMs.
//
// palace_scan_hits reads what scan_chunk reads but only the hashes of its own
// range read the shard, about 1 / world of them; it writes 0.375 B a
// position, three bits, and needs no halo: its blocks take kScanTile
// positions and hash them as scan_chunk's step 1b does.  The first design
// read the shard for every in-range hash, a floor of 1.20 ms at a 32-byte
// sector each for phase 22's 125.7 M at world 1; this one's bound counts
// the filter once and a sector for each shard read behind a set bit (14.3 M
// there), and leaves the filter's probes, which the L2 serves, to a term of
// their own.
// What the H100 does with such reads (tools/k4_sharded.py variants): 1-byte
// reads at random addresses of a 4 GiB table run at 30.5 G/s, 4.11 ms,
// with 8, 24 or 64 in flight a thread, and the first design reading the
// shard for every hash at 28.6 G/s: the ceiling is device memory's rate for
// random sectors, not the kernel.  Windows of 256 MiB-1 GiB, or the reads
// grouped by region, gain under 10 %; within 4-16 MiB, which the L2
// holds, they run at 116 G/s.  A probe asks one bit, count == least_depth,
// and almost every answer is no; so palace_hit_filter folds the shard into
// a 2^27-bit (16 MiB) bitmap, bit i mod 2^27 set where slot i counts
// least_depth, and scan_hits reads the bitmap for every in-range hash, 24
// reads a thread in flight, and the shard only behind a set bit (5.5 % of
// the bits at k = 32 on phase 22's table).  A queue of those shard reads in
// shared memory, drained once a block, ran slower: the drain's wait was not
// hidden.  palace_window_hits reads the 0.375 B and writes the 0.125 B of flags,
// and never leaves the bits: a window sum is a difference of two prefix
// popcounts, so a block of 256 output words (8192 positions) keeps two words
// and two prefixes a word of its tile and halo in shared memory, one block
// scan in all, and a thread forms and stores one word of 32 flags.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // entries scanned a pass
constexpr int kTile = 2048;                // good_windows: positions a block
constexpr int kScanTile = 8192;            // scan_chunk: positions a block
constexpr int kBatch = 8;                  // scan_chunk: positions a thread hashes a round

// The window stage, steps 2-3, over cs[0, n_ext) that step 1 filled (and a
// __syncthreads made visible): tile positions from t0, flags of those below
// L written to orow, the row's L / 8 output bytes.
template <int Tile>
__device__ __forceinline__ void window_flags(int* cs, int* warp_sums, int n_ext, int t0,
                                             int L, int window, int one_min, int three_min,
                                             uint8_t* __restrict__ orow) {
  // 2. inclusive scan of cs[0, n_ext) in passes of kChunk entries
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int c0 = 0; c0 < n_ext; c0 += kChunk) {
    const int base = c0 + threadIdx.x * kItems;
    int local[kItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      sum += (base + k < n_ext) ? cs[base + k] : 0;
      local[k] = sum;
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = carry, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_sums[w];
      total += warp_sums[w];
    }
    before += incl - sum;  // the exclusive prefix of this thread
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (base + k < n_ext) cs[base + k] = local[k] + before;
    carry += total;
    __syncthreads();  // cs written and warp_sums read before the next pass
  }

  // 3. windowed sums, thresholds, 32 flags a warp
  for (int j = threadIdx.x; j < Tile; j += kThreads) {
    const int pos = t0 + j;
    bool good = false;
    if (pos < L) {
      const int w = cs[window + j] - cs[j];
      good = (w & 0xffff) >= one_min && (w >> 16) >= three_min;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, good);
    const int p0 = pos - lane;  // a multiple of 32
    if (lane < 4 && p0 + 8 * lane < L) orow[p0 / 8 + lane] = (uint8_t)(bits >> (8 * lane));
  }
}

__device__ __forceinline__ int indicator(int hits) {
  return (hits > 0 ? 1 : 0) | (hits == 3 ? 1 << 16 : 0);
}

__global__ void __launch_bounds__(kThreads) good_windows_kernel(
    const uint8_t* __restrict__ counts, const int64_t* __restrict__ hashes,
    uint8_t* __restrict__ out, int L, int window, int one_min, int three_min,
    int least_depth) {
  extern __shared__ int cs[];  // kTile + window entries
  __shared__ int warp_sums[kWarps];
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int n_ext = kTile + window;
  const long long ext0 = (long long)t0 - window;  // position of entry 0
  const size_t row_off = (size_t)row * L;

  // 1. indicators of the extended range
  for (int i = threadIdx.x; i < n_ext; i += kThreads) {
    const long long pos = ext0 + i;
    int n = 0;
    if (pos >= 0 && pos < L) {
      const size_t e = (row_off + (size_t)pos) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        n += (counts[e + c] == least_depth) & (hashes[e + c] != 0);
    }
    cs[i] = indicator(n);
  }
  __syncthreads();
  window_flags<kTile>(cs, warp_sums, n_ext, t0, L, window, one_min, three_min,
                      out + (size_t)row * (L / 8));
}

// Host-made coder masks, [slot][coder]: f has bit z set iff perm[z][slot] ==
// coder, r bit p iff perm[k-1-p][slot] == coder (ops/kmer.py coder_masks).
struct CoderMasks {
  uint32_t f[3][3];
  uint32_t r[3][3];
};

// bits 0, 2, 4, ... of x → bits 0, 1, 2, ...
__device__ __forceinline__ uint32_t even_bits(uint64_t x) {
  x &= 0x5555555555555555ull;
  x = (x | (x >> 1)) & 0x3333333333333333ull;
  x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x >> 4)) & 0x00FF00FF00FF00FFull;
  x = (x | (x >> 8)) & 0x0000FFFF0000FFFFull;
  x = (x | (x >> 16)) & 0x00000000FFFFFFFFull;
  return (uint32_t)x;
}

// Words of one bit-plane a block of scan_chunk may need: its k-mers start in
// [t0 - window, t0 + kScanTile) and end k - 1 ≤ 31 positions later, and the
// funnel shift reads one word past the last.
__host__ __device__ constexpr int plane_words(int window) {
  return (kScanTile + window + 64) / 32 + 4;
}

// Step 1a: the bit-planes of a row's positions [32 wbase, 32 (wbase + nw)) in
// shared memory, from its bytes of the packed phagedb: codes from cb0, mask
// bits from mb0; positions at or past len are invalid.
__device__ __forceinline__ void load_planes(const uint8_t* __restrict__ cb0,
                                            const uint8_t* __restrict__ mb0, int len, int wbase,
                                            int nw, uint32_t* lo_p, uint32_t* hi_p,
                                            uint32_t* inv_p) {
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    const int p = (wbase + w) * 32;
    uint64_t code = 0;
    uint32_t inv = 0xffffffffu;
    if (p < len) {
      const int nb = min(32, len - p);  // positions of the word inside the reference
      const uint8_t* cb = cb0 + p / 4;
      const uint8_t* mb = mb0 + p / 8;
      for (int b = 0; b < (nb + 3) / 4; ++b) code |= (uint64_t)cb[b] << (8 * b);
      uint32_t m = 0;
      for (int b = 0; b < (nb + 7) / 8; ++b) m |= (uint32_t)mb[b] << (8 * b);
      inv = m | (nb == 32 ? 0u : 0xffffffffu << nb);
    }
    lo_p[w] = even_bits(code);
    hi_p[w] = even_bits(code >> 1);
    inv_p[w] = inv;
  }
}

struct Hash3 {
  uint32_t v[3];
};

// Step 1b for the k-mer at q positions past the planes' first word: its
// three canonical hashes, 0 where one of its bases is invalid.
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

__global__ void __launch_bounds__(kThreads) scan_chunk_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ mask,
    const int64_t* __restrict__ offsets, const uint8_t* __restrict__ table,
    const CoderMasks cm, uint8_t* __restrict__ out, int target, int k, int window,
    int one_min, int three_min, int least_depth) {
  extern __shared__ int cs[];  // kScanTile + window entries, then the planes
  __shared__ int warp_sums[kWarps];
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kScanTile;
  const int n_ext = kScanTile + window;
  const int e0 = t0 - window;  // position of entry 0
  const int64_t code_off = offsets[3 * row], mask_off = offsets[3 * row + 1];
  // positions at or past ref_len are code 4 (the slice's tail may hold the
  // next reference), so k-mers may be valid only where they start before
  // len - k + 1
  const int len = (int)min((long long)offsets[3 * row + 2], (long long)target);
  const int ea = max(e0, 0), eb = min(t0 + kScanTile, len - k + 1);
  const int nw = plane_words(window);
  uint32_t* lo_p = reinterpret_cast<uint32_t*>(cs + n_ext);
  uint32_t* hi_p = lo_p + nw;
  uint32_t* inv_p = hi_p + nw;
  const int wbase = ea >> 5;  // first plane word: position 32 wbase

  // 1a. bit-planes of the positions [32 wbase, 32 (wbase + nw))
  if (eb > ea) load_planes(packed + code_off, mask + mask_off, len, wbase, nw, lo_p, hi_p, inv_p);
  __syncthreads();

  // 1b. indicators of [e0, t0 + kScanTile): kBatch positions a thread hashed,
  // then their 3 kBatch table reads issued together, then counted
  for (int i0 = threadIdx.x; i0 < n_ext; i0 += kThreads * kBatch) {
    Hash3 h[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int pos = e0 + i0 + b * kThreads;
      h[b] = pos >= ea && pos < eb ? hash3(lo_p, hi_p, inv_p, pos - 32 * wbase, k, cm)
                                   : Hash3{{0, 0, 0}};
    }
    uint32_t cnt[kBatch][3];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        cnt[b][i] = h[b].v[i] ? __ldg(table + (size_t)h[b].v[i]) : 0u;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      int n = 0;
#pragma unroll
      for (int s = 0; s < 3; ++s) n += (h[b].v[s] != 0) & (cnt[b][s] == (uint32_t)least_depth);
      if (i < n_ext) cs[i] = indicator(n);
    }
  }
  __syncthreads();
  window_flags<kScanTile>(cs, warp_sums, n_ext, t0, target, window, one_min, three_min,
                          out + (size_t)row * (target / 8));
}

// The hit filter of a shard: bit (i & fmask) is set for every slot i with
// shard[i] == least_depth, fmask = 2^fbits - 1.  A shard of at most 2^fbits
// slots gets one bit a slot; a larger one folds its slots onto the bits, so a
// clear bit says no slot it stands for counts least_depth, and a set bit is
// read through to the shard.  The caller zeroes filt.  Reads the shard once,
// 16 B a load from its first 16-byte boundary (block 0 takes the bytes
// before it and after the last 16); the set bits are few (atomicOr).
__global__ void __launch_bounds__(kThreads) hit_filter_kernel(
    const uint8_t* __restrict__ shard, unsigned long long size, uint32_t* __restrict__ filt,
    uint32_t fmask, int least_depth) {
  const unsigned long long head =
      min(size, (unsigned long long)((16 - (uintptr_t)shard % 16) % 16));
  const unsigned long long n16 = (size - head) / 16;
  const unsigned long long step = (unsigned long long)gridDim.x * kThreads;
  const uint32_t want = 0x01010101u * (uint32_t)(least_depth & 0xff);
  const uint4* body = reinterpret_cast<const uint4*>(shard + head);
  auto mark = [&](unsigned long long slot) {
    const uint32_t bit = (uint32_t)slot & fmask;
    atomicOr(filt + (bit >> 5), 1u << (bit & 31));
  };
  for (unsigned long long q = (unsigned long long)blockIdx.x * kThreads + threadIdx.x; q < n16;
       q += step) {
    const uint4 v = __ldg(body + q);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t eq = __vcmpeq4(w[j], want);  // 0xff in each byte that matches
      if (eq)
        for (int b = 0; b < 4; ++b)
          if ((eq >> (8 * b)) & 1u) mark(head + 16 * q + 4 * j + b);
    }
  }
  if (blockIdx.x == 0) {
    for (unsigned long long i = threadIdx.x; i < head; i += kThreads)
      if (shard[i] == (uint8_t)least_depth) mark(i);
    for (unsigned long long i = head + 16 * n16 + threadIdx.x; i < size; i += kThreads)
      if (shard[i] == (uint8_t)least_depth) mark(i);
  }
}

// One rank's hit bits of a Phase B chunk against its shard [lo, hi) of the
// table: bit j % 8 of byte j / 8 of plane c is set where coder c's hash h at
// position j is not 0, lies in [lo, hi) and shard[h - lo] == least_depth.
// Each thread hashes kBatch positions, then reads the hit filter's word of
// each in-range hash (24 reads issued together, into a bitmap the L2 holds),
// and only where the hash's bit is set reads the shard.
__global__ void __launch_bounds__(kThreads) scan_hits_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ mask,
    const int64_t* __restrict__ offsets, const uint8_t* __restrict__ shard,
    const uint32_t* __restrict__ filt, uint32_t fmask, const CoderMasks cm,
    uint8_t* __restrict__ out, int target, int k, int least_depth, unsigned long long lo,
    unsigned long long hi) {
  constexpr int nw = plane_words(0);
  __shared__ uint32_t planes[3 * nw];
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kScanTile;  // a multiple of 32
  const int64_t code_off = offsets[3 * row], mask_off = offsets[3 * row + 1];
  const int len = (int)min((long long)offsets[3 * row + 2], (long long)target);
  const int eb = min(t0 + kScanTile, len - k + 1);  // k-mers start in [t0, eb)
  uint32_t* lo_p = planes;
  uint32_t* hi_p = lo_p + nw;
  uint32_t* inv_p = hi_p + nw;
  if (eb > t0) load_planes(packed + code_off, mask + mask_off, len, t0 >> 5, nw, lo_p, hi_p, inv_p);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int plane_bytes = target / 8;
  uint8_t* orow = out + (size_t)row * 3 * plane_bytes;
  for (int i0 = threadIdx.x; i0 < kScanTile; i0 += kThreads * kBatch) {
    Hash3 h[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int pos = t0 + i0 + b * kThreads;
      h[b] = pos < eb ? hash3(lo_p, hi_p, inv_p, pos - t0, k, cm) : Hash3{{0, 0, 0}};
    }
    // the filter words, then the shard's counts where a bit is set; a hash
    // out of range (or 0) keeps offset 0 and a word of 0: no read at all
    uint32_t word[kBatch][3];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const unsigned long long v = h[b].v[i];
        const bool mine = v != 0 && v >= lo && v < hi;
        h[b].v[i] = mine ? (uint32_t)(v - lo) : 0u;  // hi - lo <= 2^32
        word[b][i] = mine ? __ldg(filt + ((h[b].v[i] & fmask) >> 5)) : 0u;
      }
    uint32_t cnt[kBatch][3];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const bool maybe = (word[b][i] >> (h[b].v[i] & 31)) & 1u;
        cnt[b][i] = maybe ? __ldg(shard + h[b].v[i]) : 0xffffffffu;
      }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int p0 = t0 + i0 + b * kThreads - lane;  // a multiple of 32
      const unsigned bits[3] = {__ballot_sync(0xffffffffu, cnt[b][0] == (uint32_t)least_depth),
                                __ballot_sync(0xffffffffu, cnt[b][1] == (uint32_t)least_depth),
                                __ballot_sync(0xffffffffu, cnt[b][2] == (uint32_t)least_depth)};
      const int c = lane >> 2, byte = lane & 3;  // lanes 0-11: plane c's byte
      if (lane < 12 && p0 + 8 * byte < target)
        orow[c * plane_bytes + p0 / 8 + byte] = (uint8_t)(bits[c] >> (8 * byte));
    }
  }
}

// window_hits: output words (32 positions each) a block, and the most words
// of halo before them (GOOD_WINDOWS_MAX_WINDOW = 32768: 1024 + 1)
constexpr int kWinWords = kThreads;
constexpr int kWinExt = kWinWords + 32768 / 32 + 1;

// Word w of a plane of nbytes bytes, positions 32 w .. 32 w + 31; 0 outside
// the plane.  aligned: the plane starts on a 4-byte boundary and nbytes % 4
// == 0, so a word is one 4-byte load; else it is read a byte at a time.
__device__ __forceinline__ uint32_t plane_word(const uint8_t* __restrict__ p, int w, int nbytes,
                                               bool aligned) {
  if (w < 0 || 4 * w >= nbytes) return 0u;
  if (aligned) return __ldg(reinterpret_cast<const uint32_t*>(p) + w);
  uint32_t x = 0;
  const int n = min(4, nbytes - 4 * w);
  for (int b = 0; b < n; ++b) x |= (uint32_t)__ldg(p + 4 * w + b) << (8 * b);
  return x;
}

// Flags from the OR-ed planes of scan_hits, bit-parallel.  A block takes
// kWinWords output words of a row and the `halo` words before them:
//   1. single = p0 | p1 | p2 and trio = p0 & p1 & p2 a word, into shared
//      memory; words before 0 or past the row are 0 (misses);
//   2. one block scan of the words' popcounts: P[i], the set bits before
//      word i;
//   3. a thread a word o: with x = 32 o - window and P(x) = P[x / 32] +
//      popc(word & (2^(x % 32) - 1)), the sum ending at 32 o - 1 is P[o] -
//      P(x); the sum ending at 32 o + b adds the bits 0..b of word o and
//      takes away those of the 32 bits from x (a funnel shift of two
//      words); the 32 flags are stored as one word.
// Shared memory: two words and two prefixes an entry, 20.5 KB at the
// largest window.
__global__ void __launch_bounds__(kThreads) window_hits_kernel(
    const uint8_t* __restrict__ planes, uint8_t* __restrict__ out, int target, int window,
    int one_min, int three_min, bool aligned) {
  __shared__ uint32_t single_w[kWinExt], trio_w[kWinExt];
  __shared__ int single_p[kWinExt], trio_p[kWinExt];
  __shared__ int warp_sums[2][kWarps];
  const int row = blockIdx.y;
  const int nbytes = target / 8, nwords = (nbytes + 3) / 4;
  const int halo = (window + 31) / 32 + 1;  // 32 halo > window: x lies past entry 0
  const int w0 = blockIdx.x * kWinWords;     // the block's first output word
  const int e0 = w0 - halo;                  // the word of entry 0
  const int n_ext = halo + min(kWinWords, nwords - w0);
  const uint8_t* p0 = planes + (size_t)row * 3 * nbytes;
  const uint8_t* p1 = p0 + nbytes;
  const uint8_t* p2 = p1 + nbytes;

  // 1. single and trio words of entries [0, n_ext)
  for (int i = threadIdx.x; i < n_ext; i += kThreads) {
    const int w = e0 + i;
    const uint32_t x0 = plane_word(p0, w, nbytes, aligned), x1 = plane_word(p1, w, nbytes, aligned),
                   x2 = plane_word(p2, w, nbytes, aligned);
    single_w[i] = x0 | x1 | x2;
    trio_w[i] = x0 & x1 & x2;
  }
  __syncthreads();

  // 2. exclusive prefix of the popcounts: consecutive entries a thread,
  // warp shuffles, then the warp totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n_ext + kThreads - 1) / kThreads, i0 = threadIdx.x * per;
  int s_sum = 0, t_sum = 0;
  for (int k = 0; k < per; ++k)
    if (i0 + k < n_ext) {
      s_sum += __popc(single_w[i0 + k]);
      t_sum += __popc(trio_w[i0 + k]);
    }
  int s_inc = s_sum, t_inc = t_sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ys = __shfl_up_sync(0xffffffffu, s_inc, o), yt = __shfl_up_sync(0xffffffffu, t_inc, o);
    if (lane >= o) {
      s_inc += ys;
      t_inc += yt;
    }
  }
  if (lane == 31) {
    warp_sums[0][warp] = s_inc;
    warp_sums[1][warp] = t_inc;
  }
  __syncthreads();
  int s_before = s_inc - s_sum, t_before = t_inc - t_sum;
  for (int w = 0; w < warp; ++w) {
    s_before += warp_sums[0][w];
    t_before += warp_sums[1][w];
  }
  for (int k = 0; k < per; ++k)
    if (i0 + k < n_ext) {
      single_p[i0 + k] = s_before;
      trio_p[i0 + k] = t_before;
      s_before += __popc(single_w[i0 + k]);
      t_before += __popc(trio_w[i0 + k]);
    }
  __syncthreads();

  // 3. the 32 flags of output word o
  const int o = w0 + threadIdx.x;
  if (o >= nwords) return;
  const int i = halo + threadIdx.x;       // entry of word o
  const int rel = 32 * i - window;        // x - 32 e0, at least 32
  const int xi = rel >> 5, xs = rel & 31;
  const uint32_t below = (1u << xs) - 1u;
  int s_win = single_p[i] - single_p[xi] - __popc(single_w[xi] & below);
  int t_win = trio_p[i] - trio_p[xi] - __popc(trio_w[xi] & below);
  const uint32_t s_in = single_w[i], t_in = trio_w[i];
  const uint32_t s_out = __funnelshift_r(single_w[xi], single_w[xi + 1], xs);
  const uint32_t t_out = __funnelshift_r(trio_w[xi], trio_w[xi + 1], xs);
  uint32_t flags = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    s_win += (int)((s_in >> b) & 1u) - (int)((s_out >> b) & 1u);
    t_win += (int)((t_in >> b) & 1u) - (int)((t_out >> b) & 1u);
    flags |= (uint32_t)(s_win >= one_min && t_win >= three_min) << b;
  }
  uint8_t* orow = out + (size_t)row * nbytes;
  if (aligned) {
    reinterpret_cast<uint32_t*>(orow)[o] = flags;
  } else {
    for (int b = 0; b < 4 && 4 * o + b < nbytes; ++b) orow[4 * o + b] = (uint8_t)(flags >> (8 * b));
  }
}

CoderMasks read_masks(const void* coder_masks) {
  CoderMasks cm;
  const uint32_t* m = (const uint32_t*)coder_masks;
  for (int i = 0; i < 9; ++i) {
    cm.f[i / 3][i % 3] = m[i];
    cm.r[i / 3][i % 3] = m[9 + i];
  }
  return cm;
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= 47 * 1024) return 0;  // within the 48 KiB default, with the static warp_sums
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" int palace_good_windows(const void* counts, const void* hashes, void* out,
                                   int NB, int L, int window, int one_min, int three_min,
                                   int least_depth, void* stream) {
  const int smem = (kTile + window) * (int)sizeof(int);
  if (int err = set_smem(good_windows_kernel, smem)) return err;
  const dim3 grid((L + kTile - 1) / kTile, NB);
  good_windows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)counts, (const int64_t*)hashes, (uint8_t*)out, L, window, one_min,
      three_min, least_depth);
  return (int)cudaGetLastError();
}

// coder_masks: 18 uint32, f[slot][coder] then r[slot][coder].  offsets:
// (rows, 3) int64 code byte offset, mask byte offset, ref_len, each row's
// target / 4 and target / 8 bytes inside packed and mask (the wrapper checks).
extern "C" int palace_scan_chunk(const void* packed, const void* mask, const void* offsets,
                                 const void* table, const void* coder_masks, void* out,
                                 int rows, int target, int k, int window, int one_min,
                                 int three_min, int least_depth, void* stream) {
  const CoderMasks cm = read_masks(coder_masks);
  const int smem = (kScanTile + window) * (int)sizeof(int) + 3 * plane_words(window) * 4;
  if (int err = set_smem(scan_chunk_kernel, smem)) return err;
  const dim3 grid((target + kScanTile - 1) / kScanTile, rows);
  scan_chunk_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const uint8_t*)mask, (const int64_t*)offsets,
      (const uint8_t*)table, cm, (uint8_t*)out, target, k, window, one_min, three_min,
      least_depth);
  return (int)cudaGetLastError();
}

// The hit filter of a shard of `size` slots into filt, 2^fbits bits (fbits >= 5),
// zeroed here on the stream first.
extern "C" int palace_hit_filter(const void* shard, long long size, void* filt, int fbits,
                                 int least_depth, void* stream) {
  const size_t bytes = (size_t)1 << (fbits - 3);
  if (int err = (int)cudaMemsetAsync(filt, 0, bytes, (cudaStream_t)stream)) return err;
  int dev = 0, sms = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  if (int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return err;
  const long long need = (size / 16 + kThreads - 1) / kThreads + 1;
  const long long blocks = need < 8LL * sms ? need : 8LL * sms;
  hit_filter_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)shard, (unsigned long long)size, (uint32_t*)filt,
      (uint32_t)(((unsigned long long)1 << fbits) - 1), least_depth);
  return (int)cudaGetLastError();
}

// scan_chunk's inputs with the rank's shard of the table, its hit filter
// (2^fbits bits) and its hash range [lo, hi) in place of the table →
// (rows, 3, target / 8) hit bit-planes.
extern "C" int palace_scan_hits(const void* packed, const void* mask, const void* offsets,
                                const void* shard, const void* filt, int fbits,
                                const void* coder_masks, void* out, int rows, int target, int k,
                                int least_depth, long long lo, long long hi, void* stream) {
  const dim3 grid((target + kScanTile - 1) / kScanTile, rows);
  scan_hits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const uint8_t*)mask, (const int64_t*)offsets,
      (const uint8_t*)shard, (const uint32_t*)filt,
      (uint32_t)(((unsigned long long)1 << fbits) - 1), read_masks(coder_masks), (uint8_t*)out,
      target, k, least_depth, (unsigned long long)lo, (unsigned long long)hi);
  return (int)cudaGetLastError();
}

// (rows, 3, target / 8) OR-ed hit bit-planes → (rows, target / 8) flags.
extern "C" int palace_window_hits(const void* planes, void* out, int rows, int target,
                                  int window, int one_min, int three_min, void* stream) {
  const int nbytes = target / 8;
  const bool aligned =
      nbytes % 4 == 0 && (uintptr_t)planes % 4 == 0 && (uintptr_t)out % 4 == 0;
  const dim3 grid((nbytes + 4 * kWinWords - 1) / (4 * kWinWords), rows);
  window_hits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (uint8_t*)out, target, window, one_min, three_min, aligned);
  return (int)cudaGetLastError();
}
