"""The PALACE reference search (extract_ref.cpp) in plain PyTorch and NumPy.

Hashes (extract_ref.cpp:1010-1102): three binary projections of a base,
coder0 A/T→1, coder1 A/C→1, coder2 A/G→1; hash slot ``i`` reads k-mer
offset ``z`` through coder ``perm[z][i]``, one bit a base, the first base
highest; the reverse complement reads the complemented bases back to
front; the canonical hash is the smaller.  A k-mer with a base other
than ACGT has no hash.  ``perm`` is the configuration's coder
permutation: row ``z`` is permutation number ``r_z`` of (0, 1, 2) in the
order of extract_ref.cpp:1084, the ``r_z`` drawn by
``numpy.random.default_rng(coder_seed).integers(0, 6, k)``.

Phase A (read_fastq :905-1008): every hash of every k-mer of the reads
is counted in a table of 2^k bytes that saturates at ``least_depth``.

Phase B (read_index :813-903, slide_window :504-624): at each position
of a reference, the coders whose hash is not 0 and reads ``least_depth``
in the table hit; over the ``window`` positions ending there (fewer at
the start) the positions with one hit or more and those with three are
summed, and the position is good when the sums reach
``int(window * hit_ratio)`` and ``int(window * perfect_hit_ratio)`` (a
float32 product, truncated).  Each run of good positions entered at ``e``
and left at ``l`` (or open at the end) gives the interval
``[max(e - 2w, 1), min(l + 2w, L)]`` (``L`` when open), merged into the
one before when it starts less than ``window`` after that one's end.  A
reference longer than k whose intervals cover more than
``min_cover_ratio`` of it (float32) is reported as
``ref_index <1-based index> <intervals> <covered> <length> <ratio %g>``.

``table_bits`` below ``k`` gives the check's control: a table of
``2^table_bits`` slots indexed by the hash's low bits.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

#: the permutations of (0, 1, 2) in extract_ref.cpp:1084's order
PERMUTATIONS = np.array([[0, 1, 2], [0, 2, 1], [1, 2, 0], [1, 0, 2], [2, 0, 1], [2, 1, 0]])
#: coder bit of each base code A C G T (code 4, any other character, has none)
CODER_BITS = np.array([[1, 0, 0, 1], [1, 1, 0, 0], [1, 0, 1, 0]], dtype=np.int64)

BASE_CODES = np.full(256, 4, dtype=np.uint8)
for _code, _ch in enumerate(b"ACGT"):
    BASE_CODES[_ch] = _code
    BASE_CODES[_ch + 32] = _code

#: positions hashed at once
BLOCK = 1 << 25


def coder_perm(k: int, coder_seed: int) -> np.ndarray:
    return PERMUTATIONS[np.random.default_rng(coder_seed).integers(0, 6, size=k)]


def thresholds(params: Mapping) -> Tuple[int, int]:
    w = np.float32(params["window"])
    return (int(w * np.float32(params["hit_ratio"])),
            int(w * np.float32(params["perfect_hit_ratio"])))


def hashes(codes: torch.Tensor, perm: np.ndarray, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T,) base codes 0..4 → ((T-k+1, 3) int64 canonical hashes of the
    k-mer starting at each position, (T-k+1,) bool: all k bases ACGT)."""
    dev = codes.device
    M = codes.numel() - k + 1
    c = codes.long().clamp(max=4)
    lut = torch.from_numpy(np.concatenate([CODER_BITS, np.zeros((3, 1), np.int64)], 1)).to(dev)
    bit = [lut[i][c] for i in range(3)]
    comp = [bit[0], 1 - bit[1], 1 - bit[2]]   # the complement flips coders 1 and 2
    out = []
    for i in range(3):
        fwd = torch.zeros(M, dtype=torch.int64, device=dev)
        rc = torch.zeros(M, dtype=torch.int64, device=dev)
        for z in range(k):
            fwd += bit[int(perm[z, i])][z:z + M] << (k - 1 - z)
            # reverse complement: base j+z complemented, read through coder
            # perm[k-1-z][i], weight 2^z
            rc += comp[int(perm[k - 1 - z, i])][z:z + M] << z
        out.append(torch.minimum(fwd, rc))
    bad = torch.cumsum(torch.nn.functional.pad((c >= 4).int(), (1, 0)), 0)
    valid = (bad[k:] - bad[:M]) == 0
    return torch.stack(out, 1), valid


def count_table(read_codes: torch.Tensor, params: Mapping,
                table_bits: Optional[int] = None) -> torch.Tensor:
    """Phase A: (n, L) read base codes → the saturating count table,
    (2^table_bits,) uint8 (table_bits = k unless given)."""
    k, cap = params["k"], params["least_depth"]
    bits = k if table_bits is None else table_bits
    perm = coder_perm(k, params["coder_seed"])
    dev = read_codes.device
    table = torch.zeros(1 << bits, dtype=torch.uint8, device=dev)
    n, L = read_codes.shape
    rows = max(1, BLOCK // L)
    for lo in range(0, n, rows):
        h, valid = hashes(read_codes[lo:lo + rows].reshape(-1), perm, k)
        # a k-mer that starts in one read and ends in the next is none
        valid &= torch.arange(h.shape[0], device=dev) % L <= L - k
        h = h[valid].reshape(-1) & ((1 << bits) - 1)
        slots, mult = torch.unique(h, return_counts=True)
        table[slots] = torch.clamp(table[slots].long() + mult, max=cap).to(torch.uint8)
    return table


def hit_lines(table: torch.Tensor, ref_codes: torch.Tensor, lengths: np.ndarray,
              params: Mapping, table_bits: Optional[int] = None) -> List[str]:
    """Phase B: the references, their base codes concatenated, against the
    table → the report's lines, in reference order."""
    k, depth, w = params["k"], params["least_depth"], params["window"]
    bits = k if table_bits is None else table_bits
    perm = coder_perm(k, params["coder_seed"])
    one_min, three_min = thresholds(params)
    dev = ref_codes.device
    lengths = np.asarray(lengths, np.int64)
    first = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    lines: List[str] = []
    r0 = 0
    while r0 < len(lengths):
        # a group of whole references, about BLOCK positions
        r1 = r0 + 1
        while r1 < len(lengths) and first[r1] + lengths[r1] - first[r0] <= BLOCK:
            r1 += 1
        lo, hi = int(first[r0]), int(first[r1 - 1] + lengths[r1 - 1])
        codes = torch.nn.functional.pad(ref_codes[lo:hi], (0, k - 1), value=4)
        h, valid = hashes(codes, perm, k)
        ref_of = torch.repeat_interleave(torch.arange(r1 - r0, device=dev),
                                         torch.from_numpy(lengths[r0:r1]).to(dev))
        start = torch.from_numpy(first[r0:r1] - lo).to(dev)[ref_of]
        rel = torch.arange(hi - lo, device=dev) - start
        valid &= rel <= torch.from_numpy(lengths[r0:r1]).to(dev)[ref_of] - k
        hit = (h != 0) & (table[h & ((1 << bits) - 1)] == depth) & valid[:, None]
        n_hit = hit.sum(dim=1)
        good = (_window_sums(n_hit >= 1, start, w) >= one_min) \
            & (_window_sums(n_hit == 3, start, w) >= three_min)
        lines += _verdicts(good, rel, ref_of, r0, lengths[r0:r1], params)
        r0 = r1
    return lines


def _window_sums(flag: torch.Tensor, start: torch.Tensor, w: int) -> torch.Tensor:
    """Sum of ``flag`` over the ``w`` positions ending at each position,
    within its reference (fewer at the reference's start)."""
    c = torch.nn.functional.pad(torch.cumsum(flag.int(), 0), (1, 0))
    j = torch.arange(flag.numel(), device=flag.device)
    lo = torch.maximum(j - w + 1, start)
    return c[j + 1] - c[lo]


def _verdicts(good: torch.Tensor, rel: torch.Tensor, ref_of: torch.Tensor, r0: int,
              lengths: np.ndarray, params: Mapping) -> List[str]:
    w, k = params["window"], params["k"]
    prev = torch.nn.functional.pad(good[:-1], (1, 0)) & (rel > 0)
    enter = torch.nonzero(good & ~prev).flatten()
    leave = torch.nonzero(~good & prev).flatten()
    enters = {}
    for r, j in zip(ref_of[enter].tolist(), rel[enter].tolist()):
        enters.setdefault(r, []).append(j)
    leaves = {}
    for r, j in zip(ref_of[leave].tolist(), rel[leave].tolist()):
        leaves.setdefault(r, []).append(j)
    cover = np.float32(params["min_cover_ratio"])
    out = []
    for r in sorted(enters):
        L = int(lengths[r])
        if L <= k:
            continue
        ivs: List[List[int]] = []
        lv = leaves.get(r, [])
        for n, e in enumerate(enters[r]):
            start = max(e - 2 * w, 1)
            end = min(lv[n] + 2 * w, L) if n < len(lv) else L   # open at the end: L
            if ivs and start - ivs[-1][1] < w:
                ivs[-1][1] = end
            else:
                ivs.append([start, end])
        el = sum(e - s for s, e in ivs)
        ratio = np.float32(el) / np.float32(L)
        if el > 0 and ratio > cover:
            out.append(f"ref_index\t{r0 + r + 1}\t{len(ivs)}\t{el}\t{L}\t{float(ratio):g}")
    return out


def mismatched_slots(program: torch.Tensor, reference: torch.Tensor) -> int:
    """Slots 1.. where two tables differ; a table of fewer slots (the
    control) stands for every slot with the same low bits.  Slot 0, where
    no lookup reads, is left out."""
    n, m = reference.numel(), program.numel()
    bad = 0
    step = 1 << 28
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        ref = reference[lo:hi]
        got = program[lo % m:lo % m + (hi - lo)] if m >= hi - lo else \
            program[torch.arange(lo, hi, device=program.device) % m]
        diff = ref != got
        if lo == 0:
            diff[0] = False
        bad += int(diff.sum())
    return bad
