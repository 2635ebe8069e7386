"""Three-coder canonical k-mer hashes on tensors.

Reference semantics (bin/extract_ref.cpp):

* three binary base projections ("coders", :1010-1054):
  coder0: A/T→1, C/G→0;  coder1: A/C→1, T/G→0;  coder2: A/G→1, T/C→0;
  any other character invalidates the k-mer.
* a per-position permutation of the three coders ("choose_coder",
  :1082-1102): hash slot ``i`` at k-mer offset ``z`` uses coder
  ``perm[z, i]``.  It is drawn from a fixed seed, the same numpy draw as
  the JAX package's, so indexes and tables of both packages agree.
* forward hash h_i(j) = Σ_z bit_{perm[z,i]}(s[j+z]) · 2^(k-1-z); the
  reverse-complement hash reads the complemented projections back to
  front; canonical = min(fwd, rc).  Complementing a base leaves coder0
  unchanged and flips coder1 and coder2, so the rc bit streams are
  ``[b0, 1-b1, 1-b2]``.

Hashes are int64: they stay below 2^k ≤ 2^32, and PyTorch on the CPU has
no ``minimum``, ``>>`` or ``+`` for uint32.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: the 6 permutations of (0,1,2) in the reference's order (extract_ref.cpp:1084)
_PERMUTATIONS = np.array(
    [[0, 1, 2], [0, 2, 1], [1, 2, 0], [1, 0, 2], [2, 0, 1], [2, 1, 0]], dtype=np.int32
)

# base codes: A=0 C=1 G=2 T=3, invalid=4
BASE_LUT = np.full(256, 4, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    BASE_LUT[ord(_ch)] = _code
    BASE_LUT[ord(_ch.lower())] = _code

#: coder bit per (coder, base code) — extract_ref.cpp:1017-1051
#: (column 4 = invalid placeholder, masked separately)
CODER_BITS = np.array(
    [
        [1, 0, 0, 1, 0],  # coder0: A,T → 1
        [1, 1, 0, 0, 0],  # coder1: A,C → 1
        [1, 0, 1, 0, 0],  # coder2: A,G → 1
    ],
    dtype=np.uint32,
)


def make_choose_coder(k: int, seed: int = 1) -> np.ndarray:
    """Deterministic per-position coder permutation, shape (k, 3)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 6, size=k)
    return _PERMUTATIONS[rows]


def seq_to_codes(seq: str) -> np.ndarray:
    return BASE_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]


def perm_to_key(perm: np.ndarray) -> Tuple[Tuple[int, int, int], ...]:
    """Hashable form of the (k, 3) coder permutation."""
    return tuple(tuple(int(x) for x in row) for row in np.asarray(perm))


def kmer_hashes(codes: torch.Tensor, perm: np.ndarray, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical 3-coder hashes of every k-mer of a code batch.

    codes: (B, L) integer tensor of base codes (0..3, ≥4 invalid)
    perm:  (k, 3) coder permutation, on the host (it shapes the loop)
    Returns ``(hashes (B, L-k+1, 3) int64, valid (B, L-k+1) bool)`` on
    the codes' device.  Hashes of invalid k-mers are computed as if the
    invalid bases were all-zero bits; callers mask them with ``valid``.
    """
    B, L = codes.shape
    M = L - k + 1
    dev = codes.device
    if M <= 0:
        return (torch.zeros((B, 0, 3), dtype=torch.int64, device=dev),
                torch.zeros((B, 0), dtype=torch.bool, device=dev))
    perm = np.asarray(perm)
    c = codes.to(torch.int64).clamp_(max=4)
    # per-coder bit streams, and their complements for the rc strand
    lut = torch.from_numpy(CODER_BITS.astype(np.uint8)).to(dev)
    bits = [lut[i][c] for i in range(3)]
    comp = [bits[0], 1 - bits[1], 1 - bits[2]]
    fwd = [torch.zeros((B, M), dtype=torch.int64, device=dev) for _ in range(3)]
    rc = [torch.zeros((B, M), dtype=torch.int64, device=dev) for _ in range(3)]
    for z in range(k):
        w = 1 << (k - 1 - z)
        for i in range(3):
            cz = int(perm[z, i])
            # forward: coder cz at j+z; reverse complement: complemented
            # coder cz at j+(k-1-z), with the same weight
            fwd[i].add_(bits[cz][:, z:z + M], alpha=w)
            rc[i].add_(comp[cz][:, k - 1 - z:k - 1 - z + M], alpha=w)
    hashes = torch.stack([torch.minimum(f, r) for f, r in zip(fwd, rc)], dim=2)
    invalid = (c >= 4).to(torch.int32)
    inv_cum = torch.cumsum(invalid, dim=1)
    before = torch.nn.functional.pad(inv_cum, (1, 0))[:, :M]
    valid = (inv_cum[:, k - 1:] - before) == 0
    return hashes, valid


def kmer_hashes_np(codes: np.ndarray, perm: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host oracle of the reference's scalar hash loop (extract_ref.cpp:965-999):
    codes (L,) 0..4 → ((L-k+1, 3) uint32 canonical hashes, valid mask)."""
    comple_code = {0: 3, 1: 2, 2: 1, 3: 0, 4: 4}
    L = codes.shape[-1]
    M = L - k + 1
    hashes = np.zeros((M, 3), dtype=np.uint64)
    valid = np.zeros(M, dtype=bool)
    base = [2 ** (k - 1 - z) for z in range(k)]
    for j in range(M):
        ok = True
        for i in range(3):
            h = 0
            hc = 0
            for z in range(k):
                b = int(codes[j + z])
                if b >= 4:
                    ok = False
                    break
                h += int(CODER_BITS[int(perm[z, i]), b]) * base[z]
                # n = coder[choose_coder[(k-1-z)*3+i]][comple(s[j+z])], weight base[k-1-z]
                hc += int(CODER_BITS[int(perm[k - 1 - z, i]), comple_code[b]]) * base[k - 1 - z]
            if not ok:
                break
            hashes[j, i] = min(h, hc)
        valid[j] = ok
    return hashes.astype(np.uint32), valid


def kmer_hashes_masked(codes: torch.Tensor, perm: np.ndarray, k: int) -> torch.Tensor:
    """``kmer_hashes`` with invalid k-mers set to hash 0, the reference's
    permanent-miss slot (extract_ref.cpp:793-796)."""
    h, valid = kmer_hashes(codes, perm, k)
    return h.masked_fill_(~valid[..., None], 0)


def coder_masks(perm: np.ndarray, k: int) -> np.ndarray:
    """The hash as bit masks over coder bit-planes, (2, 3, 3) uint32
    ``[direction][slot][coder]``: ``[0][i][c]`` has bit z set where
    ``perm[z, i] == c``, ``[1][i][c]`` bit p where ``perm[k-1-p, i] == c``.

    With ``win_c`` the k bits of coder c from position j (bit z for j+z)
    and ``comp_c`` those of its complement, slot i's forward hash is the
    low k bits of ``OR_c win_c & [0][i][c]`` reversed, and its reverse
    complement is ``OR_c comp_c & [1][i][c]`` as it stands."""
    perm = np.asarray(perm)[:k]
    bit = np.uint64(1) << np.arange(k, dtype=np.uint64)
    coder = np.arange(3)[:, None, None]
    # (direction, coder, z, slot) one-hot, weighted by bit z, summed over z
    picks = np.stack([perm == coder, perm[::-1] == coder])
    return (picks * bit[:, None]).sum(axis=2).transpose(0, 2, 1).astype(np.uint32)


def pack_codes_mask(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host packing: (B, L) base codes 0..4 (L % 8 == 0) →
    ``(packed (B, L//4) uint8, invalid (B, L//8) uint8)``: 2 bits a base
    (invalid codes pack as base 0) and a little-endian invalid bitmask."""
    c = codes.astype(np.uint8)
    inv = c >= 4
    c2 = np.where(inv, 0, c)
    packed = (c2[:, 0::4] | (c2[:, 1::4] << 2) | (c2[:, 2::4] << 4)
              | (c2[:, 3::4] << 6))
    mask = np.packbits(inv, axis=1, bitorder="little")
    return packed, mask


def unpack_codes_mask(packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_codes_mask`` on tensors → (B, 4·P) uint8 codes,
    with 4 restored at invalid positions."""
    p = packed.to(torch.uint8)
    codes = torch.stack([(p >> (2 * i)) & 3 for i in range(4)], dim=2)
    codes = codes.reshape(p.shape[0], p.shape[1] * 4)
    m = mask.to(torch.uint8)
    inv = torch.stack([(m >> i) & 1 for i in range(8)], dim=2)
    inv = inv.reshape(m.shape[0], m.shape[1] * 8).to(torch.bool)
    return codes.masked_fill_(inv, 4)
