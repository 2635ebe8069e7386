"""3-mer transition-matrix contig encoder.

Reference semantics (encode.pyx:8-55 of the original PALACE): uppercase
the sequence, drop non-ACGT characters (shifting positions), form
K=3-mer base-4 codes, and for gaps d ∈ {0,1,2} count transitions
``matrix[loc[i], loc[i+K+d]] += 1`` over ``i < len(loc)-K-d``; the three
64×64 matrices are flattened, concatenated and scaled by
``100/len(seq)`` (original length, dropped characters included).

The host only concatenates each batch's UTF-8 bytes (``byte_batch``);
the card drops the non-ACGT bytes, counts and scales in one kernel
(``features_from_bytes``, ``ops.kernels.transition_features_bytes``).
The 2-bit packing of the JAX package (``pack_contigs`` and the functions
under it) is kept beside it as that package's counterpart.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

K = 3
NUM_CODES = 64  # 4**K
GAPS = (0, 1, 2)
FEATURE_DIM = len(GAPS) * NUM_CODES * NUM_CODES  # 12288

# byte → base code (A0 C1 G2 T3, either case; INVALID for every other
# byte), as in encode.pyx:9
INVALID = 255
BASE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    BASE_LUT[ord(_ch)] = _code
    BASE_LUT[ord(_ch.lower())] = _code

# bytes.translate tables: map ACGT/acgt → code byte and delete everything
# else, in one C pass
_CODE_TT = bytes(int(BASE_LUT[i]) if BASE_LUT[i] != INVALID else 0 for i in range(256))
_CODE_DELETE = bytes(i for i in range(256) if BASE_LUT[i] == INVALID)


def byte_batch(seqs: Sequence[str], pin_memory: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host-side: sequences → CPU tensors ``(data (N,) uint8, offsets (B+1,)
    int64, seq_lens (B,) int32)``, the scorer's input.  ``data`` is every
    ``s.encode()`` concatenated, row b being ``data[offsets[b]:offsets[b+1]]``;
    ``seq_lens`` counts characters, not bytes: a non-ASCII character is
    several bytes, all dropped, and the scale divides by ``len(s)``.  With
    ``pin_memory`` the three are allocated pinned and the bytes written
    there directly, for a copy to a card that does not wait."""
    bufs = [s.encode() for s in seqs]
    offsets = torch.zeros(len(bufs) + 1, dtype=torch.int64, pin_memory=pin_memory)
    np.cumsum([len(b) for b in bufs], out=offsets.numpy()[1:])
    data = torch.empty(int(offsets[-1]), dtype=torch.uint8, pin_memory=pin_memory)
    # one copy a row with the GIL held: numpy's copies release it for every
    # row, and each release hands it to the scorer's dispatching thread
    view = memoryview(data.numpy())
    for buf, lo in zip(bufs, offsets.tolist()):
        view[lo:lo + len(buf)] = buf
    seq_lens = torch.empty(len(seqs), dtype=torch.int32, pin_memory=pin_memory)
    seq_lens.numpy()[:] = np.fromiter(map(len, seqs), dtype=np.int32, count=len(seqs))
    return data, offsets, seq_lens


def _pad_to_multiple(n: int, m: int = 512) -> int:
    return max(m, ((n + m - 1) // m) * m)


def seqs_to_code_batch(seqs: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: sequences → ``(codes (B, L) int8 padded with 0,
    n_codes (B,) int32, orig_lens (B,) int32)``.  Non-ACGT characters are
    compacted out; L is a multiple of 512 that leaves room for 2 more."""
    code_list = []
    for s in seqs:
        code_list.append(np.frombuffer(s.encode().translate(_CODE_TT, _CODE_DELETE),
                                       dtype=np.uint8))
    lens = [c.size for c in code_list]
    L = _pad_to_multiple((max(lens) if lens else 1) + 2)
    padded = np.zeros((len(seqs), L), dtype=np.int8)
    for i, codes in enumerate(code_list):
        padded[i, : codes.size] = codes
    return (padded, np.asarray(lens, dtype=np.int32),
            np.asarray([len(s) for s in seqs], dtype=np.int32))


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Host-side: (B, L) int8 base codes (L % 4 == 0) → (B, L//4) uint8,
    4 bases a byte, base j in bits 2·(j%4) of byte j//4."""
    c = codes.astype(np.uint8)
    return c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)


def pack_contigs(seqs: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: sequences → ``(packed (B, L//4) uint8, n_codes, orig_lens)``,
    the scorer's input."""
    codes, n_codes, lens = seqs_to_code_batch(seqs)
    return pack_codes(codes), n_codes, lens


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_codes``: (B, P) uint8 → (B, 4P) int64."""
    p = packed.to(torch.int64)
    parts = torch.stack([(p >> (2 * i)) & 3 for i in range(4)], dim=2)
    return parts.reshape(p.shape[0], p.shape[1] * 4)


def locs_from_codes(codes: torch.Tensor, n_codes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) base codes → ((B, L-2) int64 3-mer codes, (B,) valid-code
    counts ``max(n_codes - 2, 0)``)."""
    c = codes.to(torch.int64)
    locs = c[:, :-2] * 16 + c[:, 1:-1] * 4 + c[:, 2:]
    n_locs = torch.clamp(n_codes.to(torch.int64) - (K - 1), min=0)
    return locs, n_locs


def features_from_bytes(data: torch.Tensor, offsets: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    """A ``byte_batch`` → (B, 12288) float32 features, counts scaled by
    ``100 / max(len, 1)``: one call of the transition-count kernel on a
    CUDA device."""
    from palace_tpu_torch.ops.kernels import transition_features_bytes

    return transition_features_bytes(data, offsets, seq_lens)

