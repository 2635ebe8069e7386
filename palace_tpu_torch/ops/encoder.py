"""3-mer transition-matrix contig encoder.

Reference semantics (encode.pyx:8-55 of the original PALACE): uppercase
the sequence, drop non-ACGT characters (shifting positions), form
K=3-mer base-4 codes, and for gaps d ∈ {0,1,2} count transitions
``matrix[loc[i], loc[i+K+d]] += 1`` over ``i < len(loc)-K-d``; the three
64×64 matrices are flattened, concatenated and scaled by
``100/len(seq)`` (original length, dropped characters included).

The host packs each batch into 2-bit base codes (4 bases a byte); the
device unpacks, counts and scales in one kernel
(``ops.kernels.transition_features``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

K = 3
NUM_CODES = 64  # 4**K
GAPS = (0, 1, 2)
FEATURE_DIM = len(GAPS) * NUM_CODES * NUM_CODES  # 12288

# base → code lookup (A0 C1 G2 T3, others invalid), as in encode.pyx:9
_BASE_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _BASE_LUT[ord(_ch)] = _code
    _BASE_LUT[ord(_ch.lower())] = _code

# bytes.translate tables: map ACGT/acgt → code byte and delete everything
# else, in one C pass
_CODE_TT = bytes(int(_BASE_LUT[i]) if _BASE_LUT[i] != 255 else 0 for i in range(256))
_CODE_DELETE = bytes(i for i in range(256) if _BASE_LUT[i] == 255)


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


def features_from_packed(packed: torch.Tensor, n_codes: torch.Tensor,
                         seq_lens: torch.Tensor) -> torch.Tensor:
    """2-bit-packed base codes → (B, 12288) float32 features, counts
    scaled by ``100 / max(len, 1)`` — one launch of the transition-count
    kernel on a CUDA device."""
    from palace_tpu_torch.ops.kernels import transition_features

    return transition_features(packed, n_codes, seq_lens)

