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
under it) is kept beside it as that package's counterpart, and so are
its encodes from 3-mer and base codes (``transition_features``,
``features_from_codes``, ``features_from_packed``), which count through
K1's padded-codes entry (``ops.kernels.transition_counts``).

Functions that take tensors run where their tensors lie; given numpy or
strings they run on ``device``, the CUDA card unless ``device="cpu"``.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from palace_tpu_torch.device import input_device, resolve_device

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


def seq_to_kmer_locs(seq: str) -> Tuple[np.ndarray, int]:
    """Host-side: a sequence → ``(int32 3-mer codes, original length)``.
    Non-ACGT characters are dropped first (encode.pyx:8-12), so a 3-mer
    may span a dropped character; fewer than 3 bases give no codes."""
    codes = np.frombuffer(seq.encode().translate(_CODE_TT, _CODE_DELETE),
                          dtype=np.uint8).astype(np.int32)
    if codes.size < K:
        return np.zeros(0, dtype=np.int32), len(seq)
    return codes[:-2] * 16 + codes[1:-1] * 4 + codes[2:], len(seq)


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


def scale_by_length(counts: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """(B, 12288) counts × ``100 / max(len, 1)`` a row (encode.pyx:55), the
    quotient an IEEE division: a tensor numerator, since ``100.0 / t``
    multiplies by a reciprocal and differs from JAX in the last bit."""
    lens = torch.clamp(seq_lens.to(torch.float32), min=1.0)
    return counts * (torch.full_like(lens, 100.0) / lens)[:, None]


def _on(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(dev).to(dtype)  # copied as it lies, widened there


def transition_features(locs_padded, n_locs, seq_lens,
                        device: str | torch.device | None = None) -> torch.Tensor:
    """(B, L) padded 3-mer codes, (B,) valid counts and original lengths →
    (B, 12288) float32 features scaled ×100/len (JAX ``transition_features``).
    One launch of K1's padded-codes entry on a card (``kernels.transition_counts``:
    a code outside [0, 64) counts in no pair; ``n_locs`` above L counts as L).
    Tensors stay where they lie unless ``device`` is given; numpy goes to
    ``device``, the card by default."""
    from palace_tpu_torch.ops.kernels import transition_counts

    dev = input_device(locs_padded, device)
    counts = transition_counts(_on(locs_padded, torch.int32, dev), _on(n_locs, torch.int32, dev))
    return scale_by_length(counts.reshape(counts.shape[0], FEATURE_DIM),
                           _on(seq_lens, torch.float32, dev))


def features_from_codes(codes, n_codes, seq_lens,
                        device: str | torch.device | None = None) -> torch.Tensor:
    """(B, L) base codes (``seqs_to_code_batch``) → (B, 12288) features:
    ``locs_from_codes``, then ``transition_features``."""
    dev = input_device(codes, device)
    locs, n_locs = locs_from_codes(_on(codes, torch.int64, dev), _on(n_codes, torch.int64, dev))
    return transition_features(locs, n_locs, seq_lens, dev)


def features_from_packed(packed, n_codes, seq_lens,
                         device: str | torch.device | None = None) -> torch.Tensor:
    """(B, L/4) 2-bit packed base codes (``pack_contigs``) → (B, 12288)
    features: ``unpack_codes``, then ``features_from_codes``."""
    dev = input_device(packed, device)
    return features_from_codes(unpack_codes(_on(packed, torch.uint8, dev)), n_codes, seq_lens,
                               dev)


def encode_batch(seqs: Sequence[str], device: str | torch.device = "cuda") -> torch.Tensor:
    """A batch of sequences → (B, 12288) float32 features on ``device``,
    through the scorer's route (``byte_batch``, then ``features_from_bytes``):
    the numbers of JAX ``encode_batch``, which goes through base codes."""
    dev = resolve_device(device)
    return features_from_bytes(*(t.to(dev) for t in byte_batch(seqs)))


def encode_sequences(seqs: Iterable[str], batch_size: int = 64,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """``encode_batch`` over batches of ``batch_size`` → stacked (N, 12288)
    float32 on the host; no sequence gives (0, 12288)."""
    out: List[np.ndarray] = []
    chunk: List[str] = []
    for s in seqs:
        chunk.append(s)
        if len(chunk) == batch_size:
            out.append(encode_batch(chunk, device).cpu().numpy())
            chunk = []
    if chunk:
        out.append(encode_batch(chunk, device).cpu().numpy())
    if not out:
        return np.zeros((0, FEATURE_DIM), dtype=np.float32)
    return np.concatenate(out, axis=0)


def reference_matrix_encoding(seq: str, k: int = K) -> np.ndarray:
    """Pure-numpy oracle with the reference's exact per-sequence loop
    (encode.pyx:41-55)."""
    seq = seq.upper()
    length = len(seq)
    codes = BASE_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]
    codes = codes[codes != INVALID].astype(np.int64)
    if codes.size >= k:
        locs = [int("".join(str(c) for c in codes[i : i + k]), 4)
                for i in range(codes.size - k + 1)]
    else:
        locs = []
    feats = []
    for d in GAPS:
        m = np.zeros((NUM_CODES, NUM_CODES), dtype=np.float64)
        for i in range(0, len(locs) - k - d):
            m[locs[i], locs[i + k + d]] += 1
        feats.append(m.flatten())
    feature = np.hstack(feats)
    return feature / (length * 1.0) * 100
