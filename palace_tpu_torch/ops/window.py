"""Sliding-window hit-density scan over reference positions.

Reference semantics (bin/extract_ref.cpp slide_window :504-624):

* per position j: ``hit_coder_num`` = #coders whose count-table value
  equals least_depth (=3); looking up hash 0 is always a miss
  (:861-866); ``single`` = ≥1 coder, ``trio`` = all 3 coders.
* windowed counts over 500 bp: growing prefix for j<window, then
  sliding (:548-559).  A window is "good" when
  ``one_coder_bases ≥ int(window·hit_ratio)`` AND
  ``three_coder_bases ≥ int(window·perfect_hit_ratio)``; the thresholds
  truncate the *float32* product like the C++ ``int = int·float``.
* state machine emits intervals [j_enter − 2·window, j_leave + 2·window]
  clamped to [1, ref_len], merging intervals whose gap < window
  (:568-609); a run still open at the end closes at ref_len (:599).
* refs whose merged interval length exceeds 75 % of ``ref_len`` (and
  el>0) are reported: ``ref_index idx frag el len ratio`` (:611-617).

The per-position flags come from kernel K4 (``ops.kernels.good_windows``,
also as JAX's ``good_windows``/``good_windows_batch`` below); the interval
state machine runs on the host over the transitions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from palace_tpu_torch.device import input_device, resolve_device
from palace_tpu_torch.ops import kernels


def bucket_len(n: int, minimum: int = 4096) -> int:
    """Round up to the next {2^k, 1.5·2^k} bucket (at least ``minimum``),
    so references of one bucket stack into one scan; padding ≤ 50 %."""
    if n <= minimum:
        return minimum
    p = 1 << (int(n - 1).bit_length() - 1)  # largest power of two < n
    if n <= p + p // 2:
        return p + p // 2
    return 2 * p


def window_thresholds(window: int, hit_ratio: float, perfect_hit_ratio: float) -> Tuple[int, int]:
    """C++ ``int m = window * (float)ratio`` truncation semantics."""
    one_min = int(np.float32(window) * np.float32(hit_ratio))
    three_min = int(np.float32(window) * np.float32(perfect_hit_ratio))
    return one_min, three_min


#: rows of one launch of ``kernels.good_windows`` (a grid dimension)
_ROWS_A_LAUNCH = 65535


def good_windows_batch(counts, hashes, window: int, one_min: int, three_min: int,
                       least_depth: int = 3, device: str | torch.device | None = None
                       ) -> torch.Tensor:
    """Per-position good-window flags of a stack of references: (NB, L, 3)
    uint8 count-table values and hashes of any integer dtype (hash 0 a
    permanent miss) → (NB, L) bool, JAX ``good_windows_batch``.

    L is padded to a multiple of 8 with misses (a window only looks back,
    so the pad changes no flag), ``kernels.good_windows`` runs once for
    every 65,535 rows, and its little-endian bits are unpacked and cut to
    L.  On the card a window above ``kernels.GOOD_WINDOWS_MAX_WINDOW``
    raises; the CPU takes any window.  Tensors stay where they lie unless
    ``device`` is given; numpy goes to ``device``, the card by default."""
    dev = input_device(counts, device)
    counts = torch.as_tensor(counts).to(dev, torch.uint8)
    # int64 before the copy: uint32 hashes at or above 2^31 keep their value
    hashes = torch.as_tensor(hashes).to(torch.int64).to(dev)
    NB, L = counts.shape[:2]
    pad = -L % 8
    counts = torch.nn.functional.pad(counts, (0, 0, 0, pad))
    hashes = torch.nn.functional.pad(hashes, (0, 0, 0, pad))
    bits = torch.cat([kernels.good_windows(counts[r:r + _ROWS_A_LAUNCH],
                                           hashes[r:r + _ROWS_A_LAUNCH], window, one_min,
                                           three_min, least_depth)
                      for r in range(0, max(NB, 1), _ROWS_A_LAUNCH)])
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    return ((bits[:, :, None] >> shifts) & 1).reshape(NB, L + pad)[:, :L].bool()


def good_windows(counts, hashes, window: int, one_min: int, three_min: int,
                 least_depth: int = 3, device: str | torch.device | None = None
                 ) -> torch.Tensor:
    """``good_windows_batch`` of one reference: (L, 3) counts and hashes →
    (L,) bool, JAX ``good_windows``."""
    dev = input_device(counts, device)
    return good_windows_batch(torch.as_tensor(counts)[None], torch.as_tensor(hashes)[None],
                              window, one_min, three_min, least_depth, dev)[0]


def unpack_good(bits: np.ndarray, n: int) -> np.ndarray:
    """Little-endian packed flags of one row → its first ``n`` flags as bool."""
    return np.unpackbits(np.asarray(bits), bitorder="little")[:n].astype(bool)


def intervals_from_good(good: np.ndarray, ref_len: int, window: int) -> List[Tuple[int, int]]:
    """Replay the reference interval state machine over transition
    events (extract_ref.cpp:568-609)."""
    good = np.asarray(good, dtype=bool)
    out: List[Tuple[int, int]] = []
    padded = np.concatenate([[False], good])
    enters = np.flatnonzero(~padded[:-1] & good)       # first good j of a run
    leaves = np.flatnonzero(padded[:-1] & ~good)       # first bad j after a run
    li = 0
    for e in enters:
        start = max(e - 2 * window, 1)
        while li < len(leaves) and leaves[li] <= e:
            li += 1
        if li < len(leaves):
            end = min(leaves[li] + 2 * window, ref_len)
        else:
            end = ref_len  # run open at EOF (:599-609)
        if out and start - out[-1][1] < window:
            out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


@dataclass
class RefHit:
    ref_index: int
    frag_count: int
    covered: int
    ref_len: int
    ratio: float

    def line(self) -> str:
        """stdout line of extract_ref.cpp:617.  The reference's ``el_ratio``
        is a C ``float`` printed at 6 significant digits; round through
        float32 so the text is byte-identical."""
        return (
            f"ref_index\t{self.ref_index}\t{self.frag_count}\t{self.covered}"
            f"\t{self.ref_len}\t{float(np.float32(self.ratio)):g}"
        )


def hit_from_good(good: np.ndarray, ref_index: int, ref_len: int, window: int,
                  min_cover_ratio: float) -> RefHit | None:
    """The reference's verdict on one reference from its good flags: a
    ``RefHit`` when the merged intervals cover more than ``min_cover_ratio``."""
    iv = intervals_from_good(good, ref_len, window)
    el = sum(e - s for s, e in iv)
    # float(el)/float(ref_len) in the reference: float32 arithmetic
    ratio = float(np.float32(el) / np.float32(ref_len)) if ref_len else 0.0
    if el > 0 and np.float32(ratio) > np.float32(min_cover_ratio):
        return RefHit(ref_index, len(iv), el, ref_len, ratio)
    return None


def scan_reference(
    counts: np.ndarray | torch.Tensor,
    hashes: np.ndarray | torch.Tensor,
    ref_index: int,
    ref_len: int,
    window: int = 500,
    hit_ratio: float = 0.9,
    perfect_hit_ratio: float = 0.85,
    min_cover_ratio: float = 0.75,
    least_depth: int = 3,
    device: str | torch.device = "cuda",
) -> RefHit | None:
    """Full per-reference scan through K4 on ``device`` (the CUDA card
    unless ``device="cpu"``): (L, 3) counts and hashes cover the first
    ref_len-k+1 positions (or are zero-padded to ref_len).  Returns a
    RefHit when coverage > min_cover_ratio."""
    dev = resolve_device(device)
    if not isinstance(counts, torch.Tensor):
        counts = torch.from_numpy(np.asarray(counts, np.uint8))
    if not isinstance(hashes, torch.Tensor):
        hashes = torch.from_numpy(np.asarray(hashes).astype(np.int64))
    counts, hashes = counts.to(dev, torch.uint8), hashes.to(dev, torch.int64)
    L = counts.shape[0]
    # pad to the length bucket with hash 0 (a permanent miss); the flags
    # are cut back to ref_len before the interval machine
    target = bucket_len(max(ref_len, L))
    counts = torch.nn.functional.pad(counts, (0, 0, 0, target - L))
    hashes = torch.nn.functional.pad(hashes, (0, 0, 0, target - L))
    one_min, three_min = window_thresholds(window, hit_ratio, perfect_hit_ratio)
    bits = kernels.good_windows(counts[None], hashes[None], window, one_min, three_min,
                                least_depth)
    good = unpack_good(bits[0].cpu().numpy(), ref_len)
    return hit_from_good(good, ref_index, ref_len, window, min_cover_ratio)
