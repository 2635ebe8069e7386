"""Per-position read depth as ``samtools depth`` writes it, in plain NumPy.

A read covers the reference positions of its CIGAR's M, = and X blocks,
from its leftmost position (0-based); D and N move along the reference
and cover nothing; S, H, I and P neither move nor cover.  Coverage past
a contig's end is dropped.  Each contig's depth is the running sum of a
difference array (+1 where a block starts, -1 where it ends).  The text
has one line ``<contig>\\t<position>\\t<depth>\\n`` for each position
with depth above 0, 1-based, contigs in the BAM's order.

``soft_clips=True`` gives the check's control: soft-clipped bases counted
as covered and moving along the reference, as an aligner's full read
length would be.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

COVER = set("M=X")
SKIP = set("DN")

Record = Tuple[int, int, Sequence[Tuple[int, str]]]   # tid, 0-based pos, cigar


def blocks(records: Iterable[Record], soft_clips: bool = False
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tid, start, end) of every covered block of ``records``."""
    tid: List[int] = []
    start: List[int] = []
    end: List[int] = []
    for t, pos, cigar in records:
        for n, op in cigar:
            covers = op in COVER or (soft_clips and op == "S")
            if covers:
                tid.append(t)
                start.append(pos)
                end.append(pos + n)
            if covers or op in SKIP:
                pos += n
    return (np.asarray(tid, np.int64), np.asarray(start, np.int64), np.asarray(end, np.int64))


def depths(lengths: Sequence[int], records: Iterable[Record], soft_clips: bool = False
           ) -> np.ndarray:
    """Every contig's depth, concatenated in the BAM's order (int64)."""
    lengths = np.asarray(lengths, np.int64)
    first = np.concatenate([[0], np.cumsum(lengths)])
    tid, start, end = blocks(records, soft_clips)
    end = np.minimum(end, lengths[tid])
    keep = start < end
    total = int(first[-1])
    diff = np.bincount(first[tid[keep]] + start[keep], minlength=total + 1)
    diff -= np.bincount(first[tid[keep]] + end[keep], minlength=total + 1)
    return np.cumsum(diff[:total])


def _digits(values: np.ndarray, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, width) ASCII digits of ``values``, zero-padded, and the mask
    of the digits written (no leading zeros; 0 is one digit)."""
    scale = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    digits = (values[:, None] // scale) % 10 + ord("0")
    mask = (values[:, None] >= scale) | (scale == 1)
    return digits.astype(np.uint8), mask


def depth_text(names: Sequence[str], lengths: Sequence[int], depth: np.ndarray,
               rows: int = 1 << 20) -> bytes:
    """The depth file of ``depth`` (``depths``'s layout) as bytes."""
    lengths = np.asarray(lengths, np.int64)
    first = np.concatenate([[0], np.cumsum(lengths)])
    encoded = [n.encode() for n in names]
    width = max((len(n) for n in encoded), default=1)
    name_mat = np.zeros((len(encoded), width), np.uint8)
    name_len = np.array([len(n) for n in encoded], np.int64)
    for i, n in enumerate(encoded):
        name_mat[i, :len(n)] = np.frombuffer(n, np.uint8)
    cols = np.arange(width)
    (where,) = np.nonzero(depth)
    out = []
    for lo in range(0, where.size, rows):
        idx = where[lo:lo + rows]
        contig = np.searchsorted(first, idx, side="right") - 1
        pos_d, pos_m = _digits(idx - first[contig] + 1, 12)
        dep_d, dep_m = _digits(depth[idx], 12)
        n = idx.size
        tab = np.full((n, 1), ord("\t"), np.uint8)
        mat = np.hstack([name_mat[contig], tab, pos_d, tab, dep_d,
                         np.full((n, 1), ord("\n"), np.uint8)])
        one = np.ones((n, 1), bool)
        mask = np.hstack([cols[None, :] < name_len[contig][:, None], one, pos_m, one, dep_m,
                          one])
        out.append(mat[mask].tobytes())
    return b"".join(out)


def lines_wrong(got: bytes, want: bytes) -> int:
    """Lines of ``got`` not in ``want`` and of ``want`` not in ``got``
    (as multisets), or 1 where only their order differs."""
    if got == want:
        return 0
    from collections import Counter

    a, b = Counter(got.split(b"\n")), Counter(want.split(b"\n"))
    return sum(((a - b) + (b - a)).values()) or 1
