"""Per-position coverage depth — the framework's replacement for
``samtools depth`` + bgzip + tabix (palace:538-544) and for the
tabix-indexed queries in create_sub_graph.py:133-168 and
corrected_dup.py:167-178.

Depth counts primary/secondary-filtered reads covering each reference
position (CIGAR ops M/D/N/=/X), skipping UNMAP/SECONDARY/QCFAIL/DUP
like samtools' default read filter.  The store keeps per-contig numpy
arrays and can emit the reference-compatible 3-column text file
(only positions with depth > 0, 1-based).
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from palace_tpu_torch.io.bam import (
    FLAG_DUP,
    FLAG_QCFAIL,
    FLAG_SECONDARY,
    FLAG_UNMAP,
    BamFile,
    BamStream,
)

_COVERING_OPS = set("MDN=X")


@dataclass
class DepthStore:
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)

    def contig_depths(self, contig: str) -> Optional[np.ndarray]:
        return self.arrays.get(contig)

    def covered_positions(self, contig: str) -> np.ndarray:
        """Depth values at covered positions only — what a tabix fetch
        over the samtools-depth file yields (create_sub_graph.py:210)."""
        arr = self.arrays.get(contig)
        if arr is None:
            return np.zeros(0, np.int64)
        return arr[arr > 0]

    def average_depth(self, contig: str) -> Tuple[float, int]:
        """(mean over covered positions, #covered) — matches averaging
        tabix-fetched rows (create_sub_graph.py:224-227)."""
        vals = self.covered_positions(contig)
        if vals.size == 0:
            return 0.0, 0
        return float(vals.mean()), int(vals.size)

    def global_average(self) -> float:
        """awk '{sum+=$3} END {sum/NR}' over the depth file
        (palace:542)."""
        total = 0
        n = 0
        for arr in self.arrays.values():
            nz = arr[arr > 0]
            total += int(nz.sum())
            n += int(nz.size)
        return total / n if n else 0.0

    def write_text(self, path: str | Path, compress: bool = False) -> None:
        opener = gzip.open if compress or str(path).endswith(".gz") else open
        with opener(path, "wt") as fh:
            for contig, arr in self.arrays.items():
                (pos,) = np.nonzero(arr)
                for i in pos:
                    fh.write(f"{contig}\t{i + 1}\t{arr[i]}\n")

    @classmethod
    def read_text(cls, path: str | Path) -> "DepthStore":
        opener = gzip.open if str(path).endswith(".gz") else open
        tmp: Dict[str, List[Tuple[int, int]]] = {}
        with opener(path, "rt") as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3:
                    continue
                tmp.setdefault(parts[0], []).append((int(parts[1]), int(parts[2])))
        store = cls()
        for contig, rows in tmp.items():
            size = max(p for p, _ in rows)
            arr = np.zeros(size, np.int32)
            for p, d in rows:
                arr[p - 1] = d
            store.arrays[contig] = arr
        return store


def compute_depth(bam: BamFile | str | Path) -> DepthStore:
    if isinstance(bam, BamFile):
        records = bam.records
    else:  # stream: constant memory
        bam = BamStream(bam)
        records = bam
    store = DepthStore()
    for name, length in bam.references:
        store.arrays[name] = np.zeros(length, np.int32)
    skip = FLAG_UNMAP | FLAG_SECONDARY | FLAG_QCFAIL | FLAG_DUP
    for rec in records:
        if rec.flag & skip or rec.tid < 0:
            continue
        name = bam.references[rec.tid][0]
        arr = store.arrays[name]
        pos = rec.pos
        for n, op in rec.cigar:
            if op in _COVERING_OPS:
                end = min(pos + n, arr.shape[0])
                if pos < end:
                    arr[pos:end] += 1
                pos += n
    return store


def average_depth_of_file(depth_path: str | Path) -> float:
    store = DepthStore.read_text(depth_path)
    return store.global_average()
