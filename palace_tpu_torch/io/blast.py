"""BLAST outfmt-6 tabular readers.

The pipeline uses two custom column layouts:

* layout A (palace:528): ``qseqid sseqid pident length mismatch gapopen
  qstart qend sstart send evalue bitscore qlen slen``
* layout B (palace:625/794): ``qaccver saccver pident qlen slen length
  mismatch gapopen qstart qend sstart send evalue bitscore``

Readers return typed hits with named fields so downstream filters
don't index raw columns.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List


@dataclass
class BlastHit:
    query: str
    subject: str
    pident: float
    length: int
    mismatch: int
    gapopen: int
    qstart: int
    qend: int
    sstart: int
    send: int
    evalue: float
    bitscore: float
    qlen: int = 0
    slen: int = 0

    @property
    def s_lo(self) -> int:
        return min(self.sstart, self.send)

    @property
    def s_hi(self) -> int:
        return max(self.sstart, self.send)

    @property
    def q_lo(self) -> int:
        return min(self.qstart, self.qend)

    @property
    def q_hi(self) -> int:
        return max(self.qstart, self.qend)

    @property
    def plus_strand(self) -> bool:
        return self.sstart < self.send


def _parse_layout_a(f: List[str]) -> BlastHit:
    return BlastHit(
        query=f[0], subject=f[1], pident=float(f[2]), length=int(f[3]),
        mismatch=int(f[4]), gapopen=int(f[5]), qstart=int(f[6]), qend=int(f[7]),
        sstart=int(f[8]), send=int(f[9]), evalue=float(f[10]), bitscore=float(f[11]),
        qlen=int(f[12]) if len(f) > 12 else 0, slen=int(f[13]) if len(f) > 13 else 0,
    )


def _parse_layout_b(f: List[str]) -> BlastHit:
    return BlastHit(
        query=f[0], subject=f[1], pident=float(f[2]), qlen=int(f[3]), slen=int(f[4]),
        length=int(f[5]), mismatch=int(f[6]), gapopen=int(f[7]), qstart=int(f[8]),
        qend=int(f[9]), sstart=int(f[10]), send=int(f[11]), evalue=float(f[12]),
        bitscore=float(f[13]),
    )


def read_outfmt6(path: str | Path, layout: str = "a") -> Iterator[BlastHit]:
    """Iterate hits; ``layout`` is ``"a"`` or ``"b"`` (see module doc)."""
    parse = _parse_layout_a if layout == "a" else _parse_layout_b
    with open(path) as fh:
        for raw in fh:
            fields = raw.rstrip("\n").split("\t")
            if len(fields) < 12:
                continue
            yield parse(fields)
