"""SEG/JUNC conjugate-graph file model.

The graph file is the central data contract of the pipeline:
``SEG <name> <depth> <copy>`` and
``JUNC <left> <±> <right> <±> <support> <spanNoFastg>`` lines written
by the graph builder (reference generate_graph.cpp:1048-1076).
``filter_graph`` appends ``<gene> <score> <is_blast>`` columns to SEG
lines (filter_graph.py:197) and ``create_sub_graph`` appends a
ref-order column (create_sub_graph.py:74-77).  This module gives the
whole framework one typed representation of those lines.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple


@dataclass
class SegRecord:
    name: str
    depth: float
    copy_number: int
    gene: Optional[str] = None       # gene-hit flag/count column
    score: Optional[str] = None      # GCN score column (string-formatted)
    is_blast: Optional[str] = None   # blast-covered flag column
    ref_order: Optional[str] = None  # order along a reference (subgraphs)

    def contig_length(self) -> int:
        """Length parsed from SPAdes-style names ``EDGE_<id>_length_<L>_cov_<c>``
        (filter_graph.py:49-51)."""
        return int(self.name.split("_")[3])

    def to_line(self) -> str:
        parts = ["SEG", self.name, _fmt_num(self.depth), str(self.copy_number)]
        for extra in (self.gene, self.score, self.is_blast, self.ref_order):
            if extra is not None:
                parts.append(str(extra))
        return " ".join(parts)


@dataclass(frozen=True)
class JuncKey:
    left: str
    left_orient: str
    right: str
    right_orient: str

    def conjugate(self) -> "JuncKey":
        """The reverse-complement junction (make_final_fa.py:27-34)."""
        flip = {"+": "-", "-": "+"}
        return JuncKey(self.right, flip[self.right_orient], self.left, flip[self.left_orient])


@dataclass
class JuncRecord:
    left: str
    left_orient: str
    right: str
    right_orient: str
    support: int
    span_no_fastg: int = 0
    extras: List[str] = field(default_factory=list)

    @property
    def key(self) -> JuncKey:
        return JuncKey(self.left, self.left_orient, self.right, self.right_orient)

    def to_line(self) -> str:
        parts = [
            "JUNC",
            self.left,
            self.left_orient,
            self.right,
            self.right_orient,
            str(self.support),
            str(self.span_no_fastg),
        ]
        parts.extend(self.extras)
        return " ".join(parts)


def _fmt_num(x: float) -> str:
    """Format depth like C++ ``operator<<(double)`` (6 significant digits)."""
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return f"{x:.6g}"


@dataclass
class Graph:
    segs: Dict[str, SegRecord] = field(default_factory=dict)
    juncs: List[JuncRecord] = field(default_factory=list)

    def add_seg(self, seg: SegRecord) -> None:
        self.segs[seg.name] = seg

    def add_junc(self, junc: JuncRecord) -> None:
        self.juncs.append(junc)

    def adjacency_with_conjugates(self) -> Dict[str, set]:
        """Oriented-node adjacency including conjugate edges
        (make_final_fa.py:9-36)."""
        adj: Dict[str, set] = {}
        for j in self.juncs:
            src = f"{j.left}{j.left_orient}"
            dst = f"{j.right}{j.right_orient}"
            adj.setdefault(src, set()).add(dst)
            conj = j.key.conjugate()
            adj.setdefault(f"{conj.left}{conj.left_orient}", set()).add(
                f"{conj.right}{conj.right_orient}"
            )
        return adj


def parse_graph_line(line: str) -> Optional[SegRecord | JuncRecord]:
    fields = line.rstrip().split()
    if not fields:
        return None
    if fields[0] == "SEG":
        extras = fields[4:]
        return SegRecord(
            name=fields[1],
            depth=float(fields[2]),
            copy_number=int(float(fields[3])),
            gene=extras[0] if len(extras) > 0 else None,
            score=extras[1] if len(extras) > 1 else None,
            is_blast=extras[2] if len(extras) > 2 else None,
            ref_order=extras[3] if len(extras) > 3 else None,
        )
    if fields[0] == "JUNC":
        return JuncRecord(
            left=fields[1],
            left_orient=fields[2],
            right=fields[3],
            right_orient=fields[4],
            support=int(fields[5]) if len(fields) > 5 else 0,
            span_no_fastg=int(fields[6]) if len(fields) > 6 else 0,
            extras=fields[7:],
        )
    return None


def parse_graph_file(path: str | Path) -> Graph:
    g = Graph()
    with open(path) as fh:
        for line in fh:
            rec = parse_graph_line(line)
            if isinstance(rec, SegRecord):
                g.add_seg(rec)
            elif isinstance(rec, JuncRecord):
                g.add_junc(rec)
    return g


def write_graph_file(path: str | Path, graph: Graph) -> None:
    """SEGs first (name-sorted, like the builder's std::map iteration,
    generate_graph.cpp:1048), then JUNCs in insertion order."""
    with open(path, "w") as fh:
        for name in sorted(graph.segs):
            fh.write(graph.segs[name].to_line() + "\n")
        for junc in graph.juncs:
            fh.write(junc.to_line() + "\n")
