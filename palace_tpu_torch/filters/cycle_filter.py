"""Cycle/length/gene/score gates on result lines.

* ``filter_cycle_gene_score`` — semantic port of
  share/palace/scripts/filter_cycle_gene_score.py: drop
  ``loop``/``iter`` lines; with ``ignore_len == 0`` require total
  length ≥10 kb (from ``_length_`` in names) (:5-31); strip
  cycle/score/self/gene/ref tags; keep multi-contig paths always,
  single-contig only with gene-hit (≥5) or score ≥0.7 (:59-77);
  re-tab-delimit preserving orientations.
* ``filter_cycle`` — legacy ≥10 kb gate
  (share/palace/scripts/filter_cycle.py, declared at palace:250 but
  never invoked).
* ``filter_remain_result`` — legacy EDGE-overlap removal
  (share/palace/scripts/filter_remain_result.py, declared at
  palace:267, never invoked).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Set

_TAGS = ("cycle", "score", "self", "gene", "ref")
_EDGE_RE = re.compile(r"EDGE_\d+_length_\d+_cov_[\d.]+")


def _strip_tags(line: str) -> str:
    for tag in _TAGS:
        line = line.replace(tag, "")
    return line


def _name_len(line: str) -> int:
    return sum(
        int(v.split("_")[3])
        for v in re.split(r"[+-]", line)
        if v.strip()
    )


def load_gene_hits_min(gene_hit_file: str | Path, min_count: int = 5) -> Set[str]:
    out: Set[str] = set()
    with open(gene_hit_file) as fh:
        for line in fh:
            parts = line.strip().split("\t")
            if len(parts) >= 2 and int(parts[1]) >= min_count:
                out.add(parts[0])
    return out


def load_score_hits_min(score_file: str | Path, min_score: float = 0.7) -> Set[str]:
    out: Set[str] = set()
    with open(score_file) as fh:
        for line in fh:
            parts = line.strip().split("\t")
            if len(parts) >= 2 and float(parts[1]) >= min_score:
                out.add(parts[0])
    return out


def filter_cycle_gene_score(
    input_file: str | Path,
    ignore_len: int,
    gene_hit_file: str | Path,
    score_file: str | Path,
    output_file: str | Path,
) -> None:
    res: Dict[str, None] = {}
    with open(input_file) as fh:
        for line in fh:
            line = line.strip()
            if "loop" in line or "iter" in line:
                continue
            if ignore_len == 0:
                line_len = sum(
                    int(v.split("_")[3]) for v in re.split(r"[+-]", line) if v.strip()
                )
                if line_len < 10000:
                    continue
            res.setdefault(_strip_tags(line).strip())

    gene_hits = load_gene_hits_min(gene_hit_file)
    score_hits = load_score_hits_min(score_file)

    with open(output_file, "w") as out:
        for item in res:
            contig_list = re.findall(r".+?[+-]", item)
            names = [c.rstrip("+-") for c in contig_list]
            if len(names) <= 1:
                if names and (names[0] in gene_hits or names[0] in score_hits):
                    out.write("\t".join(contig_list) + "\n")
            else:
                out.write("\t".join(contig_list) + "\n")


def filter_cycle(input_file: str | Path, ignore_len: int) -> List[str]:
    """Legacy filter (filter_remain/filter_cycle.py): returns kept
    tag-stripped, re-tabbed lines."""
    res: Dict[str, None] = {}
    with open(input_file) as fh:
        for line in fh:
            if "loop" in line or "iter" in line:
                continue
            line_len = 0
            for v in re.split(r"[+-]", line.strip()):
                if v in ("", " "):
                    continue
                if ignore_len == 0:
                    line_len += int(v.split("_")[3])
            liner = _strip_tags(line).strip("\n")
            if ignore_len != 0 or line_len >= 10000:
                res.setdefault(liner)
            else:
                res.setdefault(liner)
    return [item.replace("+", "+\t").replace("-", "-\t") for item in res]


def filter_remain_result(file_a: str | Path, file_b: str | Path,
                         output_file: str | Path) -> int:
    """Remove lines of ``file_a`` containing any EDGE present in
    ``file_b`` (legacy filter_remain_result.py semantics)."""
    with open(file_b) as fh:
        edges_b = set(_EDGE_RE.findall(fh.read()))
    kept = []
    with open(file_a) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if not any(e in edges_b for e in _EDGE_RE.findall(line)):
                kept.append(line)
    with open(output_file, "w") as out:
        for line in kept:
            out.write(line + "\n")
    return len(kept)
