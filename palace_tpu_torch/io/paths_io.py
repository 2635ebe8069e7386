"""Path/result-file model.

Result files are lines of tab-separated oriented segment tokens
(``EDGE_12_length_3456_cov_7.8+\\tEDGE_9_..-``) with optional
``iter``/``self`` marker lines emitted by the matching solver and
consumed downstream (filter_result.py:125-130,
make_fa_from_path.py:94-96, remove_cycle_dup.py:9-27).

SPAdes ``contigs.paths`` hint files are also parsed here
(filter_graph.py:126-151 consumes them via node numbers).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

#: tags the pipeline prepends to result lines and strips later
#: (filter_result.py:146-170, filter_cycle_gene_score.py:27,
#: filter_by_blast.py:218, corrected-dup path keys)
RESULT_TAGS = ("cycle", "score", "self", "gene", "ref")

_ORIENT_TOKEN = re.compile(r".+?[+-]")


@dataclass
class PathLine:
    """One oriented path: a list of ``NAME+``/``NAME-`` tokens."""

    tokens: List[str]
    marker: Optional[str] = None  # "iter"/"self" header that preceded it

    def line(self) -> str:
        return "\t".join(self.tokens)

    def names(self) -> List[str]:
        return [t[:-1] if t and t[-1] in "+-" else t for t in self.tokens]

    def total_length(self, fai_len: Dict[str, int]) -> int:
        return sum(fai_len[n] for n in self.names() if n)


def oriented_tokens(text: str) -> List[str]:
    """Split a (possibly concatenated, tag-free) path string into
    oriented tokens.  Handles both tab-separated and concatenated
    forms (filter_cycle_gene_score.py:66 uses the same regex)."""
    return _ORIENT_TOKEN.findall(text.replace("\t", "").replace(" ", ""))


def split_concatenated_path(text: str) -> List[str]:
    """``A+B-C+`` → ``["A+", "B-", "C+"]`` (filter_by_blast.py:27-28 style)."""
    parts = re.split(r"(\+|-)", text)
    return [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]


def strip_tags(text: str, tags: Tuple[str, ...] = RESULT_TAGS) -> str:
    for tag in tags:
        text = text.replace(tag, "")
    return text


def reverse_flip(tokens: List[str]) -> List[str]:
    """Reverse a path and flip every orientation
    (filter_ragtag.py:1-33, find_most_common_result.py:18-36)."""
    flipped = []
    for tok in reversed(tokens):
        if tok.endswith("+"):
            flipped.append(tok[:-1] + "-")
        elif tok.endswith("-"):
            flipped.append(tok[:-1] + "+")
        else:
            flipped.append(tok)
    return flipped


def path_signature(tokens: List[str]) -> Tuple[str, ...]:
    """Canonical signature treating a path and its reverse-flip as equal."""
    fwd = tuple(tokens)
    rev = tuple(reverse_flip(list(tokens)))
    return min(fwd, rev)


def iter_path_lines(path: str | Path, keep_markers: bool = True) -> Iterator[PathLine]:
    """Yield PathLines; ``iter``/``self`` marker lines attach to the
    following path (matching the pair structure remove_cycle_dup.py
    relies on)."""
    pending_marker: Optional[str] = None
    with open(path) as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            stripped = line.strip()
            if not stripped:
                continue
            if stripped.startswith("iter") or stripped.startswith("self"):
                pending_marker = "self" if stripped.startswith("self") else "iter"
                continue
            tokens = [t for t in re.split(r"\s+", stripped) if t]
            yield PathLine(tokens=tokens, marker=pending_marker if keep_markers else None)
            pending_marker = None


def write_path_lines(path: str | Path, lines: List[PathLine]) -> None:
    with open(path, "w") as fh:
        for pl in lines:
            if pl.marker:
                fh.write(pl.marker + "\n")
            fh.write(pl.line() + "\n")


def remove_duplicate_pairs(input_file: str | Path, output_file: str | Path) -> None:
    """Dedup of (header, path) line *pairs* in solver cycle output —
    exact semantics of reference remove_cycle_dup.py:3-28."""
    with open(input_file) as fh:
        lines = fh.readlines()
    if len(lines) % 2 != 0:
        lines.append("\n")
    seen = set()
    with open(output_file, "w") as out:
        for i in range(0, len(lines), 2):
            pair = (lines[i], lines[i + 1])
            if pair not in seen:
                seen.add(pair)
                out.write(pair[0])
                out.write(pair[1])


@dataclass
class SpadesPath:
    """One record of SPAdes ``contigs.paths``: NODE header + node numbers
    with orientation (e.g. ``1+,2-,7+;``)."""

    node_name: str
    segments: List[List[str]] = field(default_factory=list)  # groups split on ';'


def parse_spades_paths(path: str | Path) -> List[SpadesPath]:
    records: List[SpadesPath] = []
    current: Optional[SpadesPath] = None
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            if line.startswith("NODE"):
                current = SpadesPath(node_name=line)
                records.append(current)
            elif current is not None:
                group = [tok for tok in line.replace(";", "").split(",") if tok]
                current.segments.append(group)
    return records


def spades_path_number_lines(path: str | Path) -> Iterator[List[str]]:
    """Yield the raw number-token lines (``['1+','2-']``) the way
    filter_graph.py:129-147 consumes them (NODE headers skipped,
    ';' removed)."""
    with open(path) as fh:
        for raw in fh:
            line = raw.strip().replace(";", "")
            if not line or line.startswith("NODE"):
                continue
            yield [tok for tok in line.split(",") if tok]
