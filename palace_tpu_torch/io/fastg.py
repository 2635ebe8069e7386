"""FASTG assembly-graph handling.

Two consumers in the pipeline:

* FASTG → FASTA of unique nodes (reference split_fastg.py:55-65):
  names like ``EDGE_1_length_55_cov_2.0'`` (trailing quote ⇒ the
  reverse-complement node, emitted revcomp'd under the base name).
* FASTG ``.fai`` header parsing into the set of *expected* oriented
  contig pairs (reference generate_graph.cpp:119-169), used to split
  junction support into in-graph vs novel counts, and into a node →
  neighbours map (filter_graph.py:118-124).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterator, List, Set, Tuple

from palace_tpu_torch.io.fasta import iter_fasta, reverse_complement, write_fasta

OrientedPair = Tuple[str, str, str, str]  # (ref1, ref2, orient1, orient2)


def fastg_to_node_fasta(fastg_path: str | Path, out_fasta: str | Path) -> int:
    """Write one record per unique node; ``'``-suffixed (reverse) entries
    are reverse-complemented and uppercased (split_fastg.py:59-64,78-95).
    Returns the number of nodes written."""
    seen: Set[str] = set()
    records: List[Tuple[str, str]] = []
    for name, seq in iter_fasta(fastg_path):
        # header is "EDGE_..[:links...];" — keep the first token up to : or ,
        name = re.sub(r"[:,]", " ", name.rstrip(";")).split(" ")[0]
        if name.endswith("'"):
            name = name[:-1]
            seq = reverse_complement(seq.upper()).upper()
        if name in seen:
            continue
        seen.add(name)
        records.append((name, seq))
    write_fasta(out_fasta, records)
    return len(records)


def _split_header(header_field: str) -> Tuple[str, bool, List[Tuple[str, bool]]]:
    """Parse one fastg fai first-column ``A':B,C';`` → (node, reversed, links)."""
    full = header_field.split(";")[0]
    head, _, rest = full.partition(":")
    contig_reversed = head.endswith("'")
    if contig_reversed:
        head = head[:-1]
    links: List[Tuple[str, bool]] = []
    if rest:
        for item in rest.split(","):
            if not item:
                continue
            rev = item.endswith("'")
            links.append((item[:-1] if rev else item, rev))
    return head, contig_reversed, links


def parse_fastg_pairs(fastg_fai: str | Path) -> Set[OrientedPair]:
    """Expected oriented contig pairs from a fastg ``.fai``.

    Mirrors generate_graph.cpp:119-169 exactly: for each link the pair
    ``(node, linked, o1, o2)`` is added together with
    ``(linked, node, flip(o1), flip(o2))`` — note the reference keeps
    the orientations positionally (generate_graph.cpp:160-164), it
    does *not* swap them as a true conjugate would.
    """
    pairs: Set[OrientedPair] = set()
    flip = {"+": "-", "-": "+"}
    with open(fastg_fai) as fh:
        for line in fh:
            first = line.split("\t")[0]
            node, node_rev, links = _split_header(first)
            for linked, linked_rev in links:
                if not node_rev:
                    o1, o2 = "+", ("-" if linked_rev else "+")
                else:
                    o1, o2 = "-", ("+" if linked_rev else "-")
                pairs.add((node, linked, o1, o2))
                pairs.add((linked, node, flip[o1], flip[o2]))
    return pairs


def parse_fastg_neighbours(fastg_fai: str | Path) -> Dict[str, List[str]]:
    """Node → raw neighbour tokens, the loose split filter_graph.py:118-124
    performs (re.split on ``:|,|;``)."""
    out: Dict[str, List[str]] = {}
    with open(fastg_fai) as fh:
        for line in fh:
            first = line.split("\t")[0]
            parts = re.split(r"[:,;]", first)
            out[parts[0]] = [p for p in parts[1:] if p]
    return out
