"""Final FASTA assembly with fuzzy circularity re-detection.

Semantic port of share/palace/scripts/make_final_fa.py: oriented-node
adjacency including conjugate edges (:9-36); cycles re-detected by
trying every retention interval [i, j] whose trimmed flanks total
≤ trim_threshold and whose unique-contig length ≥ min_cycle_length,
preferring the least-trimmed (:45-91); records written as
``>{prefix}_phage_<n>_{cycle|linear}`` with 50-N joints, cycles first
(:93-135).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

from palace_tpu_torch.io.fasta import FastaStore
from palace_tpu_torch.io.graph_io import parse_graph_file
from palace_tpu_torch.utils.logging import get_logger

logger = get_logger("palace")


def _length_from_name(node_name: str) -> float:
    m = re.search(r"length_(\d+)", node_name)
    return int(m.group(1)) if m else float("inf")


def is_circular_path_fuzzy(
    path: List[str],
    adjacency: Dict[str, set],
    trim_threshold: int,
    min_cycle_length: int,
) -> Tuple[bool, List[str]]:
    """make_final_fa.py:45-91."""
    if not path:
        return False, []
    lengths = [_length_from_name(node) for node in path]
    valid: List[Tuple[float, List[str]]] = []
    for i in range(len(path)):
        for j in range(i, len(path)):
            trimmed = sum(lengths[:i]) + sum(lengths[j + 1 :])
            if trimmed > trim_threshold:
                continue
            first_node = path[i]
            last_node = path[j]
            if last_node in adjacency and first_node in adjacency[last_node]:
                subpath = path[i : j + 1]
                unique = {node.rstrip("+-") for node in subpath}
                physical = sum(_length_from_name(e) for e in unique)
                if physical >= min_cycle_length:
                    valid.append((trimmed, subpath))
    if valid:
        valid.sort(key=lambda x: x[0])
        return True, valid[0][1]
    return False, []


def make_final_fa(
    path_file: str | Path,
    graph_file: str | Path,
    edge_fasta: str | Path,
    out_fasta: str | Path,
    prefix: str,
    trim_threshold: int = 300,
    min_cycle_length: int = 10000,
) -> Tuple[int, int]:
    """Returns (n_cycles, n_linear)."""
    adjacency = parse_graph_file(graph_file).adjacency_with_conjugates()
    store = FastaStore(edge_fasta)

    cycle_paths: List[List[str]] = []
    linear_paths: List[List[str]] = []
    with open(path_file) as fh:
        for line in fh:
            line = line.strip()
            if not line or "all" in line:
                continue
            path = [t for t in re.split(r"\s+", line) if t]
            circ, trimmed = is_circular_path_fuzzy(
                path, adjacency, trim_threshold, min_cycle_length
            )
            if circ:
                cycle_paths.append(trimmed)
            else:
                linear_paths.append(path)

    n_seq = "N" * 50
    count = 0
    with open(out_fasta, "w") as out:
        def write_paths(paths: List[List[str]], tag: str) -> None:
            nonlocal count
            for path in paths:
                seq = ""
                for t in path:
                    if t == "":
                        continue
                    t = t.replace("ref", "")
                    node_name = t[:-1]
                    if node_name not in store:
                        logger.warning("Node '%s' not found in %s", node_name, edge_fasta)
                        continue
                    part = store.fetch_oriented(t)
                    seq = part if seq == "" else seq + n_seq + part
                if seq:
                    count += 1
                    out.write(f">{prefix}_phage_{count}_{tag}\n{seq}\n")

        write_paths(cycle_paths, "cycle")
        write_paths(linear_paths, "linear")
    store.close()
    return len(cycle_paths), len(linear_paths)
