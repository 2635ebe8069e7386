"""Per-reference subgraph construction for the second matching pass.

Semantic port of share/palace/scripts/create_sub_graph.py: split the
filtered graph into ``{prefix}_ref<REF>ref.second`` subgraphs (one per
reference that needs a second match) plus a ``refremain`` subgraph of
leftovers (:31-93); per-subgraph depth/copy recomputation from the
depth store (:182-259); similar-reference dedup keeping the
max-percent ref (:282-325); contig order along each reference derived
from BLAST with circular-wrap handling (:327-375).

The reference queried a tabix-indexed samtools-depth file through
pysam; we query our own DepthStore (palace_tpu_torch.graph.depth).
"""
from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from palace_tpu_torch.graph.depth import DepthStore

_EDGE_PATTERN = re.compile(r"(EDGE_[\w_]+_cov_[\d.]+)([+-])")


def parse_ref_percent(path: str | Path) -> Dict[str, float]:
    out: Dict[str, float] = {}
    with open(path) as fh:
        for line in fh:
            arr = line.split("\t")
            if len(arr) >= 2:
                out[arr[0]] = float(arr[-1])
    return out


def parse_graph_file_raw(path: str | Path):
    """SEG name → remaining fields; JUNC 4-tuple → full fields
    (create_sub_graph.py:262-281)."""
    segs: Dict[str, List[str]] = {}
    juncs: Dict[Tuple[str, str, str, str], List[str]] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "SEG":
                segs[parts[1]] = parts[2:]
            elif parts[0] == "JUNC":
                juncs[(parts[1], parts[2], parts[3], parts[4])] = parts
    return segs, juncs


def parse_match_file(path: str | Path, ref_percent: Dict[str, float]):
    """need_second_match.txt → (graph_dict, similar_refs)
    (create_sub_graph.py:282-325)."""
    similar_refs: Dict[str, List[str]] = {}
    graph_dict: Dict[str, List[Tuple[str, str]]] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts:
                continue
            seq_id = parts[-1]
            similar_refs.setdefault(parts[0], []).append(parts[-1])
            edge_string = " ".join(parts[:-1])
            edges = [(m.group(1), m.group(2)) for m in _EDGE_PATTERN.finditer(edge_string)]
            graph_dict.setdefault(seq_id, []).extend(edges)
    for key, refs in similar_refs.items():
        max_percent = 0.0
        max_ref = ""
        for ref in refs[:]:
            if max_percent < ref_percent.get(ref, 0.0):
                max_percent = ref_percent.get(ref, 0.0)
                max_ref = ref
            else:
                if ref_percent.get(ref, 0.0) < 0.85:
                    similar_refs[key].remove(ref)
        if len(similar_refs[key]) == 0:
            similar_refs[key].append(max_ref)
    return graph_dict, similar_refs


def parse_blast_ref_order(blast_file: str | Path):
    """assembly blast (layout A with qlen/slen cols 13/14) → per-ref
    ordered query list with circular wrap handling
    (create_sub_graph.py:327-375)."""
    reference_dict: Dict[str, List[Tuple[int, int, str, float]]] = defaultdict(list)
    with open(blast_file) as fh:
        for line in fh:
            parts = line.strip().split("\t")
            if len(parts) < 12:
                continue
            query_id = parts[0]
            subject_id = parts[1]
            s_start = min(int(parts[8]), int(parts[9]))
            s_end = max(int(parts[8]), int(parts[9]))
            sublen = int(parts[13]) if len(parts) > 13 else 0
            querylen = int(parts[12]) if len(parts) > 12 else 1
            current_len = s_end - s_start
            found = False
            for idx, item in enumerate(reference_dict[subject_id]):
                if query_id == item[2]:
                    if abs(s_start - s_end) > abs(item[0] - item[1]):
                        reference_dict[subject_id][idx] = (
                            s_start, s_end, query_id, item[3] + current_len / querylen,
                        )
                    elif s_start - 1 < 10:
                        if sublen - item[1] < 50:  # circular
                            if s_end == int(parts[9]):
                                reference_dict[subject_id][idx] = (
                                    0, s_end, query_id, item[3] + current_len / querylen,
                                )
                            else:
                                reference_dict[subject_id][idx] = (
                                    -1, s_end, query_id, item[3] + current_len / querylen,
                                )
                    else:
                        reference_dict[subject_id][idx] = (
                            item[0], item[1], item[2], item[3] + current_len / querylen,
                        )
                    found = True
            if not found:
                reference_dict[subject_id].append(
                    (s_start, s_end, query_id, current_len / querylen)
                )
    updated = {
        key: [(-2, b, c, d) if d < 0.5 else (a, b, c, d) for (a, b, c, d) in value]
        for key, value in reference_dict.items()
    }
    for subject_id in updated:
        updated[subject_id].sort()
    return updated


def update_segs_with_depth(
    segs: Sequence[Tuple[str, str]],
    depth_store: DepthStore,
    seg_gene_scores: Dict[str, List[str]],
) -> List[List[str]]:
    """create_sub_graph.py:182-259: recompute per-subgraph depth and
    copy numbers; contigs absent from the depth store fall back to
    name-derived depth/length."""
    total_depths = 0.0
    total_lens = 0
    seg_depths: Dict[str, Tuple[float, int]] = {}
    for item in segs:
        contig = item[0]
        avg, n = depth_store.average_depth(contig)
        if n == 0:
            parts = contig.split("_")
            try:
                avg = float(parts[-1])
                n = int(parts[-3])
            except (ValueError, IndexError):
                continue
        seg_depths[contig] = (avg, n)
        total_depths += avg * n
        total_lens += n
    if total_lens == 0:
        return []
    total_avg = total_depths / total_lens

    final_segs: List[List[str]] = []
    for item in segs:
        contig = item[0]
        if contig in seg_depths:
            avg, _ = seg_depths[contig]
            copy_num = round(avg / total_avg)
            if copy_num == 0:
                copy_num = 1
            gs = seg_gene_scores.get(contig)
            final_segs.append(
                [
                    "SEG",
                    contig,
                    str(avg),
                    str(copy_num),
                    gs[2] if gs and len(gs) > 2 else "0",
                    gs[3] if gs and len(gs) > 3 else "0",
                    "1",
                ]
            )
    return final_segs


def _juncs_for_segs(segs_nested, full_juncs) -> List[str]:
    flat = {item for row in segs_nested for item in row}
    kept = {
        " ".join(parts)
        for key, parts in full_juncs.items()
        if key[0] in flat and key[2] in flat
    }
    return sorted(kept)


def _find_order(orders: List[Tuple[int, int, str, float]], name: str) -> int:
    for entry in orders:
        if entry[2] == name:
            return entry[0]
    return -2


def create_sub_graphs(
    graph_file: str | Path,
    prefix: str | Path,
    match_file: str | Path,
    depth_store: DepthStore,
    assembly_blast: str | Path,
    similar_ref_out: str | Path,
    ref_percent_file: str | Path,
) -> List[Path]:
    """Write all ``*.second`` subgraph files; returns their paths."""
    ref_percent = parse_ref_percent(ref_percent_file)
    full_segs, full_juncs = parse_graph_file_raw(graph_file)
    graph_dict, similar_refs = parse_match_file(match_file, ref_percent)
    ref_order = parse_blast_ref_order(assembly_blast)

    with open(similar_ref_out, "w") as fh:
        for key in sorted(similar_refs):
            fh.write(",".join(similar_refs[key]) + "\n")
    similar_list = [item for key in sorted(similar_refs) for item in similar_refs[key]]

    written: List[Path] = []
    added_segs: List[List[str]] = []
    orders: List[Tuple[int, int, str, float]] = []
    for ref_key in sorted(graph_dict):
        if ref_key not in similar_list:
            continue
        ref_segs = graph_dict[ref_key]
        if ref_key in ref_order:
            orders = ref_order[ref_key]
        updated = update_segs_with_depth(ref_segs, depth_store, full_segs)
        if not updated:
            continue
        out_path = Path(f"{prefix}_ref{ref_key}ref.second")
        with open(out_path, "w") as fh:
            juncs = _juncs_for_segs(ref_segs, full_juncs)
            for seg in updated:
                added_segs.append(seg)
                order = _find_order(orders, seg[1])
                if order == -2:
                    seg[-1] = "-1"
                fh.write(" ".join(seg) + " " + str(order) + "\n")
            for junc in juncs:
                fh.write(junc + "\n")
        written.append(out_path)

    # remain subgraph (:83-93)
    removed_names = {seg[1] for seg in added_segs}
    pure_segs = [[name] for name in full_segs if name not in removed_names]
    remain_lines = [
        f"SEG {name} {' '.join(full_segs[name])}"
        for name in full_segs
        if name not in removed_names
    ]
    remain_path = Path(f"{prefix}_refremainref.second")
    with open(remain_path, "w") as fh:
        juncs = _juncs_for_segs(pure_segs, full_juncs)
        for seg_line in remain_lines:
            fh.write(seg_line + " -1\n")
        for junc in juncs:
            fh.write(junc + "\n")
    written.append(remain_path)
    return written
