"""Second-pass (stage 5) filters: which references need a second
matching round, RagTag AGP parsing, main-path fallback, and remain-path
gene/score filtering.

Semantic ports of share/palace/scripts/{generate_second_with_blast,
filter_ragtag, get_main_path, parse_remain}.py — see each function's
docstring for the file:line contract.
"""
from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from palace_tpu_torch.io.paths_io import reverse_flip, split_concatenated_path


# ---------------------------------------------------------------------------
# generate_second_with_blast.py
# ---------------------------------------------------------------------------

def generate_second_with_blast(blast_file: str | Path, output_file: str | Path) -> Dict[str, List[str]]:
    """Refs with per-query cumulative aligned length / qlen ≥ 0.7 →
    ``need_second_match.txt`` lines ``<queries-concatenated>\\t<ref>``
    (generate_second_with_blast.py:4-72; the union-find over similar
    refs there is computed but unused)."""
    query_ref_lengths: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    query_lengths: Dict[str, int] = {}
    with open(blast_file) as fh:
        for line in fh:
            parts = line.strip().split("\t")
            if len(parts) < 14:
                continue
            query_id, ref_id = parts[0], parts[1]
            query_length = int(parts[3])   # qlen (layout B)
            aligned_length = int(parts[5])  # length
            if aligned_length < 100 and aligned_length / query_length < 0.05:
                continue
            query_lengths[query_id] = query_length
            query_ref_lengths[query_id][ref_id] += aligned_length

    ref_queries: Dict[str, List[str]] = defaultdict(list)
    for query_id, ref_lengths in query_ref_lengths.items():
        for ref_id, total in ref_lengths.items():
            if total / query_lengths[query_id] >= 0.7:
                ref_queries[ref_id].append(query_id)

    with open(output_file, "w") as out:
        for ref, queries in ref_queries.items():
            out.write(f"{''.join(queries)}\t{ref}\n")
    return dict(ref_queries)


# ---------------------------------------------------------------------------
# filter_ragtag.py
# ---------------------------------------------------------------------------

def _reverse_and_flip(concatenated: str) -> str:
    return "".join(reverse_flip(split_concatenated_path(concatenated)))


def filter_ragtag(agp_path: str | Path, output_path: str | Path, is_remain: bool) -> None:
    """RagTag ``ragtag.scaffold.agp`` → ordered contig strings.

    Non-remain mode (filter_ragtag.py:84-96): concatenate the 6th
    column of ``*_RagTag`` W lines (reverse+flip when col 9 is '-'),
    single output line.  Remain mode (:62-83): group by scaffold,
    newline between scaffolds, plain W lines pass through with their
    own newline."""
    if is_remain:
        preref = ""
        with open(agp_path) as infile, open(output_path, "w") as outfile:
            for line in infile:
                if line.startswith("#"):
                    continue
                cols = line.strip().split()
                if len(cols) >= 9 and cols[0].endswith("_RagTag") and cols[4] == "W":
                    if preref != cols[0] and preref != "":
                        outfile.write("\n")
                    if cols[8] == "-":
                        cols[5] = _reverse_and_flip(cols[5])
                    outfile.write(cols[5])
                    preref = cols[0]
                elif len(cols) > 4 and cols[4] == "W":
                    outfile.write(cols[5])
                    outfile.write("\n")
    else:
        with open(agp_path) as infile, open(output_path, "w") as outfile:
            for line in infile:
                cols = line.strip().split()
                if len(cols) >= 9 and cols[0].endswith("_RagTag") and cols[4] == "W":
                    if cols[8] == "-":
                        cols[5] = _reverse_and_flip(cols[5])
                    outfile.write(cols[5])
            outfile.write("\n")


# ---------------------------------------------------------------------------
# get_main_path.py
# ---------------------------------------------------------------------------

def get_main_path(graph_path: str | Path, result_path: str | Path,
                  output_path: str | Path) -> None:
    """Fallback when RagTag produced no AGP (palace:773-776): keep
    result lines ≥90 % composed of ref-ordered SEGs and >2000 bp, plus
    the line with the most such segments (get_main_path.py:4-38)."""
    relevant: List[str] = []
    with open(graph_path) as fh:
        for line in fh:
            if line.startswith("SEG"):
                parts = line.split()
                if float(parts[-1]) > -2:
                    relevant.append(parts[1])

    def path_len(items: Sequence[str]) -> int:
        total = 0
        for item in items:
            if item.startswith("EDGE"):
                total += int(item.split("_")[3])
        return total

    max_count = 0
    most_frequent: Optional[str] = None
    result: List[str] = []
    with open(result_path) as fh:
        for line in fh:
            items = [i for i in re.split(r"\t+", line.strip()) if i]
            if not items:
                continue
            total_len = path_len(items)
            in_items = [i for i in items if i[:-1] in relevant]
            count = len(in_items)
            in_len = path_len(in_items)
            if total_len > 0 and in_len / total_len >= 0.9 and in_len > 2000:
                result.append(line.strip())
            if count > max_count:
                max_count = count
                most_frequent = line.strip()
    result.append(most_frequent)
    with open(output_path, "w") as out:
        for line in result:
            if line is not None:
                out.write(line + "\n")


# ---------------------------------------------------------------------------
# parse_remain.py
# ---------------------------------------------------------------------------

def _check_gene(length: int, gene_count: int, min_gene_density: float = 1.0) -> bool:
    """parse_remain.py:4-20."""
    if gene_count >= 40:
        return True
    required = min_gene_density * (length / 3000)
    return gene_count >= required - 1


def _edge_len(edge: str) -> int:
    return int(edge.split("_")[3])


def _parse_remain_graph(graph_path: str | Path, gene_res: Dict[str, int]):
    """parse_remain.py:27-47: SEG columns 4 (gene flag) and 5 (score)."""
    in_gene: List[str] = []
    in_score: List[str] = []
    both: List[str] = []
    with open(graph_path) as fh:
        for line in fh:
            cols = line.split()
            if cols and cols[0] == "SEG":
                try:
                    fourth = float(cols[4])
                    fifth = float(cols[5])
                except (IndexError, ValueError):
                    continue
                if cols[1] in gene_res and fifth > 0.7:
                    both.append(cols[1])
                elif fourth > 0.9:
                    in_gene.append(cols[1])
                elif fifth > 0.7:
                    in_score.append(cols[1])
    return in_gene, in_score, both


def _items_in_keeped(items, in_gene, in_score, in_both, strict: Dict[str, int]):
    """parse_remain.py:74-104."""
    gene_score: List[Tuple[str, int]] = []
    total_gene = 0
    gene_len = score_len = both_len = 0.0
    for tmp_item in items:
        item = (
            tmp_item.replace("+", "").replace("-", "").replace(" ", "").replace("\t", "")
        )
        if item in strict:
            total_gene += int(strict[item])
        if item in in_both:
            gene_score.append((tmp_item, 2))
            both_len += _edge_len(item)
        elif item in strict:
            if _check_gene(_edge_len(item), strict[item]):
                gene_score.append((tmp_item, 1))
                gene_len += _edge_len(item)
            else:
                gene_score.append((tmp_item, -1))
        elif item in in_score:
            gene_score.append((tmp_item, 0))
            score_len += _edge_len(item)
        else:
            gene_score.append((tmp_item, -1))
    return gene_len, score_len, both_len, gene_score, total_gene


def _split_list(arr: List[Tuple[str, int]]) -> List[List[str]]:
    """parse_remain.py:106-170: split at ≥1000 bp unsupported blocks."""
    sublists: List[List[Tuple[str, int]]] = []
    current: List[Tuple[str, int]] = []
    i = 0
    n = len(arr)
    while i < n:
        key, val = arr[i]
        if val != -1:
            current.append((key, val))
            i += 1
        else:
            j = i
            block_len = 0
            while j < n and arr[j][1] == -1:
                block_len += _edge_len(
                    arr[j][0].replace("+", "").replace("-", "").replace("\t", "")
                )
                j += 1
            if block_len >= 1000:
                if current:
                    sublists.append(current)
                current = []
            else:
                while i < j:
                    current.append(arr[i])
                    i += 1
            i = j
    if current:
        sublists.append(current)
    return [[key for key, _ in sub] for sub in sublists]


def parse_remain(
    graph_path: str | Path,
    remain_path: str | Path,
    output_path: str | Path,
    threshold: float,
    min_len: float,
    before_cut_path: str | Path,
    gene_file: str | Path,
) -> None:
    """Keep remain-paths with enough gene/score-supported length
    (parse_remain.py:172-222): threshold rule
    ``both/len ≥ t/2 ∧ (gene+score+both)/len ≥ t``, else split at
    unsupported blocks and keep ≥95 %-supported sublists with ≥8
    genes."""
    gene_res: Dict[str, int] = {}
    with open(gene_file) as fh:
        for line in fh:
            if not line.strip():
                continue
            name, count = line.split("\t")[:2]
            gene_res[name] = int(count)

    in_gene, in_score, in_both = _parse_remain_graph(graph_path, gene_res)

    results: List[List[str]] = []
    pattern = re.compile(r"\t+")
    with open(remain_path) as fh:
        for line in fh:
            if not line.strip() or "iter" in line:
                continue
            line = line.replace("+", "+\t").replace("-", "-\t")
            results.append([i for i in pattern.split(line.strip()) if i != ""])

    def path_len(items: Sequence[str]) -> float:
        total = 0
        for p in items:
            if len(p) == 0 or p in ("+", "-", " "):
                continue
            total += int(p.split("_")[3])
        return float(total)

    final: List[List[str]] = []
    for items in results:
        gene_len, score_len, both_len, gene_score, total_gene = _items_in_keeped(
            items, in_gene, in_score, in_both, gene_res
        )
        len2 = path_len(items)
        if len2 < min_len:
            continue
        if (
            both_len / len2 >= threshold / 2
            and (gene_len + score_len + both_len) / len2 >= threshold
        ) or (gene_len == len2 and len2 >= min_len):
            final.append(items)
        else:
            for sublst in _split_list(gene_score):
                g, s, b, _, tg = _items_in_keeped(sublst, in_gene, in_score, in_both, gene_res)
                sub_len = path_len(sublst)
                if sub_len <= 0:
                    continue
                if (
                    (g / sub_len > 0.95 or (g + b) / sub_len > 0.95 or b / sub_len > 0.95)
                    and sub_len >= min_len
                    and tg >= 8
                ):
                    final.append(sublst)

    with open(output_path, "w") as out:
        for items in final:
            out.write("\t".join(items) + "\n")
    with open(before_cut_path, "w") as out:
        for items in final:
            out.write("\t".join(items) + ":" + "\t".join(items) + "\n")
