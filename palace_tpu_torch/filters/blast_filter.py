"""Per-reference filter of scaffolded paths (second pass).

Semantic port of share/palace/scripts/filter_by_blast.py: cumulative
blast coverage per path (:227-248), uncovered-reference fraction ≤0.4
(:283-296), merge of length-similar paths keeping the longest
(:321-357), cutting of overhanging end contigs beyond the reference
span (:39-135, strand-resolved via :8-24); writes ``second_match``
pairs and the ``_all_result_before_cut.txt`` map ``cut:original``
(:377-387).  The reference prints the cut paths to stdout (captured to
``*_all_result.txt`` at palace:804); here they're returned and written
by the caller.

Reference quirks preserved: group-change gene/score checks probe the
*current* line's query (:234), EOF adds the last query (:248), the
single-ref filter is substring containment (:230), and ``sk < fk``
string-orders the pairwise merge (:328).

Intentional divergences D1-D3 (see PARITY.md "Intentional
divergences"): the EOF flush uses the last *accepted* query rather
than the last raw line's, short lines are skipped instead of raising
IndexError, and the reference-coverage fill clamps to the reference
length instead of raising.
"""
from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Set

from palace_tpu_torch.io.paths_io import split_concatenated_path


def _get_seg_len(seg: str, fai_len: Dict[str, int]) -> int:
    seg_p = seg.replace("+", "").replace("-", "").replace("\t", "")
    return fai_len[seg_p]


def _get_line_len(line: str, fai_len: Dict[str, int]) -> int:
    total = 0
    for v in re.split(r"\+|-|\t", line):
        if v != "":
            total += _get_seg_len(v, fai_len)
    return total


def _check_gene_or_score(line: str, genes: Dict[str, str], scores: Dict[str, str]) -> bool:
    for v in re.split(r"\+|-|\t", line):
        if v != "" and (v in genes or v in scores):
            return True
    return False


def determine_strand_for_pair(blast_path: str | Path, query: str, reference: str) -> str:
    """filter_by_blast.py:8-24."""
    strand_lengths: Dict[str, int] = defaultdict(int)
    with open(blast_path) as fh:
        for line in fh:
            t = line.split()
            if len(t) < 12:
                continue
            if t[0] == query and t[1] == reference:
                qstart, qend = int(t[8]), int(t[9])
                sstart, send = int(t[10]), int(t[11])
                aln = abs(qend - qstart) + 1
                strand_lengths["+" if sstart < send else "-"] += aln
    return "+" if strand_lengths["+"] > strand_lengths["-"] else "-"


def _convert_minus(query_name: str, cut_pos: int, fai_len: Dict[str, int]):
    """filter_by_blast.py:26-37: reverse-flip the concatenated query and
    mirror the cut position."""
    segs = split_concatenated_path(query_name)
    total = _get_line_len(query_name, fai_len)
    result = ""
    for item in reversed(segs):
        result += item[:-1] + ("+" if item[-1] == "-" else "-")
    return result, total - cut_pos


def cut_end_contig(blast_path: str | Path, blast_segs: Set[str],
                   fai_len: Dict[str, int], ref: str) -> Dict[str, List[str]]:
    """filter_by_blast.py:39-135."""
    info = defaultdict(
        lambda: {
            "min_start": float("inf"), "min_start_query": "",
            "max_end": float("-inf"), "max_end_query": "",
            "min_start_query_start": 0, "min_start_query_end": 0,
            "max_end_query_start": 0, "max_end_query_end": 0,
        }
    )
    with open(blast_path) as fh:
        for line in fh:
            parts = line.strip().split("\t")
            if len(parts) < 12:
                continue
            query = parts[0]
            if query not in blast_segs:
                continue
            reference = parts[1]
            if reference not in ref:
                continue
            sstart = min(int(parts[10]), int(parts[11]))
            send = max(int(parts[11]), int(parts[10]))
            qstart = min(int(parts[8]), int(parts[9]))
            qend = max(int(parts[9]), int(parts[8]))
            d = info[reference]
            if sstart < d["min_start"] or d["min_start_query"] == query:
                if d["min_start_query"] != query:
                    d["min_start"] = sstart
                    d["min_start_query"] = query
                    d["min_start_query_start"] = qstart
                    d["min_start_query_end"] = qend
                else:
                    d["min_start"] = sstart
                    d["min_start_query_start"] = min(d["min_start_query_start"], qstart)
                    d["min_start_query_end"] = max(d["min_start_query_end"], qend)
            if send > d["max_end"] or d["max_end_query"] == query:
                if d["max_end_query"] != query:
                    d["max_end"] = send
                    d["max_end_query"] = query
                    d["max_end_query_start"] = qstart
                    d["max_end_query_end"] = qend
                else:
                    d["max_end"] = send
                    d["max_end_query_end"] = max(d["max_end_query_end"], qend)
                    d["max_end_query_start"] = min(d["max_end_query_start"], qstart)

    out: Dict[str, List[str]] = {}
    for reference, d in info.items():
        strand = determine_strand_for_pair(blast_path, d["min_start_query"], reference)
        original_min = d["min_start_query"]
        if strand == "-":
            d["min_start_query"], d["min_start_query_start"] = _convert_minus(
                d["min_start_query"], d["min_start_query_end"], fai_len
            )
        start_query = split_concatenated_path(d["min_start_query"])
        start_start = d["min_start_query_start"]

        strand = determine_strand_for_pair(blast_path, d["max_end_query"], reference)
        original_max = d["max_end_query"]
        if strand == "-":
            d["max_end_query"], d["max_end_query_end"] = _convert_minus(
                d["max_end_query"], d["max_end_query_start"], fai_len
            )
        end_query = split_concatenated_path(d["max_end_query"])
        end_end = d["max_end_query_end"]

        start_filtered = []
        cum = 0
        for seg in start_query:
            seg_len = _get_seg_len(seg, fai_len)
            current_pos = cum + seg_len
            fraction = (current_pos - start_start) / seg_len
            if cum + seg_len > start_start and fraction > 0.5:
                start_filtered.append(seg)
            cum += seg_len

        end_filtered = []
        cum = 0
        for seg in end_query:
            seg_len = _get_seg_len(seg, fai_len)
            cum += seg_len
            fraction = (cum - end_end) / seg_len
            if cum < end_end or fraction < 0.5:
                end_filtered.append(seg)

        if d["min_start_query"] == d["max_end_query"]:
            intersection = [v for v in end_filtered if v in start_filtered]
            out[d["min_start_query"]] = intersection
            out[original_min] = intersection
        else:
            out[d["min_start_query"]] = start_filtered
            out[original_min] = start_filtered
            out[d["max_end_query"]] = end_filtered
            out[original_max] = end_filtered
    return out


def filter_by_blast(
    input_blast: str | Path,
    cycle_txt: str | Path,
    fasta_fai: str | Path,
    second_match_out: str | Path,
    run_model: str,
    blast_ratio: float,
    blast_len_threshold: int,
    single_ref: str = "",
    gene_hit: str | Path = None,
    score: str | Path = None,
    before_cut: str | Path = None,
) -> List[str]:
    """Returns the lines the reference prints to stdout (the cut
    paths, re-tab-delimited) — palace captures them to
    ``*_all_result.txt``."""
    genes: Dict[str, str] = {}
    if gene_hit:
        with open(gene_hit) as fh:
            for line in fh:
                if line.strip():
                    genes[line.strip().split("\t")[0]] = "1"
    scores: Dict[str, str] = {}
    if score:
        with open(score) as fh:
            for line in fh:
                parts = line.strip().split("\t")
                if len(parts) >= 2:
                    scores[parts[0]] = parts[1]

    ref_list: Dict[str, int] = {}
    with open(input_blast) as fh:
        for line in fh:
            t = line.strip("\n").split()
            if len(t) >= 5 and t[1] not in ref_list:
                ref_list[t[1]] = int(t[4])

    fai_len: Dict[str, int] = {}
    with open(fasta_fai) as fh:
        for line in fh:
            fields = line.strip().split("\t")
            if len(fields) >= 2:
                fai_len[fields[0]] = int(fields[1])

    res: Dict[str, None] = {}
    if run_model == "1":
        with open(cycle_txt) as fh:
            for line in fh:
                line_len = 0
                for v in re.split(r"[+-]", line.strip()):
                    if v != "" or v != " ":
                        line_len += _get_line_len(v, fai_len) if v else 0
                if line_len >= 10000:
                    liner = (
                        line.replace("cycle", "").replace("score", "")
                        .replace("self", "").replace("gene", "")
                    )
                    res.setdefault(liner.strip("\n"))

    blast_segs: Set[str] = set()
    prev_seg = ""
    prev_ref = ""
    prev_len = 0
    last_query = ""
    with open(input_blast) as fh:
        for line in fh:
            t = line.strip().split("\t")
            if len(t) < 12:
                continue
            if single_ref != "" and t[1] not in single_ref:
                continue
            last_query = t[0]
            if (prev_seg != t[0] and prev_seg != "") or (prev_ref != t[1] and prev_ref != ""):
                elen = _get_line_len(prev_seg, fai_len)
                if (
                    float(prev_len) / float(elen) > blast_ratio
                    or prev_len > blast_len_threshold
                    or _check_gene_or_score(t[0], genes, scores)
                ):
                    blast_segs.add(prev_seg)
                prev_seg = t[0]
                prev_ref = t[1]
                prev_len = int(t[5])
            else:
                if float(t[2]) > 75:
                    prev_len += int(t[5])
                prev_seg = t[0]
                prev_ref = t[1]
    elen = _get_line_len(prev_seg, fai_len) if prev_seg else 0
    if elen != 0:
        if float(prev_len) / float(elen) > blast_ratio or prev_len > blast_len_threshold:
            blast_segs.add(last_query)

    ref_start_end_segs = cut_end_contig(input_blast, blast_segs, fai_len, single_ref)

    ref_contig: Dict[str, List[List]] = {}
    ref_contig_l: Dict[str, int] = {}
    with open(input_blast) as fh:
        for fline in fh:
            line = fline.strip("\n").split("\t")
            if len(line) < 12:
                continue
            if single_ref != "" and line[1] not in single_ref:
                continue
            if line[0] not in blast_segs:
                continue
            if line[1] not in ref_contig:
                ref_contig[line[1]] = []
                ref_contig_l[line[1]] = 0
            start = min(int(line[10]), int(line[11]))
            stop = max(int(line[10]), int(line[11]))
            ref_contig[line[1]].append([start, stop, line[0]])
            ref_contig_l[line[1]] += stop - start

    title_contig: Dict[str, List[str]] = {}
    for key, value in ref_contig.items():
        title_contig[key] = []
        ref_contig[key] = sorted(value, key=lambda v: v[1])
        for v in ref_contig[key]:
            if v[2] not in title_contig[key]:
                title_contig[key].append(v[2])

    contig_ref: Dict[str, List[str]] = {}
    for ref in ref_list:
        if ref not in ref_contig:
            continue
        ref_length = ref_list[ref]
        cover = [0] * ref_length
        for v in ref_contig[ref]:
            for i in range(v[0], min(v[1], ref_length)):
                cover[i] = 1
        un_covered = cover.count(0)
        if un_covered / ref_length > 0.4:
            continue
        pt = ""
        for i in title_contig[ref]:
            pt = pt + "\t" + i
        contig_ref.setdefault(pt, []).append(ref)

    k_lens: Dict[str, List[int]] = {}
    for k in contig_ref:
        k_lens[k] = []
        for i in re.split(r"[+-]", k.strip()):
            if i == "":
                continue
            k_lens[k].append(_get_line_len(i, fai_len))

    result: List[str] = []
    skip: List[str] = []
    similar_array: List[List[str]] = []
    for fk in k_lens:
        if fk in skip:
            continue
        a = k_lens[fk]
        oflag = True
        for sk in k_lens:
            b = k_lens[sk]
            if fk == sk or sk < fk or sk in skip:
                continue
            tmp = [j for j in a if j in b]
            if sum(a) and (sum(tmp) / sum(a) > 0.8 or (sum(b) and sum(tmp) / sum(b) > 0.8)):
                oflag = False
                flag = True
                for suba in similar_array:
                    if fk in suba:
                        suba.append(sk)
                        flag = False
                        break
                    elif sk in suba:
                        suba.append(fk)
                        flag = False
                        break
                if flag:
                    similar_array.append([fk, sk])
        if oflag:
            similar_array.append([fk])

    for s in similar_array:
        max_v = 0
        max_it = ""
        for it in s:
            if sum(k_lens[it]) > max_v:
                max_v = sum(k_lens[it])
                max_it = it
        result.append(max_it)

    visited_path: List[str] = []
    with open(second_match_out, "w") as sm:
        for k in result:
            for ref in contig_ref.get(k, []):
                k2 = k
                if k2 not in visited_path:
                    path = k2
                    for tag in ("gene_score", "score", "gene", "self", "self-gene", "ref"):
                        path = path.replace(tag, "")
                    sm.write(path.replace("\t", "") + "\t" + ref + "\n")
                    res.setdefault(path.strip("\n"))
                visited_path.append(k2)

    printed: List[str] = []
    if before_cut:
        with open(before_cut, "w") as bc:
            for item in res:
                new_item = ""
                for seg in item.strip().split("\t"):
                    if seg in ref_start_end_segs:
                        seg = "".join(ref_start_end_segs[seg])
                    new_item += seg
                new_item_str = (
                    new_item.replace("\t", "").replace("+", "+\t").replace("-", "-\t")
                )
                printed.append(new_item_str.strip())
                bc.write(
                    new_item_str + ":" +
                    item.replace("\t", "").replace("+", "+\t").replace("-", "-\t") + "\n"
                )
    return printed
