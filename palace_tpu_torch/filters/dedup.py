"""Final dedup / copy-number correction.

Semantic port of share/palace/scripts/corrected_dup.py (the live code
path of its ``__main__``): canonical cycle rotation (:250-261),
consecutive-repeat detection (:269-286), repeat copy-count from
depth-derived copy numbers (:211-248), repeat expansion/trim
(:348-367), cross-path similarity dedup on length multisets ≥0.9
(:412-423), before-cut path restoration (:472-526), coverage-quota
dedup using cov values embedded in contig names (:71-120), and the
min-length gate (:636-639).

Depth queries go through our DepthStore instead of shelling out to
``samtools depth -r`` (:167-178); quirks (e.g. the -1 sentinel from a
missed sublist search flowing into slicing, :322-355) are preserved.
"""
from __future__ import annotations

import copy as _copy
import re
from collections import Counter
from itertools import chain
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from palace_tpu_torch.graph.depth import DepthStore

_NODE_RE = re.compile(r"(EDGE_(\d+)_length_(\d+)_cov_([\d\.]+)([+-]))")


# ---------------------------------------------------------------------------
# smart quota dedup (:33-131)
# ---------------------------------------------------------------------------

def _parse_line_nodes(line: str) -> List[dict]:
    nodes = []
    for m in _NODE_RE.findall(line):
        try:
            nodes.append(
                {"full": m[0], "id": m[1], "len": int(m[2]), "cov": float(m[3])}
            )
        except ValueError:
            continue
    return nodes


def _calculate_baseline(nodes: List[dict]) -> float:
    if not nodes:
        return 1.0
    id_counts = Counter(n["id"] for n in nodes)
    single = [n["cov"] for n in nodes if id_counts[n["id"]] == 1]
    if single:
        return float(np.median(single))
    return float(np.median([n["cov"] for n in nodes]))


def smart_quota_dedup(line: str) -> str:
    line = line.strip()
    if not line:
        return ""
    nodes = _parse_line_nodes(line)
    if not nodes:
        return line
    baseline = _calculate_baseline(nodes) or 1.0

    cov_by_id: Dict[str, float] = {}
    for n in nodes:
        cov_by_id[n["id"]] = max(cov_by_id.get(n["id"], 0.0), n["cov"])

    budget: Dict[str, int] = {}
    for uid, max_cov in cov_by_id.items():
        if max_cov > 2.5 * baseline:  # hub
            budget[uid] = 999999
        else:
            budget[uid] = max(1, int(round(max_cov / baseline)))

    temp = []
    for node in nodes:
        if budget[node["id"]] > 0:
            temp.append(node)
            budget[node["id"]] -= 1
    if not temp:
        return ""
    out: List[str] = []
    last = None
    for node in temp:
        if node["full"] != last:
            out.append(node["full"])
            last = node["full"]
    return "\t".join(out)


def apply_smart_quota_dedup(path_list: List[str]) -> List[str]:
    deduped = smart_quota_dedup("\t".join(path_list))
    return deduped.split("\t") if deduped else []


# ---------------------------------------------------------------------------
# cycle utilities (:138-286, :322-367)
# ---------------------------------------------------------------------------

def get_path_len_names(path: Sequence[str]) -> int:
    total = 0
    for item in path:
        if item.startswith("EDGE"):
            total += int(item.split("_")[3])
    return total


def _split_list_on_element(lst: List[str], A: str) -> "Counter[Tuple[str, ...]]":
    indices = [i for i, elem in enumerate(lst) if A in elem]
    indices.append(len(lst))
    sublists = [lst[indices[i] : indices[i + 1]] for i in range(len(indices) - 1)]
    return Counter(tuple(s) for s in sublists)


def _merge_repeat(lst: List[str]) -> List[str]:
    names = [item.replace("-", "").replace("+", "") for item in lst]
    counts = Counter(names)
    most = max(counts, key=counts.get)
    idx = names.index(most)
    rotated = lst[idx:] + lst[:idx]
    sub_counts = _split_list_on_element(rotated, most)
    repeated = [list(s) * c for s, c in sub_counts.items()]
    return list(chain.from_iterable(repeated))


def reformat_cycle(s: List[str]) -> List[str]:
    ori = _copy.deepcopy(s)
    n = len(s)
    longest = -1
    for i in range(n // 2 + 1):
        if i > 0 and s[:i] == s[-i:]:
            longest = i
    if longest != -1:
        return s[len(s) - longest :] + s[: len(s) - longest]
    if ori == s:
        s = _merge_repeat(ori)
    return s


def _are_cyclically_equal(s1: str, s2: str) -> bool:
    if s1 in s2:
        return True
    return s2 in (s1 + "\t" + s1)


def find_consecutive_repeats(s: List[str], min_repeat: int = 2) -> List[List[str]]:
    repeats: List[str] = []  # insertion-ordered (reference uses a set)
    for repeat_len in range(1, len(s) // 2 + 1):
        for start in range(0, len(s) - repeat_len * 2 + 1):
            found = False
            count = 1
            while (
                s[start : start + repeat_len]
                == s[start + repeat_len * count : start + repeat_len * (count + 1)]
            ):
                found = True
                count += 1
            if found and count >= min_repeat:
                key = "\t".join(s[start : start + repeat_len])
                if not any(_are_cyclically_equal(item, key) for item in repeats):
                    repeats.append(key)
    return [item.split("\t") for item in repeats]


def _non_dup_item(ori_arr: List[str], unit_cycles: List[List[str]]) -> List[str]:
    ori_str = "\t".join(ori_arr).replace("+", "").replace("-", "")
    # (the reference's .replace() results are discarded — :196-201 quirk)
    return ori_str.split("\t")


def _get_min_copy_seg(unit_seg: Sequence[str], seg_copies: Dict[str, int]):
    min_seg, min_copy = "", 10000
    for item in unit_seg:
        name = item.replace("+", "").replace("-", "")
        cp = seg_copies.get(name, 1)
        if cp < min_copy:
            min_seg, min_copy = name, cp
    return min_seg, min_copy


def _real_copy_for_cycle(unit_seg, seg_copies, non_unit_part) -> int:
    min_seg, min_copy = _get_min_copy_seg(unit_seg, seg_copies)
    other = non_unit_part.count(min_seg)
    real = min_copy - other
    return max(real, 1)


def _get_depth(all_segs, unit_cycles, non_unit_part, depth_store: DepthStore,
               first_item: str):
    """corrected_dup.py:211-248 with DepthStore queries."""
    seg_len_depth: Dict[str, Tuple[float, int]] = {}
    total_vals: List[np.ndarray] = []
    for item in sorted(all_segs):
        contig = item.replace("-", "").replace("+", "")
        vals = depth_store.covered_positions(contig) if depth_store else np.zeros(0)
        if vals.size:
            seg_len_depth[contig] = (float(vals.mean()), int(vals.size))
            total_vals.append(vals)
    total_avg = (
        float(np.concatenate(total_vals).mean()) if total_vals else 0.0
    )
    seg_depth: Dict[str, int] = {}
    for k, (avg, _n) in seg_len_depth.items():
        seg_depth[k] = round(avg / total_avg) if total_avg > 0 else 1

    unit_copies = []
    for unit_seg in unit_cycles:
        cp = _real_copy_for_cycle(unit_seg, seg_depth, non_unit_part)
        unit_copies.append(max(round(cp), 1))
    key = first_item.replace("-", "").replace("+", "")
    return unit_copies, seg_depth.get(key, 0)


def _find_sublist_indexes(A: List[str], B: List[str]):
    if not A or not B:
        return -1, -1
    first, last = -1, -1
    for i in range(len(B) - len(A) + 1):
        if B[i : i + len(A)] == A:
            if first == -1:
                first = i
            last = i
    return first, last + len(A)


def _count_ignoring_direction(lst: Sequence[str], ele: str) -> int:
    ele = ele.replace("+", "").replace("-", "")
    return sum(1 for item in lst if ele in item)


def _contig_len_for_arr(lst: Sequence[str], fai_len: Dict[str, int]) -> int:
    return sum(fai_len[item.replace("+", "").replace("-", "")] for item in lst)


def push_back_cycle_copies(unit_cycles, unit_copies, line_arr, first_item_copy,
                           fai_len) -> List[str]:
    """corrected_dup.py:348-367."""
    for i in range(len(unit_cycles)):
        unit_item = unit_cycles[i] + unit_cycles[i]
        unit_copy = max(unit_copies[i], 1)
        start_idx, end_idx = _find_sublist_indexes(unit_item, line_arr)
        line_arr = line_arr[:start_idx] + unit_cycles[i] * unit_copy + line_arr[end_idx:]
    first_count = _count_ignoring_direction(line_arr, line_arr[0])
    if abs(first_count - first_item_copy) <= 1:
        return line_arr
    sub_counts = _split_list_on_element(line_arr, line_arr[0])
    final_list: List[str] = []
    final_len = 0
    for sublist in sub_counts:
        cur = _contig_len_for_arr(sublist, fai_len)
        if cur > final_len:
            final_list = list(sublist)
            final_len = cur
    return final_list


def is_similar(lst1: Sequence[str], lst2: Sequence[str], fai_len: Dict[str, int]):
    """corrected_dup.py:412-423: length-multiset similarity ≥0.9."""
    l1 = [fai_len[i.replace("+", "").replace("-", "")] for i in lst1]
    l2 = [fai_len[i.replace("+", "").replace("-", "")] for i in lst2]
    s1 = sum(set(l1))
    s2 = sum(set(l2))
    inter = sum(set(l1) & set(l2))
    if s1 and s2 and (inter / s1 >= 0.9 or inter / s2 >= 0.9):
        return (True, 0) if s1 > s2 else (True, 1)
    return False, -1


def filter_cycle_paths(cycle_file: str | Path, depth_store: Optional[DepthStore],
                       fai_len: Dict[str, int]):
    """corrected_dup.py:369-407: per-cycle copy correction + dedup."""
    tmp: List[List[str]] = []
    ori: List[List[str]] = []
    line_count = 0
    with open(cycle_file) as fh:
        for line in fh:
            if not line.strip():
                continue
            line_count += 1
            arr = re.split(r"\s+", line.strip())
            ori.append(arr)
            arr = reformat_cycle(arr)
            first_item = arr[0]
            unit_cycles = find_consecutive_repeats(arr)
            non_unit = _non_dup_item(arr, unit_cycles)
            unit_copies, first_copy = _get_depth(
                set(arr), unit_cycles, non_unit, depth_store, first_item
            )
            tmp.append(
                push_back_cycle_copies(unit_cycles, unit_copies, arr, first_copy, fai_len)
            )
    keeped = set(range(len(tmp)))
    for i in range(len(tmp)):
        if i not in keeped:
            continue
        for j in range(i, len(tmp)):
            if i == j or j not in keeped:
                continue
            similar, idx = is_similar(tmp[i], tmp[j], fai_len)
            if similar:
                if idx == 0:
                    keeped.discard(j)
                else:
                    keeped.discard(i)
                    break
    final = [tmp[i] for i in sorted(keeped)]
    return line_count, final, ori


def _remove_cycle_in_final(ori_cycles: List[List[str]], line_arr: List[str]) -> bool:
    cycles = [
        {i.replace("+", "").replace("-", "") for i in c} for c in ori_cycles
    ]
    names = {i.replace("+", "").replace("-", "") for i in line_arr}
    return any(c == names for c in cycles)


def filter_final_paths(
    final_all_file: str | Path,
    cycle_count: int,
    cycle_result: List[List[str]],
    ori_cycle_result: List[List[str]],
    before_cut: Dict[str, str],
    fai_len: Dict[str, int],
):
    """corrected_dup.py:472-526."""
    tmp = _copy.deepcopy(cycle_result)
    before_cut_swap = {v: k for k, v in before_cut.items()}
    final_cycle_count = cycle_count
    line_idx = 0
    with open(final_all_file) as fh:
        for line in fh:
            if line.strip() == "":
                continue
            if line_idx < cycle_count:
                line_idx += 1
            line_k = (
                line.strip().replace("\t", "").replace("+", "+\t").replace("-", "-\t").strip()
            )
            if line_k in before_cut:
                arr_tmp = before_cut[line_k].split("\t")
            else:
                arr_tmp = line_k.split("\t")
            if _remove_cycle_in_final(ori_cycle_result, arr_tmp):
                continue
            tmp.append(arr_tmp)
            line_idx += 1

    keeped = set(range(len(tmp)))
    for i in range(len(tmp)):
        if i not in keeped:
            continue
        for j in range(i, len(tmp)):
            if i == j or j not in keeped:
                continue
            similar, idx = is_similar(tmp[i], tmp[j], fai_len)
            if similar:
                if idx == 0:
                    keeped.discard(j)
                    if j < cycle_count:
                        final_cycle_count -= 1
                else:
                    keeped.discard(i)
                    if i < cycle_count:
                        final_cycle_count -= 1
                    break
    final = [tmp[i] for i in sorted(keeped)]
    final_cycle = []
    final_uncycle = []
    for item in final:
        if item in cycle_result:
            final_cycle.append(item)
        else:
            key = "\t".join(item)
            if key in before_cut_swap:
                final_uncycle.append(before_cut_swap[key].split("\t"))
            else:
                final_uncycle.append(item)
    return len(final_cycle), final_cycle + final_uncycle


def corrected_dup(
    cycle_file: str | Path,
    final_all_file: str | Path,
    out_final_txt: str | Path,
    edge_fasta_fai: str | Path,
    depth_store: Optional[DepthStore],
    before_cut_file: str | Path,
    min_len: int,
) -> Tuple[int, List[List[str]]]:
    """Full stage: returns (final_cycle_count, written paths)."""
    fai_len: Dict[str, int] = {}
    with open(edge_fasta_fai) as fh:
        for line in fh:
            fields = line.strip().split("\t")
            if len(fields) >= 2:
                fai_len[fields[0]] = int(fields[1])

    before_cut: Dict[str, str] = {}
    with open(before_cut_file) as fh:
        for line in fh:
            if ":" not in line:
                continue
            key, value = line.strip().split(":", 1)
            if key:
                before_cut[key.strip()] = value.strip()

    cycle_count, cycle_result, ori_cycle = filter_cycle_paths(
        cycle_file, depth_store, fai_len
    )
    final_cycle_count, results = filter_final_paths(
        final_all_file, cycle_count, cycle_result, ori_cycle, before_cut, fai_len
    )

    deduped = []
    for path in results:
        d = apply_smart_quota_dedup(path)
        deduped.append(d if d else path)

    written = []
    with open(out_final_txt, "w") as out:
        for item in deduped:
            if get_path_len_names(item) > min_len:
                out.write("\t".join(item) + "\n")
                written.append(item)
    return final_cycle_count, written
