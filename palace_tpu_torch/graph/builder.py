"""Junction-graph construction from a sorted BAM.

Semantic re-implementation of reference bin/generate_graph.cpp: stream
primary alignments, collect split-read (SA tag) and discordant-pair
evidence between contig END regions, aggregate per oriented junction,
estimate per-contig depth/copy-number, and emit SEG/JUNC lines.

This Python version is the exact-semantics oracle and fallback; the
C++ implementation in palace_tpu_torch/native/bamgraph.cpp is the fast
path (tested against this one).  Every quirk of the reference is preserved and
annotated, including:

* refConsumed accumulates *before* the mapq/NM filter (:654-679);
* on the second encounter of an accepted pair, refLen of the current
  read is credited to the *mate's* contig (:890-893);
* after the canonical key swap, the FASTG-membership probe still uses
  the unswapped orientations (:863, :999);
* orientation enumeration order (+,+),(+,-),(-,+),(-,-), first hit
  wins (:772-785, :916-934).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from palace_tpu_torch.config import GraphParams
from palace_tpu_torch.io.bam import (
    FLAG_MREVERSE,
    FLAG_MUNMAP,
    FLAG_PAIRED,
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
    FLAG_UNMAP,
    BamFile,
    BamRecord,
    BamStream,
)
from palace_tpu_torch.io.fastg import parse_fastg_pairs
from palace_tpu_torch.io.graph_io import Graph, JuncRecord, SegRecord

START, END, MIDDLE = 0, 1, 2


def contig_region(pos1: int, contig_len: int, max_end: int) -> int:
    """generate_graph.cpp:56-62."""
    pref = min(max_end, contig_len // 2)
    suff = max(contig_len - max_end, contig_len // 2)
    if pos1 <= pref:
        return START
    if pos1 > suff:
        return END
    return MIDDLE


def dist_to_start(pos: int) -> int:
    return max(0, pos - 1)


def dist_to_end(pos: int, L: int) -> int:
    return max(0, L - pos)


def flip_region(r: int) -> int:
    if r == START:
        return END
    if r == END:
        return START
    return MIDDLE


@dataclass
class ReadInterval:
    start: int = 0
    end: int = 0
    len: int = 0
    soft_start: int = 0
    soft_end: int = 0


def parse_cigar_read_interval(cigar: List[Tuple[int, str]], is_rev: bool,
                              read_len: int = 0) -> ReadInterval:
    """generate_graph.cpp:330-383."""
    iv = ReadInterval()
    if not cigar:
        return iv
    soft_start = cigar[0][0] if cigar[0][1] == "S" else 0
    soft_end = cigar[-1][0] if len(cigar) > 1 and cigar[-1][1] == "S" else 0
    consumed = sum(n for n, op in cigar if op in "MIS=X")
    iv.soft_start, iv.soft_end, iv.len = soft_start, soft_end, consumed
    if not is_rev:
        iv.start = soft_start + 1
        iv.end = consumed - soft_end
    else:
        if read_len > 0:
            iv.start = read_len - (consumed - soft_end) + 1
            iv.end = read_len - soft_start
        else:
            iv.start = soft_start + 1
            iv.end = consumed - soft_end
    return iv


def can_stitch(iv1: ReadInterval, iv2: ReadInterval, max_gap: int,
               max_overlap: int) -> Optional[bool]:
    """generate_graph.cpp:401-428 — returns first1 or None."""
    if iv1.end <= iv2.start:
        if iv2.start - iv1.end - 1 <= max_gap:
            return True
    if iv2.end <= iv1.start:
        if iv1.start - iv2.end - 1 <= max_gap:
            return False
    if iv1.start <= iv2.end and iv2.start <= iv1.end:
        overlap = min(iv1.end, iv2.end) - max(iv1.start, iv2.start) + 1
        if overlap <= max_overlap:
            return iv1.start <= iv2.start
    return None


def end_weight(d1: int, d2: int, max_end: int) -> float:
    lam = max(50.0, max_end / 2.0)
    return math.exp(-d1 / lam) * math.exp(-d2 / lam)


def near_end_distances(regL, posL, LL, oL, regR, posR, LR, oR):
    """generate_graph.cpp:311-318."""
    gL = flip_region(regL) if oL == "-" else regL
    gR = flip_region(regR) if oR == "-" else regR
    dL = dist_to_start(posL) if gL == START else dist_to_end(posL, LL)
    dR = dist_to_start(posR) if gR == START else dist_to_end(posR, LR)
    return dL, dR


@dataclass
class Evidence:
    A: str = ""
    B: str = ""
    LA: int = 0
    LB: int = 0
    posA: int = 0
    posB: int = 0
    regA: int = MIDDLE
    regB: int = MIDDLE
    mapqA: int = 0
    nmA: int = 0
    mapqB: int = 0
    nmB: int = 0


def compute_layout_score(ev: Evidence, left_is_a: bool, oL: str, oR: str,
                         max_end: int) -> float:
    """generate_graph.cpp:432-461 (returns 0.0 when rejected)."""
    LL, LR = (ev.LA, ev.LB) if left_is_a else (ev.LB, ev.LA)
    posL, posR = (ev.posA, ev.posB) if left_is_a else (ev.posB, ev.posA)
    regL, regR = (ev.regA, ev.regB) if left_is_a else (ev.regB, ev.regA)
    mapqL, nmL = (ev.mapqA, ev.nmA) if left_is_a else (ev.mapqB, ev.nmB)
    mapqR, nmR = (ev.mapqB, ev.nmB) if left_is_a else (ev.mapqA, ev.nmA)
    dL, dR = near_end_distances(regL, posL, LL, oL, regR, posR, LR, oR)
    w_end = end_weight(dL, dR, max_end)
    w_l = min(1.0, mapqL / 60.0) * (1.0 / (1.0 + 0.2 * max(0, nmL)))
    w_r = min(1.0, mapqR / 60.0) * (1.0 / (1.0 + 0.2 * max(0, nmR)))
    return w_end * w_l * w_r


def check_split_read_layout(rev1, reg1, rev2, reg2, oL, oR, first1) -> bool:
    """generate_graph.cpp:510-538."""
    revL, revR = (rev1, rev2) if first1 else (rev2, rev1)
    regL, regR = (reg1, reg2) if first1 else (reg2, reg1)
    fwdL = revL if oL == "-" else not revL
    fwdR = revR if oR == "-" else not revR
    if not fwdL or not fwdR:
        return False
    if regL == MIDDLE or regR == MIDDLE:
        return False
    if regL != (END if oL == "+" else START):
        return False
    if regR != (START if oR == "+" else END):
        return False
    return True


def check_paired_end_layout(pos1, rev1, reg1, L1, pos2, rev2, reg2, L2,
                            oL, oR, first1, max_span_frac) -> bool:
    """generate_graph.cpp:465-506."""
    if first1:
        revL, revR, regL, regR = rev1, rev2, reg1, reg2
        posL, posR, LL, LR = pos1, pos2, L1, L2
    else:
        revL, revR, regL, regR = rev2, rev1, reg2, reg1
        posL, posR, LL, LR = pos2, pos1, L2, L1
    fwdL = revL if oL == "-" else not revL
    fwdR = revR if oR == "-" else not revR
    if not fwdL or fwdR:
        return False
    if regL == MIDDLE or regR == MIDDLE:
        return False
    if regL != (END if oL == "+" else START):
        return False
    if regR != (START if oR == "+" else END):
        return False
    distL = dist_to_start(posL) if regL == START else dist_to_end(posL, LL)
    distR = dist_to_start(posR) if regR == START else dist_to_end(posR, LR)
    fracL = distL / LL if LL > 0 else 1.0
    fracR = distR / LR if LR > 0 else 1.0
    if fracL > max_span_frac or fracR > max_span_frac:
        return False
    return True


@dataclass
class AggStats:
    supplement: int = 0
    span: int = 0
    supplement_no_fastg: int = 0
    span_no_fastg: int = 0


def _parse_sa_item(item: str):
    parts = [p.strip() for p in item.split(",")]
    if len(parts) < 6 or not parts[0] or not parts[1]:
        return None
    try:
        return {
            "rname": parts[0],
            "pos": int(parts[1]),
            "is_rev": parts[2] == "-",
            "cigar": parts[3],
            "mapq": int(parts[4]),
            "nm": int(parts[5]),
        }
    except ValueError:
        return None


def _cigar_ops(cigar_str: str) -> List[Tuple[int, str]]:
    ops = []
    n = 0
    for ch in cigar_str:
        if ch.isdigit():
            n = n * 10 + int(ch)
        else:
            if n > 0:
                ops.append((n, ch))
            n = 0
    return ops


_FLIP = {"+": "-", "-": "+"}
_ORIENTS = ("+", "-")


def build_graph_from_bam(
    bam: BamFile | str | Path,
    fastg_fai: str | Path,
    avg_depth: float,
    params: GraphParams | None = None,
) -> Graph:
    if isinstance(bam, BamFile):
        records = bam.records
    else:  # stream: constant memory (generate_graph.cpp:644 sam_read1 loop)
        bam = BamStream(bam)
        records = bam
    p = params or GraphParams()
    fastg_pairs = parse_fastg_pairs(fastg_fai)
    name_to_tid = bam.name_to_tid()
    targets = bam.references

    ref_consumed: Dict[str, float] = {}
    agg: Dict[Tuple[str, str, str, str], AggStats] = {}
    processed_paired: Set[str] = set()

    for rec in records:
        f = rec.flag
        if f & (FLAG_SUPPLEMENTARY | FLAG_SECONDARY | FLAG_UNMAP):
            continue
        read_name = rec.name
        if rec.tid >= 0:
            L = rec.ref_len()
            if L > 0:
                tname = targets[rec.tid][0]
                ref_consumed[tname] = ref_consumed.get(tname, 0.0) + L

        main_mapq = rec.mapq
        main_nm = int(rec.tags.get("NM", 0) or 0)
        ref_len1 = rec.ref_len()

        if not (main_mapq >= p.min_mapq and main_nm <= p.max_nm):
            continue

        has_supplement = False
        sa = rec.tags.get("SA")
        if sa and rec.tid >= 0:
            r1 = targets[rec.tid][0]
            L1 = targets[rec.tid][1]
            pos1 = rec.pos + 1
            rev1 = bool(f & FLAG_REVERSE)
            reg1 = contig_region(pos1, L1, p.max_end)
            read_len = rec.read_len()
            iv1 = parse_cigar_read_interval(rec.cigar, rev1, read_len)

            for item in str(sa).split(";"):
                if not item:
                    continue
                it = _parse_sa_item(item)
                if it is None:
                    continue
                if not (it["mapq"] >= p.min_mapq and it["nm"] <= p.max_nm):
                    continue
                r2 = it["rname"]
                if r1 == r2 or r2 not in name_to_tid:
                    continue
                tid2 = name_to_tid[r2]
                L2 = targets[tid2][1]
                pos2 = it["pos"]
                rev2 = it["is_rev"]
                reg2 = contig_region(pos2, L2, p.max_end)
                if reg1 == MIDDLE or reg2 == MIDDLE:
                    continue
                iv2 = parse_cigar_read_interval(_cigar_ops(it["cigar"]), rev2, read_len)
                first1 = can_stitch(iv1, iv2, p.max_gap, p.max_overlap)
                if first1 is None:
                    continue
                found = None
                for oL in _ORIENTS:
                    for oR in _ORIENTS:
                        if check_split_read_layout(rev1, reg1, rev2, reg2, oL, oR, first1):
                            found = (oL, oR)
                            break
                    if found:
                        break
                if not found:
                    continue
                oL_found, oR_found = found
                cL = r1 if first1 else r2
                cR = r2 if first1 else r1

                ev = Evidence()
                if cL <= cR:
                    ev.A, ev.B = cL, cR
                    a_is_first1 = True
                else:
                    ev.A, ev.B = cR, cL
                    a_is_first1 = False
                # evidence slots follow (A := lexicographically smaller)
                take1_as_a = (cL <= cR) == first1
                if take1_as_a:
                    ev.LA, ev.LB = L1, L2
                    ev.posA, ev.posB = pos1, pos2
                    ev.regA, ev.regB = reg1, reg2
                    ev.mapqA, ev.nmA = main_mapq, main_nm
                    ev.mapqB, ev.nmB = it["mapq"], it["nm"]
                else:
                    ev.LA, ev.LB = L2, L1
                    ev.posA, ev.posB = pos2, pos1
                    ev.regA, ev.regB = reg2, reg1
                    ev.mapqA, ev.nmA = it["mapq"], it["nm"]
                    ev.mapqB, ev.nmB = main_mapq, main_nm

                left_is_a = ev.A == cL
                oL_eval = oL_found if left_is_a else oR_found
                oR_eval = oR_found if left_is_a else oL_found
                score = compute_layout_score(ev, left_is_a, oL_eval, oR_eval, p.max_end)
                if score > 0.0:
                    key = (cL, oL_found, cR, oR_found)
                    kL, kR = cL, cR
                    if kR < kL:  # canonical swap (:856-861)
                        kL, kR = kR, kL
                        key = (kL, _FLIP[oR_found], kR, _FLIP[oL_found])
                    # fastg probe uses the (possibly swapped) names with the
                    # UNswapped orientations (:863 quirk)
                    in_fastg = (kL, kR, oL_found, oR_found) in fastg_pairs
                    stats = agg.setdefault(key, AggStats())
                    if in_fastg:
                        stats.supplement += 1
                    else:
                        stats.supplement_no_fastg += 1
                    has_supplement = True

        if (
            not has_supplement
            and p.enable_paired
            and (f & FLAG_PAIRED)
            and not (f & FLAG_MUNMAP)
            and rec.mtid >= 0
            and rec.mtid != rec.tid
        ):
            if read_name in processed_paired:
                mate_name = targets[rec.mtid][0]
                ref_consumed[mate_name] = ref_consumed.get(mate_name, 0.0) + max(0, ref_len1)
                continue
            r1 = targets[rec.tid][0]
            r2 = targets[rec.mtid][0]
            L1 = targets[rec.tid][1]
            L2 = targets[rec.mtid][1]
            pos1 = rec.pos + 1
            pos2 = rec.mpos + 1
            rev1 = bool(f & FLAG_REVERSE)
            rev2 = bool(f & FLAG_MREVERSE)
            reg1 = contig_region(pos1, L1, p.max_end)
            reg2 = contig_region(pos2, L2, p.max_end)
            if reg1 == MIDDLE or reg2 == MIDDLE:
                continue
            found = None
            for order in (0, 1):
                first1 = order == 0
                for oL in _ORIENTS:
                    for oR in _ORIENTS:
                        if check_paired_end_layout(
                            pos1, rev1, reg1, L1, pos2, rev2, reg2, L2,
                            oL, oR, first1, p.max_span_frac,
                        ):
                            found = (oL, oR, first1)
                            break
                    if found:
                        break
                if found:
                    break
            if not found:
                continue
            oL_found, oR_found, first1 = found
            processed_paired.add(read_name)
            cL = r1 if first1 else r2
            cR = r2 if first1 else r1

            ev = Evidence()
            if cL <= cR:
                ev.A, ev.B = cL, cR
            else:
                ev.A, ev.B = cR, cL
            take1_as_a = (cL <= cR) == first1
            if take1_as_a:
                ev.LA, ev.LB = L1, L2
                ev.posA, ev.posB = pos1, pos2
                ev.regA, ev.regB = reg1, reg2
            else:
                ev.LA, ev.LB = L2, L1
                ev.posA, ev.posB = pos2, pos1
                ev.regA, ev.regB = reg2, reg1
            ev.mapqA = ev.mapqB = main_mapq
            ev.nmA = ev.nmB = main_nm

            left_is_a = ev.A == cL
            oL_eval = oL_found if left_is_a else oR_found
            oR_eval = oR_found if left_is_a else oL_found
            score = compute_layout_score(ev, left_is_a, oL_eval, oR_eval, p.max_end)
            if score > 0.0:
                key = (cL, oL_found, cR, oR_found)
                kL, kR = cL, cR
                if kR < kL:
                    kL, kR = kR, kL
                    key = (kL, _FLIP[oR_found], kR, _FLIP[oL_found])
                in_fastg = (kL, kR, oL_found, oR_found) in fastg_pairs
                stats = agg.setdefault(key, AggStats())
                if in_fastg:
                    stats.span += 1
                else:
                    stats.span_no_fastg += 1

    # SEG table (:1019-1034)
    graph = Graph()
    for name, L in targets:
        if L <= 0:
            continue
        consumed = ref_consumed.get(name, 0.0)
        depth = consumed / max(1, L)
        cn = int(math.floor((depth / avg_depth if avg_depth > 0 else 0.0) + 0.5))
        graph.add_seg(SegRecord(name=name, depth=depth, copy_number=cn))

    # JUNC lines in key order (std::map iteration, :1052): the map's key
    # compares (left, right, left orient, right orient) (:286-291), as the
    # native program does; sorting the (left, oL, right, oR) tuples would
    # put a contig's '+' junctions before its '-' ones to lesser partners
    for key in sorted(agg, key=lambda k: (k[0], k[2], k[1], k[3])):
        s = agg[key]
        total = s.supplement + s.span + s.supplement_no_fastg + s.span_no_fastg
        if total == 0 or total < p.min_count:
            continue
        graph.add_junc(
            JuncRecord(
                left=key[0], left_orient=key[1], right=key[2], right_orient=key[3],
                support=s.supplement + s.span + s.supplement_no_fastg,
                span_no_fastg=s.span_no_fastg,
            )
        )
    return graph


def write_graph_output(path: str | Path, graph: Graph) -> None:
    from palace_tpu_torch.io.graph_io import write_graph_file

    write_graph_file(path, graph)
