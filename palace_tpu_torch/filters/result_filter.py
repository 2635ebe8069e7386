"""Filter matched paths into ``{prefix}_filtered.fasta`` +
``{prefix}_filtered_cycle.txt``.

Semantic port of share/palace/scripts/filter_result.py, preserving its
quirks:

* the blast accumulation primes each group with the first row's
  aln_len unconditionally and, at EOF, adds the LAST line's query
  rather than the tracked prev_seg (:70-89);
* ``self``/``iter`` markers set *sticky* tags (:123-130);
* self-tagged single-token paths with gene/score evidence are only
  recorded (``selfgene`` tag), not written to the FASTA (:139-148);
* cycle-tagged paths get ``cyclegene``/``cyclescore`` records
  (:161-171);
* a path is written to the FASTA when blast-covered >0.2, gene-hit, or
  max score ≥0.9 (with the ≥1000 bp gate) (:173-227);
* recorded paths ≥10 kb go to the cycle file with self/gene/score tags
  stripped but ``cycle`` retained (:229-235).

The reference iterates a ``set`` for the final write; we keep
insertion order for determinism.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Set

from palace_tpu_torch.io.fasta import FastaStore


def _blast_covered_segs(blast_file: str | Path, fai_len: Dict[str, int],
                        blast_ratio: float) -> Set[str]:
    blast_segs: Set[str] = set()
    prev_seg = ""
    prev_ref = ""
    prev_len = 0
    last_query = ""
    with open(blast_file) as fh:
        for line in fh:
            t = line.strip().split("\t")
            if len(t) < 4:
                continue
            last_query = t[0]
            if (prev_seg != t[0] and prev_seg != "") or (prev_ref != t[1] and prev_ref != ""):
                elen = fai_len[prev_seg]
                if float(prev_len) / float(elen) > blast_ratio:
                    blast_segs.add(prev_seg)
                prev_seg = t[0]
                prev_ref = t[1]
                prev_len = int(t[3])
            else:
                if float(t[2]) > blast_ratio * 100:
                    prev_len += int(t[3])
                prev_seg = t[0]
                prev_ref = t[1]
    if prev_seg != "":
        elen = fai_len[prev_seg]
        if float(prev_len) / float(elen) > blast_ratio:
            blast_segs.add(last_query)  # reference adds t[0] (:89)
    return blast_segs


def _strip_orients(text: str) -> List[str]:
    return [v for v in text.strip().replace("+", "").replace("-", "").split("\t") if v]


def _seg_len(token: str, fai_len: Dict[str, int]) -> int:
    """filter_result.py:41-43 tag-stripping length lookup."""
    t = token.replace("\t", "").replace(" ", "")
    for tag in ("+", "-", "ref", "self", "gene", "score", "cycle"):
        t = t.replace(tag, "")
    return fai_len[t]


def _line_len(line: str, fai_len: Dict[str, int]) -> int:
    total = 0
    for v in re.split(r"[+-]", line):
        if v == "":
            continue
        total += _seg_len(v, fai_len)
    return total


def filter_result(
    fasta_path: str | Path,
    result_path: str | Path,
    out_fasta: str | Path,
    blast_path: str | Path,
    blast_ratio: float,
    gene_hit_path: str | Path,
    score_path: str | Path,
    out_cycle: str | Path,
    min_cycle_len: int = 10000,
) -> None:
    store = FastaStore(fasta_path)
    fai_len = store.index.lengths()

    blast_segs = _blast_covered_segs(blast_path, fai_len, blast_ratio)

    phagescore: Dict[str, float] = {}
    with open(score_path) as fh:
        for s in fh:
            item = s.strip().split("\t")
            if len(item) >= 2 and float(item[1]) >= 0.7:
                phagescore[item[0]] = float(item[1])

    genehit: List[str] = []
    with open(gene_hit_path) as fh:
        for s in fh:
            if s.strip():
                genehit.append(s.strip().split("\t")[0])

    def contains_gene(line: str) -> bool:
        stripped = line.strip().replace("+", "").replace("-", "")
        return any(item in genehit for item in stripped.split("\t"))

    def max_score(line: str) -> float:
        stripped = line.strip().replace("+", "").replace("-", "")
        best = 0.0
        for item in stripped.split("\t"):
            if item in phagescore and phagescore[item] > best:
                best = phagescore[item]
        return best

    def path_seq(tokens: List[str]) -> str:
        seq = ""
        for t in tokens:
            if not t:
                continue
            seq += store.fetch_oriented(t)
        return seq

    res_count: Dict[str, None] = {}  # insertion-ordered set
    in_faout: Set[str] = set()
    fa_out = open(out_fasta, "w")

    self_tag = False
    cycle_tag = False
    try:
        with open(result_path) as fh:
            for line in fh:
                if line.startswith("iter") or line.startswith("self"):
                    if line.startswith("self"):
                        self_tag = True
                    if line.startswith("iter"):
                        cycle_tag = True
                    continue
                if line.strip() == "":
                    continue
                tmp = line.strip().split("\t")
                joined = "".join(tmp)

                if len(tmp) == 1 and self_tag:
                    if contains_gene(line) or max_score(line) > 0.7:
                        res_count.setdefault("selfgene" + joined)
                    else:
                        if joined not in in_faout:
                            fa_out.write(f">{joined}\n{path_seq(tmp)}\n")
                            in_faout.add(joined)
                        res_count.setdefault(joined)
                    continue

                if cycle_tag:
                    if contains_gene(line):
                        res_count.setdefault("cyclegene" + joined)
                    if max_score(line) >= 0.9:
                        res_count.setdefault("cyclescore" + joined)

                flags = False
                blast_len = 0
                all_len = 0
                if contains_gene(line):
                    flags = True
                for t in tmp:
                    if not t:
                        continue
                    fai_k = t.replace("+", "").replace("-", "")
                    if not fai_k:
                        continue
                    elen = fai_len[fai_k]
                    all_len += elen
                    if t[:-1] in blast_segs:
                        blast_len += elen
                if all_len != 0 and blast_len / all_len > 0.2:
                    flags = True
                if not flags and (max_score(line) < 0.9 or all_len < 1000):
                    continue

                seq = path_seq(tmp)
                wrote = False
                if contains_gene(line) and max_score(line) >= 0.9:
                    wrote = True
                else:
                    if max_score(line) >= 0.9 or contains_gene(line) or flags:
                        wrote = True
                if wrote and joined not in in_faout:
                    fa_out.write(f">{joined}\n{seq}\n")
                    in_faout.add(joined)
    finally:
        fa_out.close()
        store.close()

    with open(out_cycle, "w") as res:
        for s in res_count:
            sresult = s.replace("self", "").replace("gene", "").replace("score", "")
            s_len = _line_len(s, fai_len)
            if s_len >= min_cycle_len:
                res.write(sresult + "\n")
