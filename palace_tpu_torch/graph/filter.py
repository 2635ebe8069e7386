"""Graph filtering: seed-and-expand around phage-like contigs.

Semantic port of share/palace/scripts/filter_graph.py: seeds are
contigs that are blast-covered (cumulative per-(query,ref) aligned
length / contig length > ratio, or > 2000 bp), protein-hit, or
GCN-scored above threshold (:66-117, :153-156); JUNCs touching seeds
are kept and expanded one hop (:220-245); whole SPAdes paths with ≥50 %
seed content (or >2000 bp) are recovered (:126-151); SEG lines gain
``<gene> <score> <is_blast>`` columns (:173-197); ``all_hit_segs.txt``
records the hit annotations (:266-269).

Output ordering note: the reference accumulates SEG lines in a Python
``set`` so its order is nondeterministic; we emit them in first-seen
order (deterministic) and the pipeline applies
``uniq`` just like palace:581.
"""
from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from palace_tpu_torch.io.blast import read_outfmt6
from palace_tpu_torch.io.fasta import FastaIndex
from palace_tpu_torch.io.paths_io import spades_path_number_lines

SAMPLE = "SAMPLE"


def parse_blast_covered(
    blast_file: str | Path, fai_len: Dict[str, int], blast_ratio: float,
    len_threshold: int = 2000, require_both: bool = False,
) -> Set[str]:
    """Run-length accumulation over consecutive (query, ref) rows —
    exact filter_graph.py:66-94 semantics, including the quirk that the
    first row of each new group primes ``prev_len`` with its aln_len
    regardless of identity, and that only identity > ratio·100 rows
    accumulate."""
    covered: Set[str] = set()
    prev_seg = ""
    prev_ref = ""
    prev_len = 0
    with open(blast_file) as fh:
        for line in fh:
            fields = line.strip().split("\t")
            if len(fields) < 4:
                continue
            query, ref, identity, aln_len = (
                fields[0], fields[1], float(fields[2]), int(fields[3]),
            )
            if (prev_seg != query and prev_seg != "") or (prev_ref != ref and prev_ref != ""):
                seg_len = fai_len[prev_seg]
                if prev_len / seg_len > blast_ratio or (
                    not require_both and prev_len > len_threshold
                ):
                    covered.add(prev_seg)
                prev_seg = query
                prev_ref = ref
                prev_len = aln_len if identity > blast_ratio * 100 else 0
            else:
                if identity > blast_ratio * 100:
                    prev_len += aln_len
                prev_seg = query
                prev_ref = ref
    if prev_seg and prev_seg in fai_len:
        seg_len = fai_len[prev_seg]
        if prev_len / seg_len > blast_ratio or (not require_both and prev_len > len_threshold):
            covered.add(prev_seg)
    return covered


def load_gene_hits(gene_file: str | Path) -> Dict[str, str]:
    """hit_seqs.out → {contig: '1'} (filter_graph.py:99-102)."""
    out: Dict[str, str] = {}
    with open(gene_file) as fh:
        for line in fh:
            if line.strip():
                out[line.split("\t")[0]] = "1"
    return out


def load_scores_formatted(score_file: str | Path, threshold: float) -> Tuple[Dict[str, str], Set[str]]:
    """node_scores.out → ({contig: '0.xxx' 3-decimals}, {above threshold}).

    Scores in scientific notation collapse to '0.0'
    (filter_graph.py:104-116)."""
    scores: Dict[str, str] = {}
    above: Set[str] = set()
    with open(score_file) as fh:
        for line in fh:
            fields = line.strip().split("\t")
            if len(fields) < 2:
                continue
            contig, score_str = fields[0], fields[1]
            if "e" in score_str.lower():
                value = "0.0"
            else:
                value = f"{float(score_str):.3f}"
            scores[contig] = value
            if float(value) > threshold:
                above.add(contig)
    return scores, above


def _clean_seg_fields(line: str) -> str:
    """Numeric fields in scientific notation are re-formatted
    (filter_graph.py:173-191)."""
    fields = line.strip().split()
    cleaned = [fields[0], fields[1]]
    for field in fields[2:]:
        if "e" in field.lower():
            try:
                val = float(field)
                if val.is_integer():
                    cleaned.append(str(int(val)))
                else:
                    cleaned.append(f"{val:.3f}".rstrip("0").rstrip("."))
            except ValueError:
                cleaned.append(field)
        else:
            cleaned.append(field)
    return " ".join(cleaned)


def filter_graph(
    fastg_fai: str | Path,
    graph_file: str | Path,
    output_file: str | Path,
    gene_file: str | Path,
    score_file: str | Path,
    blast_file: str | Path,
    blast_ratio: float,
    fasta_fai: str | Path,
    hit_segs_file: str | Path,
    contig_paths: str | Path,
    score_threshold: float,
) -> None:
    fai = FastaIndex.read(fasta_fai)
    fai_len = fai.lengths()
    num_to_full = {name.split("_")[1]: name for name in fai_len if "_" in name}

    blast_segs = parse_blast_covered(blast_file, fai_len, blast_ratio)
    gene_res = load_gene_hits(gene_file)
    scores, score_segs = load_scores_formatted(score_file, score_threshold)

    with open(graph_file) as fh:
        lines = fh.readlines()

    all_segs: Dict[str, str] = {}
    hit_segs: Dict[str, str] = {}
    relevate: Set[str] = set()
    write_segs: List[str] = []
    written: Set[str] = set()
    write_juncs: List[str] = []

    def seg_line_out(seg_name: str) -> str:
        cleaned = _clean_seg_fields(all_segs[seg_name])
        is_blast = "1" if seg_name in blast_segs else "0"
        gene_val = gene_res.get(seg_name, "0")
        score_val = scores.get(seg_name, "0.000")
        return f"{cleaned} {gene_val} {score_val} {is_blast}\n"

    def add_seg(seg_name: str) -> None:
        out = seg_line_out(seg_name)
        if out not in written:
            written.add(out)
            write_segs.append(out)

    def should_include(seg_name: str) -> bool:
        return (
            seg_name in blast_segs
            or seg_name in gene_res
            or float(scores.get(seg_name, "0")) > score_threshold
        )

    for line in lines:
        fields = line.rstrip().split(" ")
        if fields[0] == "SEG":
            seg_name = fields[1]
            all_segs[seg_name] = line
            info = []
            if seg_name in blast_segs:
                info.append("ref+")
            if float(scores.get(seg_name, "0")) > score_threshold:
                info.append("score+")
            if seg_name in gene_res:
                info.append("gene+")
            if info:
                hit_segs[seg_name] = "".join(info)
                relevate.add(seg_name)
            if should_include(seg_name):
                add_seg(seg_name)

    core_seeds = set(relevate)
    hop1: Set[str] = set()
    for line in lines:
        fields = line.rstrip().split(" ")
        if fields[0] != "SEG":
            left_seg, right_seg = fields[1], fields[3]
            if left_seg == right_seg or left_seg in core_seeds or right_seg in core_seeds:
                write_juncs.append(line)
                add_seg(left_seg)
                add_seg(right_seg)
                hop1.add(left_seg)
                hop1.add(right_seg)
    relevate.update(hop1)

    for line in lines:
        fields = line.rstrip().split(" ")
        if fields[0] != "SEG":
            left_seg, right_seg = fields[1], fields[3]
            if left_seg in relevate or right_seg in relevate:
                write_juncs.append(line)
                add_seg(left_seg)
                add_seg(right_seg)

    # SPAdes-path recovery (:126-151)
    support_segs = blast_segs | set(gene_res) | score_segs
    path_segs: List[str] = []
    path_seen: Set[str] = set()
    for nums in spades_path_number_lines(contig_paths):
        full_names = []
        full_len = 0
        add_len = 0
        for num in nums:
            full_name = num_to_full[num[:-1]]
            full_names.append(full_name)
            e_len = int(full_name.split("_")[3])
            full_len += e_len
            if full_name in support_segs:
                add_len += e_len
        if add_len > 0 and (add_len / full_len >= 0.5 or add_len > 2000):
            for n in full_names:
                if n not in path_seen:
                    path_seen.add(n)
                    path_segs.append(n)

    written_names = {item.split(" ")[1] for item in write_segs}
    with open(output_file, "w") as out:
        for seg_line in write_segs:
            out.write(seg_line)
        for seg in path_segs:
            if seg not in written_names:
                out.write(f"{all_segs[seg].strip()} 0 1.0 0\n")
        seen_juncs: Set[str] = set()
        for junc in write_juncs:
            if junc not in seen_juncs:
                out.write(junc)
                seen_juncs.add(junc)

    with open(hit_segs_file, "w") as out:
        for seg_name, info in hit_segs.items():
            if info:
                out.write(f"{SAMPLE}\t{seg_name}\t{info}\n")


def uniq_file(src: str | Path, dst: str | Path) -> None:
    """``uniq`` over adjacent duplicate lines (palace:581)."""
    with open(src) as fin, open(dst, "w") as fout:
        prev = None
        for line in fin:
            if line != prev:
                fout.write(line)
            prev = line
