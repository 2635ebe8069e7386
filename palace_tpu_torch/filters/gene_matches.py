"""Phage protein/gene search against contigs.

Semantic port of share/palace/scripts/find_phage_gene_matches.py.  The
alignment engines (tblastn/blastn/mmseqs/diamond) remain external
tools, exactly as in the reference; the hit logic (:104-122) and the
``hit_seqs.out`` contract (:150-151) are owned here.  When no engine is
on PATH the stage degrades to an empty hit file (the pipeline's
no-reference paths handle that, palace:509-512).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from palace_tpu_torch.utils.logging import get_logger

logger = get_logger("palace")


def get_hits(
    result_file: str | Path,
    hit_contigs: Dict[str, int],
    thresh: float = 0.75,
    is_protein: bool = False,
    engine: str = "blast",
) -> None:
    """Count per-contig hits from a 7-column engine output
    ``qseqid sseqid length pident qlen slen evalue``
    (find_phage_gene_matches.py:104-122)."""
    if not result_file or not os.path.exists(result_file):
        return
    with open(result_file) as fh:
        for line in fh:
            splt = line.strip().split("\t")
            if len(splt) < 7:
                continue
            contig = re.split(r"[:;]", splt[1])[0]
            percentid = float(splt[3])
            matchlen = float(splt[2])
            genelen = int(splt[4])
            if engine == "mmseqs" and is_protein:
                matchlen = matchlen / 3.0
            coverage = matchlen / genelen
            if percentid > thresh * 100 and coverage > thresh:
                hit_contigs[contig] = hit_contigs.get(contig, 0) + 1


def write_hit_file(out_dir: str | Path, hit_contigs: Dict[str, int]) -> Path:
    out = Path(out_dir) / "hit_seqs.out"
    with open(out, "w") as fh:
        for k, v in hit_contigs.items():
            fh.write(f"{k}\t{v}\n")
    return out


def find_phage_gene_matches(
    contigs_fasta: str | Path,
    protein_db_dir: str | Path,
    out_dir: str | Path,
    threads: int = 1,
    thresh: float = 0.75,
    bin_path: str = "",
) -> Path:
    """Full stage with the blast engine: makeblastdb + tblastn each
    protein FASTA (palace:451-456 → find_phage_gene_matches.py main).
    Falls back to an empty hit file when blast is unavailable."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    makeblastdb = os.path.join(bin_path, "makeblastdb") if bin_path else "makeblastdb"
    tblastn = os.path.join(bin_path, "tblastn") if bin_path else "tblastn"
    hit_contigs: Dict[str, int] = {}
    if shutil.which(makeblastdb) and shutil.which(tblastn):
        dbpath = out_dir / (Path(contigs_fasta).name + ".blastdb")
        subprocess.run(
            [makeblastdb, "-in", str(contigs_fasta), "-dbtype", "nucl", "-out", str(dbpath)],
            check=True, capture_output=True,
        )
        for fname in sorted(os.listdir(protein_db_dir)):
            pf = Path(protein_db_dir) / fname
            outputpath = out_dir / (fname + "_blast.out")
            subprocess.run(
                [
                    tblastn, "-db", str(dbpath), "-db_gencode", "11", "-query", str(pf),
                    "-out", str(outputpath), "-num_threads", str(threads),
                    "-outfmt", "6 qseqid sseqid length pident qlen slen evalue",
                ],
                check=True, capture_output=True,
            )
            get_hits(outputpath, hit_contigs, thresh, is_protein=True)
    else:
        logger.warning(
            "tblastn/makeblastdb not found — protein search degrades to empty hits"
        )
    return write_hit_file(out_dir, hit_contigs)
