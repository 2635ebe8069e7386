"""External-tool boundary.

QC/assembly/mapping and nucleotide/protein alignment stay external
preprocessing exactly as in the reference: fastp (palace:358-363),
metaSPAdes (:381-384), bwa+samtools (:413-434), blastn/makeblastdb
(:520-528, :615-632), RagTag (:705-763).

Each wrapper is gated on PATH availability and returns False when the
tool is absent, letting the driver degrade the same way the reference
does for missing references (touch-empty semantics) or require
pre-staged artifacts.
"""
from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Sequence

from palace_tpu_torch.utils.logging import get_logger

logger = get_logger("palace")


def _have(tool: str) -> bool:
    return shutil.which(tool) is not None


def _run(cmd: Sequence[str], **kw) -> None:
    logger.info("$ %s", " ".join(str(c) for c in cmd))
    subprocess.run([str(c) for c in cmd], check=True, **kw)


def run_fastp(fq1, fq2, out1, out2, threads: int, json_out, html_out) -> bool:
    if not _have("fastp"):
        return False
    _run(["fastp", "-i", fq1, "-I", fq2, "-o", out1, "-O", out2,
          "-w", threads, "-j", json_out, "-h", html_out])
    return True


def run_spades_meta(fq1, fq2, out_dir, threads: int, memory_gb: int = 200) -> bool:
    if not _have("spades.py"):
        return False
    _run(["spades.py", "--meta", "-o", out_dir, "-1", fq1, "-2", fq2,
          "-t", threads, "-m", memory_gb])
    return True


def run_bwa_samtools(ref_fasta, fq1, fq2, out_bam, threads: int) -> bool:
    """bwa index+mem | samtools view -F 0x800 | sort | index
    (palace:409-434)."""
    if not (_have("bwa") and _have("samtools")):
        return False
    if not Path(str(ref_fasta) + ".bwt").exists():
        _run(["bwa", "index", ref_fasta])
    tmp_bam = str(out_bam) + ".tmp.bam"
    with open(tmp_bam, "wb") as tmp:
        p1 = subprocess.Popen(
            ["bwa", "mem", "-t", str(threads), str(ref_fasta), str(fq1), str(fq2)],
            stdout=subprocess.PIPE,
        )
        p2 = subprocess.Popen(
            ["samtools", "view", "-@", str(threads), "-F", "0x0800", "-buS", "-"],
            stdin=p1.stdout, stdout=tmp,
        )
        p1.stdout.close()
        p2.communicate()
        if p2.returncode != 0:
            raise RuntimeError("bwa|samtools pipe failed")
    _run(["samtools", "sort", "-@", threads, tmp_bam, "-O", "BAM", "-o", out_bam])
    Path(tmp_bam).unlink(missing_ok=True)
    _run(["samtools", "index", out_bam])
    return True


def run_makeblastdb(fasta, out_db) -> bool:
    if not _have("makeblastdb"):
        return False
    _run(["makeblastdb", "-in", fasta, "-dbtype", "nucl", "-out", out_db],
         capture_output=True)
    return True


OUTFMT_A = ("6 qseqid sseqid pident length mismatch gapopen qstart qend "
            "sstart send evalue bitscore qlen slen")
OUTFMT_B = ("6 qaccver saccver pident qlen slen length mismatch gapopen "
            "qstart qend sstart send evalue bitscore")


def run_blastn(query, db, out, threads: int, outfmt: str = OUTFMT_A) -> bool:
    if not _have("blastn"):
        return False
    _run(["blastn", "-query", query, "-db", db, "-out", out,
          "-num_threads", threads, "-outfmt", outfmt])
    return True


def run_ragtag(ref_fasta, query_fasta, out_dir, min_len: int = 2000) -> bool:
    if not _have("ragtag.py"):
        return False
    _run(["ragtag.py", "scaffold", "-r", ref_fasta, query_fasta,
          "-o", out_dir, "-d", min_len])
    return True
