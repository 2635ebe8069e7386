"""Driver ``eref``: a sample's reads searched against a phagedb by whole
calls of ``palace_tpu_torch.search.eref.run_search``: two FASTQ files and
the index → Phase A → Phase B → ``ref_names.txt``.  The index is built in
set-up, as the pipeline builds it once a phagedb.

The sample is a community (``community``), fixed by the mix's own
``lengths_seed`` so that every run seed does the same work: the
phagedb's reference lengths, which ``present`` of them are in the
sample, ``outside_genomes`` genomes that are not in the phagedb, each
genome's abundance drawn log-normal, and its reads in proportion to
abundance times length, the outside genomes taking ``outside_share`` of
them.  From the run's seed (``sample_world``) come every genome's bases,
each read's start and strand, the reads' order and their substitutions
(``substitution_rate`` a base).  The check compares the last sample's
count table slot by slot, and every sample's report line by line, with
the plain reference's (``reference/eref.py``).
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from portbench.reference import eref as eref_ref

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
#: ASCII → its complement, for A C G T
COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[list(b"ACGT")] = list(b"TGCA")
#: the unit of the one end-to-end quantity this driver reports
TIME_UNIT = "s"


def _random_bases(rng: np.random.Generator, n: int) -> np.ndarray:
    return ACGT[rng.integers(0, 4, int(n), dtype=np.uint8)]


def _apportion(n: int, weights: np.ndarray) -> np.ndarray:
    """``n`` split in proportion to ``weights``, in whole numbers (largest
    remainders)."""
    share = n * weights / weights.sum()
    out = np.floor(share).astype(np.int64)
    out[np.argsort(out - share, kind="stable")[:n - int(out.sum())]] += 1
    return out


def community(mix: Mapping) -> Dict[str, np.ndarray]:
    """What the mix fixes: the phagedb's reference lengths (log-uniform over
    the mix's range), the present references (indices), the outside
    genomes' lengths (the same law), and the reads of each present
    reference and each outside genome."""
    rng = np.random.default_rng(mix["lengths_seed"])

    def lengths(n):
        lo, hi = np.log(mix["ref_len_min"]), np.log(mix["ref_len_max"])
        return np.exp(rng.uniform(lo, hi, n)).astype(np.int64)

    ref_len = lengths(mix["refs"])
    present = np.sort(rng.choice(mix["refs"], mix["present"], replace=False))
    out_len = lengths(mix["outside_genomes"])
    mu, sigma = mix["abundance_log_mu"], mix["abundance_log_sigma"]
    ab_in = rng.lognormal(mu, sigma, present.size)
    ab_out = rng.lognormal(mu, sigma, out_len.size)
    n_out = round(mix["reads"] * mix["outside_share"])
    return {"ref_len": ref_len, "present": present, "out_len": out_len,
            "reads_in": _apportion(mix["reads"] - n_out, ab_in * ref_len[present]),
            "reads_out": _apportion(n_out, ab_out * out_len)}


def sample_world(mix: Mapping, seed: int) -> Dict[str, np.ndarray]:
    """The phagedb and the sample's reads: ``bases``, the references'
    bases concatenated (uint8 ASCII), ``lengths``, theirs, and ``reads``, a
    (reads, read_len) uint8 ASCII matrix in a random order, each read
    drawn from its genome at a uniform start, half of them as the reverse
    complement, then ``substitution_rate`` of all bases changed to another
    base."""
    c = community(mix)
    read_len = mix["read_len"]
    if min(c["ref_len"].min(), c["out_len"].min()) < read_len:
        raise ValueError("every genome must hold a read")
    rng = np.random.default_rng(seed)
    bases = _random_bases(rng, int(c["ref_len"].sum()))
    pool = np.concatenate([bases, _random_bases(rng, int(c["out_len"].sum()))])
    glen = np.concatenate([c["ref_len"][c["present"]], c["out_len"]])
    first = np.concatenate([np.concatenate([[0], np.cumsum(c["ref_len"])[:-1]])[c["present"]],
                            bases.size + np.concatenate([[0], np.cumsum(c["out_len"])[:-1]])])
    genome = np.repeat(np.arange(glen.size), np.concatenate([c["reads_in"], c["reads_out"]]))
    genome = genome[rng.permutation(genome.size)]
    start = first[genome] + rng.integers(0, glen[genome] - read_len + 1)
    reads = np.lib.stride_tricks.sliding_window_view(pool, read_len)[start]
    del pool
    rc = rng.random(reads.shape[0]) < 0.5
    reads[rc] = COMPLEMENT[reads[rc, ::-1]]
    flat = reads.reshape(-1)
    pos = rng.integers(0, flat.size, round(flat.size * mix["substitution_rate"]))
    code = eref_ref.BASE_CODES[flat[pos]].astype(np.int64)
    flat[pos] = ACGT[(code + rng.integers(1, 4, pos.size)) % 4]
    return {"bases": bases, "lengths": c["ref_len"], "reads": reads}


def _write(path: Path, data) -> None:
    """``data`` into ``path``, on the disk before this returns, so that no
    write-back of it runs on in the measured window."""
    with open(path, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())


def write_fasta(path: Path, bases: np.ndarray, lengths: np.ndarray) -> None:
    """The references as ``>ref<i>`` records, one line of bases each."""
    first = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    parts = []
    for i, (lo, n) in enumerate(zip(first.tolist(), lengths.tolist())):
        parts += [f">ref{i + 1}\n".encode(), memoryview(bases[lo:lo + n]), b"\n"]
    _write(path, b"".join(parts))


def write_fastq_pair(paths: Tuple[Path, Path], reads: np.ndarray) -> None:
    """The reads as fixed-width FASTQ records (``@r<i>``, quality I),
    alternately into the two mate files."""
    n, L = reads.shape
    width = len(str(max(n - 1, 0)))
    digits = (np.arange(n)[:, None] // 10 ** np.arange(width - 1, -1, -1)) % 10 + ord("0")
    cols = [np.full((n, 2), list(b"@r"), np.uint8), digits.astype(np.uint8),
            np.full((n, 1), ord("\n"), np.uint8), reads,
            np.full((n, 3), list(b"\n+\n"), np.uint8), np.full((n, L), ord("I"), np.uint8),
            np.full((n, 1), ord("\n"), np.uint8)]
    records = np.concatenate(cols, axis=1)
    for mate, path in enumerate(paths):
        _write(path, np.ascontiguousarray(records[mate::2]).data)


class Driver:
    """See the module's docstring; the interface is ``harness/cell.py``'s."""

    def __init__(self, config: Mapping, mix: Mapping, seed: int, device: torch.device,
                 tmp: Path):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.tmp = tmp
        self.hits: List[List[str]] = []
        self.table = None
        self.reference_s = 0.0

    def setup(self) -> None:
        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.search import eref, index

        t = time.perf_counter()
        self.world = sample_world(self.mix, self.seed)
        parts = {"world_s": time.perf_counter() - t}
        db = self.tmp / "phagedb.fasta"
        self.fastq = (self.tmp / "r1.fastq", self.tmp / "r2.fastq")
        write_fasta(db, self.world["bases"], self.world["lengths"])
        write_fastq_pair(self.fastq, self.world["reads"])
        parts["write_s"] = time.perf_counter() - t - sum(parts.values())
        kmer = self.config["kmer"]
        self.index = index.build_index(db, kmer["k"], kmer["coder_seed"], save=False)
        parts["index_s"] = time.perf_counter() - t - sum(parts.values())
        self.params = KmerParams(**kmer)
        self.out = self.tmp / "ref_names.txt"
        self._eref = eref
        # the calls into Phase A and Phase B under spans of their own, for
        # the trace; Phase A's table is an output the check compares: keep
        # the one each call makes until the next call starts
        self._phases = eref.count_reads_into_table, eref.search_references
        count, search = self._phases

        def phase_a(*args, **kwargs):
            with record_function("portbench.phase_a"):
                self.table = count(*args, **kwargs)
            return self.table

        def phase_b(*args, **kwargs):
            with record_function("portbench.phase_b"):
                return search(*args, **kwargs)

        eref.count_reads_into_table, eref.search_references = phase_a, phase_b
        self.sample()  # warm: every shape a sample runs
        self.hits.clear()
        parts["warm_s"] = time.perf_counter() - t - sum(parts.values())
        self.setup_parts = parts

    def sample(self) -> None:
        self.table = None
        hits = self._eref.run_search(*self.fastq, self.index, self.params, self.out,
                                     device=self.device)
        self.hits.append([h.line() for h in hits])

    def work(self, samples: int) -> Dict[str, float]:
        lengths = self.world["lengths"]
        k = self.config["kmer"]["k"]
        return {"samples": samples, "reads": samples * self.world["reads"].shape[0],
                "refs": samples * lengths.size, "positions": samples * int(lengths.sum()),
                "kmers": samples * int(np.maximum(lengths - k + 1, 0).sum())}

    def end_to_end(self, metrics: Sequence[Mapping], samples: int,
                   window_s: float) -> Dict[str, float]:
        """The window's seconds a sample, under the name of each of
        ``metrics`` in that unit."""
        return {m["name"]: window_s / samples for m in metrics if m["unit"] == TIME_UNIT}

    def release(self) -> None:
        self._eref.count_reads_into_table, self._eref.search_references = self._phases
        self.index = None

    def check(self, table_bits: Optional[int] = None) -> Dict[str, float]:
        """The last sample's count table, slot by slot, and every sample's
        report (and the file the last one wrote), line by line, against
        the reference's.  ``table_bits`` runs the control in the program's
        place: the reference with a table of fewer bits."""
        kmer = self.config["kmer"]
        reads = torch.from_numpy(eref_ref.BASE_CODES[self.world["reads"]]).to(self.device)
        bases = torch.from_numpy(eref_ref.BASE_CODES[self.world["bases"]]).to(self.device)
        lengths = self.world["lengths"]
        ref_table = eref_ref.count_table(reads, kmer)
        if table_bits is None:
            got = self.table.table if self.table is not None else None
            runs = self.hits + [self.out.read_text().splitlines()]
        else:
            got = eref_ref.count_table(reads, kmer, table_bits)
            runs = [eref_ref.hit_lines(got, bases, lengths, kmer, table_bits)]
        del reads
        table_bad = (eref_ref.mismatched_slots(got, ref_table) if got is not None
                     else ref_table.numel())
        self.table = got = None
        lines = eref_ref.hit_lines(ref_table, bases, lengths, kmer)
        self.info = {"reference_hits": len(lines)}
        # a run's lines missing or extra, or 1 where only their order differs
        bad = sum(len(set(run) ^ set(lines)) or int(run != lines) for run in runs)
        return {"table_slots_wrong": float(table_bad), "report_lines_wrong": float(bad)}

    def close(self) -> None:
        if hasattr(self, "_phases"):
            self.release()
