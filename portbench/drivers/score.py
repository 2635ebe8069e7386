"""Driver ``score``: an assembly's contigs scored by whole calls of
``palace_tpu_torch.models.scoring.score_sequences``, one a sample, at the
configuration's batch size and dtype.

The mix gives the contigs' lengths (drawn from its own ``lengths_seed``,
so every run seed does the same work); bases and gap positions come from
the run's seed.  The check compares every sample's probabilities with
the plain reference's (``reference/gcn.py``).
"""
from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.harness import weights
from portbench.reference import gcn as gcn_ref

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
#: the unit of the one end-to-end quantity this driver reports
RATE_UNIT = "contigs/s"


def _random_bases(rng: np.random.Generator, n: int) -> np.ndarray:
    return ACGT[rng.integers(0, 4, int(n), dtype=np.uint8)]


def _gc_bases(rng: np.random.Generator, gc: np.ndarray) -> np.ndarray:
    """A base for each GC share in ``gc``: A below (1-gc)/2, C below 1/2, G
    below (1+gc)/2, T above."""
    u = rng.random(gc.size, dtype=np.float32)
    code = (u >= (1 - gc) / 2).astype(np.uint8) + (u >= 0.5) + (u >= (1 + gc) / 2)
    return ACGT[code]


def assembly_lengths(mix: Mapping) -> np.ndarray:
    """The log-normal lengths of the mix's ordinary contigs."""
    rng = np.random.default_rng(mix["lengths_seed"])
    n = mix["contigs"] - len(mix["special"])
    lengths = rng.lognormal(np.log(mix["median_len"]), mix["sigma"], n)
    return np.clip(lengths, mix["min_len"], mix["max_len"]).astype(np.int64)


def assembly_contigs(mix: Mapping, seed: int) -> List[Tuple[str, str]]:
    """Contigs named as metaSPAdes names them: the mix's special contigs
    (each a list of ``[unit, count]`` parts: ``"random"`` bases, or the
    unit repeated), then the log-normal ones, each with its own GC share
    drawn from ``gc_range``, every ``gap_every``-th with ``gap_len`` N at a
    random place; sorted longest first and named
    ``NODE_<i>_length_<len>``."""
    rng = np.random.default_rng(seed)
    lengths = assembly_lengths(mix)
    specials = []
    for parts in mix["special"]:
        specials.append("".join(_random_bases(rng, n).tobytes().decode() if unit == "random"
                                else unit * n for unit, n in parts))
    gc = rng.uniform(*mix["gc_range"], lengths.size).astype(np.float32)
    pool = _gc_bases(rng, np.repeat(gc, lengths)).tobytes().decode()
    gaps = rng.integers(0, lengths - mix["gap_len"])
    seqs, lo = [], 0
    for i, n in enumerate(lengths.tolist()):
        s = pool[lo:lo + n]
        lo += n
        if i % mix["gap_every"] == 0:
            g = int(gaps[i])
            s = s[:g] + "N" * mix["gap_len"] + s[g + mix["gap_len"]:]
        seqs.append(s)
    seqs = sorted(specials + seqs, key=len, reverse=True)
    return [(f"NODE_{i + 1}_length_{len(s)}", s) for i, s in enumerate(seqs)]


class Driver:
    """See the module's docstring; the interface is ``harness/cell.py``'s."""

    def __init__(self, config: Mapping, mix: Mapping, seed: int, device: torch.device,
                 tmp: Path):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.results: List[list] = []
        self.reference_s = 0.0

    def setup(self) -> None:
        from palace_tpu_torch.models import gcn, scoring

        t = time.perf_counter()
        self._score = scoring.score_sequences
        self.contigs = assembly_contigs(self.mix, self.seed)
        parts = {"contigs_s": time.perf_counter() - t}
        self.params = weights.gcn_params(self.config["gcn"], self.seed, self.device)
        step = max(1, len(self.contigs) // weights.HEAD_CONTIGS)
        head = [s for _, s in self.contigs[::step]][:weights.HEAD_CONTIGS]
        r = time.perf_counter()
        weights.centre_head(self.params, head, self.config["gcn"], self.device)
        # the head is set from the plain reference's activations: its
        # seconds are the reference's, not the set-up's
        self.reference_s = time.perf_counter() - r
        parts["weights_s"] = time.perf_counter() - t - sum(parts.values())
        self.cfg = gcn.GCNConfig(**self.config["gcn"])
        self.dtype = scoring.resolve_dtype(self.config["score"]["dtype"])
        self.batch = self.config["score"]["batch_size"]
        self.sample()  # warm: every shape a sample runs
        self.results.clear()
        parts["warm_s"] = time.perf_counter() - t - sum(parts.values())
        parts["reference_s"] = self.reference_s
        self.setup_parts = parts

    def sample(self) -> None:
        self.results.append(self._score(self.params, self.contigs, self.cfg, self.batch,
                                        dtype=self.dtype, device=self.device))

    def work(self, samples: int) -> Dict[str, float]:
        n = len(self.contigs)
        return {"samples": samples, "contigs": samples * n,
                "batches": samples * math.ceil(n / self.batch), "batch_rows": self.batch}

    def end_to_end(self, metrics: Sequence[Mapping], samples: int,
                   window_s: float) -> Dict[str, float]:
        """Contigs scored a second over the window, under the name of each
        of ``metrics`` in that unit."""
        rate = samples * len(self.contigs) / window_s
        return {m["name"]: rate for m in metrics if m["unit"] == RATE_UNIT}

    def release(self) -> None:
        """The program keeps no state between calls; the weights are the
        benchmark's own and the reference reads them."""

    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """Every sample's probabilities against the reference's: samples
        with a contig missing, misnamed or out of order, and the largest and
        mean absolute gap.  ``control`` ("tf32", "fp8") puts the reference
        computed in that precision in the program's place."""
        names = [n for n, _ in self.contigs]
        seqs = [s for _, s in self.contigs]
        ref = gcn_ref.probabilities(self.params, seqs, self.config["gcn"], self.device)
        self.info = {"reference_p_quantiles": np.quantile(ref, [0, 0.01, 0.5, 0.99, 1]).tolist()}
        runs = self.results if control is None else [list(zip(names, gcn_ref.probabilities(
            self.params, seqs, self.config["gcn"], self.device, control).tolist()))]
        wrong, gaps = 0, []
        for res in runs:
            if [n for n, _ in res] != names:
                wrong += 1
                continue
            gaps.append(np.abs(np.array([p for _, p in res], np.float64) - ref))
        gap = np.concatenate(gaps) if gaps else np.array([np.inf])
        return {"samples_misnamed": float(wrong),
                "prob_gap_max": float(gap.max()), "prob_gap_mean": float(gap.mean())}

    def close(self) -> None:
        pass
