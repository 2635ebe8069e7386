"""Contig-scoring stage: FASTA → ``node_scores.out``.

The reference stage (phage_scoring.py main of the original PALACE)
encodes contigs in a process pool and runs torch inference in batch-64
chunks, writing ``contig\\tP(phage)`` lines (phage_scoring.py:205-218).

Here the host concatenates each batch's bytes on a background thread
while the device encodes and scores the batch before it: encoding reads
the ragged bytes in one kernel call
(``ops.kernels.transition_features_bytes``), and the GCN forward runs
the SAGE-rounds and conv-head kernels.  Results
stay on the device until the last batch is queued, then come back in
one copy.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from palace_tpu_torch.device import resolve_device
from palace_tpu_torch.io.fasta import iter_fasta
from palace_tpu_torch.models.gcn import DEFAULT_CONFIG, GCNConfig, GCNScorer
from palace_tpu_torch.ops.encoder import byte_batch, features_from_bytes
from palace_tpu_torch.parallel.collectives import gather_blocks
from palace_tpu_torch.parallel.mesh import Mesh, shard_params_for_gcn
from palace_tpu_torch.utils.logging import get_logger
from palace_tpu_torch.utils.timers import GLOBAL_METRICS

logger = get_logger("palace")

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "f16": torch.float16}


def resolve_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """Config dtype string → torch dtype, or None for the float32 default
    (no cast: parameters are used as loaded)."""
    if not name or name in ("float32", "f32", "fp32"):
        return None
    if name not in _DTYPES:
        raise ValueError(f"unsupported score dtype {name!r}")
    return _DTYPES[name]


def _scorer(params: Mapping[str, torch.Tensor], cfg: GCNConfig, dtype: Optional[torch.dtype],
            device: torch.device, mesh: Optional[Mesh] = None) -> GCNScorer:
    """The scorer on ``device`` in ``dtype``; under a mesh whose model axis
    is wider than one, holding this rank's shards of the parameters."""
    if mesh is not None and mesh.mp > 1:
        params, _ = shard_params_for_gcn(params, mesh)
    model = GCNScorer(params, cfg).to(device)
    return model.to(dtype) if dtype is not None else model


def _host_batch(seqs: Sequence[str], device: torch.device) -> List[torch.Tensor]:
    """Sequences → their ``byte_batch`` on the host, written straight into
    pinned memory when it is bound for a card."""
    return list(byte_batch(seqs, pin_memory=device.type == "cuda"))


def _device_batch(host: List[torch.Tensor], device: torch.device) -> List[torch.Tensor]:
    """The byte batch on ``device``; copies to a card do not wait."""
    return [t.to(device, non_blocking=True) for t in host]


def score_codes(params: Mapping[str, torch.Tensor], seqs: Sequence[str],
                cfg: GCNConfig = DEFAULT_CONFIG, dtype: Optional[torch.dtype] = None,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Score one batch of raw sequences → (B,) P(phage) on ``device``."""
    dev = resolve_device(device)
    model = _scorer(params, cfg, dtype, dev)
    with torch.inference_mode():
        batch = _device_batch(_host_batch(seqs, dev), dev)
        return model.score_features(features_from_bytes(*batch))


def _batches(items: Iterable[Tuple[str, str]], size: int) -> Iterator[List[Tuple[str, str]]]:
    chunk: List[Tuple[str, str]] = []
    for item in items:
        chunk.append(item)
        if len(chunk) == size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def score_sequences(
    params: Mapping[str, torch.Tensor],
    named_seqs: Iterable[Tuple[str, str]],
    cfg: GCNConfig = DEFAULT_CONFIG,
    batch_size: int = 64,
    dtype: Optional[torch.dtype] = None,
    fuse_k: int = 1,
    device: str | torch.device = "cuda",
    mesh: Optional[Mesh] = None,
) -> List[Tuple[str, float]]:
    """Score (name, seq) pairs → (name, P(phage)), in input order.

    Every batch is padded to ``batch_size`` with ``"AAAA"`` rows.
    ``dtype`` (e.g. ``torch.bfloat16``) casts the parameters once and
    each feature batch.  ``fuse_k`` is accepted for compatibility with
    ``palace_tpu`` and does not change the result: batches are dispatched
    one by one.  Runs on the card unless ``device="cpu"``.

    With a ``mesh`` (``parallel.mesh.make_mesh``) every rank is given the
    whole input and runs on ``mesh.device`` (``device`` is not read):
    ``batch_size`` rounds up to a multiple of ``mesh.dp``, each data rank
    encodes and scores its contiguous block of every batch (K1 → lifts →
    K2 → K3 → head), the parameters are sharded over the model axis when
    it is wider than one, and the probabilities are gathered over the data
    group, so every rank returns the same list.
    """
    if fuse_k < 1:
        raise ValueError("fuse_k must be >= 1")
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    if mesh is not None:
        batch_size = -(-batch_size // mesh.dp) * mesh.dp
        dev = mesh.device
        lo, hi = (mesh.coords[0] * batch_size // mesh.dp,
                  (mesh.coords[0] + 1) * batch_size // mesh.dp)
    else:
        dev = resolve_device(device)
        lo, hi = 0, batch_size
    model = _scorer(params, cfg, dtype, dev, mesh)
    t0 = time.perf_counter()

    def prepare(chunk):
        names = [name for name, _ in chunk]
        seqs = [seq for _, seq in chunk]
        seqs += ["A" * 4] * (batch_size - len(seqs))
        return names, _host_batch(seqs[lo:hi], dev)

    def dispatch(names, host):
        feats = features_from_bytes(*_device_batch(host, dev))
        return names, model.score_features(feats, mesh=mesh)

    # a single background thread prepares batch i+1 while this thread ships
    # and dispatches batch i; the device runs behind both
    pending: List[Tuple[List[str], torch.Tensor]] = []
    with torch.inference_mode(), ThreadPoolExecutor(max_workers=1) as pool:
        fut = None
        for chunk in _batches(named_seqs, batch_size):
            nxt = pool.submit(prepare, chunk)
            if fut is not None:
                pending.append(dispatch(*fut.result()))
            fut = nxt
        if fut is not None:
            pending.append(dispatch(*fut.result()))
        if pending:
            probs = torch.stack([p for _, p in pending]).float()
            if mesh is not None:
                probs = gather_blocks(probs, mesh, "data", 1)
            probs = probs.cpu().numpy()
        else:
            probs = np.zeros((0, batch_size), np.float32)
    results: List[Tuple[str, float]] = []
    for (names, _), row in zip(pending, probs):
        results.extend((nm, float(p)) for nm, p in zip(names, row[: len(names)]))
    GLOBAL_METRICS.record("gcn.score", time.perf_counter() - t0,
                          items=len(results), unit="contigs")
    return results


def write_scores(path: str | Path, scores: Sequence[Tuple[str, float]]) -> None:
    """``contig\\tprob`` lines in the reference's format: the float32
    repr, no trailing newline (phage_scoring.py:213-216)."""
    with open(path, "w") as fh:
        for i, (name, p) in enumerate(scores):
            if i:
                fh.write("\n")
            fh.write(f"{name}\t{np.float32(p)}")


def read_scores(path: str | Path) -> Dict[str, float]:
    out: Dict[str, float] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                out[parts[0]] = float(parts[1])
    return out


def score_fasta(
    params: Mapping[str, torch.Tensor],
    fasta_path: str | Path,
    out_path: str | Path,
    cfg: GCNConfig = DEFAULT_CONFIG,
    batch_size: int = 64,
    dtype: Optional[torch.dtype] = None,
    fuse_k: int = 1,
    device: str | torch.device = "cuda",
    mesh: Optional[Mesh] = None,
) -> int:
    """Full stage: assembly FASTA → node_scores.out.  Returns #contigs.
    Under a ``mesh`` (see ``score_sequences``) every rank reads the FASTA
    and rank 0 alone writes the file."""
    scores = score_sequences(params, iter_fasta(fasta_path), cfg, batch_size,
                             dtype=dtype, fuse_k=fuse_k, device=device, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        write_scores(out_path, scores)
        logger.info("Scored %d contigs → %s", len(scores), out_path)
    return len(scores)
