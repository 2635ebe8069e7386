"""The ranks of tests/test_torch_eref_parallel.py.

Each rank is a process started by ``torch.multiprocessing.spawn``
(``chip_smoke.spawn_ranks``): it runs on one CPU thread under gloo with a
``file://`` store, imports no JAX, does the job's eref work on each mesh
layout the job names, and saves what it found to ``<out>/rank<r>.pt`` for
the test process, which holds it against JAX and against the port on one
device.
"""
from __future__ import annotations

import builtins
import io
import os
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from palace_tpu_torch.config import KmerParams, PalaceConfig
from palace_tpu_torch.models import gcn, scoring
from palace_tpu_torch.ops.count_table import ShardedCountTable
from palace_tpu_torch.parallel import distributed, mesh as pmesh
from palace_tpu_torch.pipeline.driver import run_pipeline
from palace_tpu_torch.search import eref
from palace_tpu_torch.search.index import build_index

#: the search worlds' settings (tests/test_kmer_search.py's)
K = 16
PARAMS = KmerParams(k=K, window=100, hit_ratio=0.9, perfect_hit_ratio=0.85)
#: the scorer of the pipeline's world (tests/test_torch_pipeline.py's)
SCORE_CFG = gcn.GCNConfig(gcn_dim=16, cnn_dim=8, fc_dim=8)


def table_job(mesh, job) -> dict:
    """A k = 16 table from the job's hash batches (one with a ``valid``
    mask), its low-complexity batch and its packed reads: this rank's shard,
    its first slot and the lookups of the job's probe."""
    table = ShardedCountTable.create(mesh, K)
    for hashes, valid in job["hash_batches"]:
        table.add_kmers(torch.from_numpy(hashes), None if valid is None else torch.from_numpy(valid))
    for packed, mask in job["packed"]:
        table.add_packed(packed, mask, job["perm"], job["kmer_k"])
    return dict(shard=table.table.numpy().copy(), lo=table.lo,
                lookup=table.lookup(torch.from_numpy(job["probe"])).numpy())


def overflow_job(mesh, job) -> dict:
    """Phase A of the reads of tests/test_kmer_search.py's overflow policy
    test into a sharded table."""
    index = build_index(job["overflow_db"], k=K, coder_seed=1, save=False)
    table = eref.count_reads_into_table(job["overflow_fastqs"], index, PARAMS, mesh=mesh)
    return dict(shard=table.table.numpy().copy(), lo=table.lo)


def search_job(mesh, job, out: Path) -> dict:
    """``search_references`` on a table counted under the mesh, and
    ``run_search(mesh=...)`` into a file named by the layout and this rank."""
    index = build_index(job["db"], k=K, coder_seed=1, save=False)
    table = eref.count_reads_into_table(job["fastqs"], index, PARAMS, mesh=mesh)
    hits = eref.search_references(table, index, PARAMS)
    name = out / f"ref_names_{mesh.dp}x{mesh.mp}_rank{mesh.rank}.txt"
    run = eref.run_search(*job["fastqs"], index, PARAMS, name, mesh=mesh)
    return dict(hits=[h.line() for h in hits], run=[h.line() for h in run])


def distributed_job(mesh, job, out: Path) -> dict:
    """``run_search_distributed`` over the job's two FASTQ files of unequal
    sizes, counting the updates this rank made."""
    index = build_index(job["db"], k=K, coder_seed=1, save=False)
    calls = []
    add = ShardedCountTable.add_packed

    def counted(self, *args, **kw):
        calls.append(kw.get("local"))
        return add(self, *args, **kw)

    ShardedCountTable.add_packed = counted
    try:
        hits = eref.run_search_distributed(job["dist_fastqs"], index, PARAMS,
                                           out / f"dist_rank{mesh.rank}.txt", mesh)
    finally:
        ShardedCountTable.add_packed = add
    return dict(hits=[h.line() for h in hits], updates=calls)


def _watch_writes(root: str, seen: list):
    """Record every file this process opens for writing, or directory it
    makes, under ``root``; returns a function that stops recording."""
    root = os.path.realpath(root)
    real_open, real_mkdir = builtins.open, os.mkdir

    def under(path) -> bool:
        return isinstance(path, (str, os.PathLike)) and \
            os.path.realpath(path).startswith(root + os.sep)

    def opener(file, mode="r", *args, **kw):
        if any(c in mode for c in "wax+") and under(file):
            seen.append(("open", str(file)))
        return real_open(file, mode, *args, **kw)

    def mkdir(path, *args, **kw):
        if under(path):
            seen.append(("mkdir", str(path)))
        return real_mkdir(path, *args, **kw)

    builtins.open = io.open = opener
    os.mkdir = mkdir

    def stop():
        builtins.open = io.open = real_open
        os.mkdir = real_mkdir

    return stop


def pipeline_job(mesh, job) -> dict:
    """``run_pipeline(cfg, mesh=...)`` on the job's world with a scorer
    that runs ``score_fasta(mesh=...)``; every write this rank makes under
    the world's directory is recorded."""
    params = job["pipeline_params"]

    def scorer(fasta, out_path):
        return scoring.score_fasta(params, fasta, out_path, SCORE_CFG, batch_size=8,
                                   device="cpu", mesh=mesh)

    writes: list = []
    stop = _watch_writes(job["pipeline_root"], writes)
    try:
        final = run_pipeline(PalaceConfig.from_file(job["pipeline_cfg"]), scorer=scorer,
                             device="cpu", mesh=mesh)
    finally:
        stop()
    return dict(final=str(final), writes=writes)


def run(rank: int, world: int, store: str, out: str, job: dict) -> None:
    """One rank: each layout of ``job["model_parallel"]``, then the job's
    layout-free parts on the last."""
    torch.set_num_threads(1)
    assert not any(m.split(".")[0] in ("jax", "palace_tpu") for m in sys.modules), \
        "a rank imported JAX"
    assert distributed.initialize(f"file://{store}", world, rank, device="cpu")
    out = Path(out)
    results: dict = {"layouts": {}}
    try:
        for mp in job["model_parallel"]:
            mesh = pmesh.make_mesh(model_parallel=mp, device="cpu")
            got = dict(index=mesh.index, table=table_job(mesh, job))
            if job.get("search"):
                got["overflow"] = overflow_job(mesh, job)
                got["search"] = search_job(mesh, job, out)
            results["layouts"][(mesh.dp, mesh.mp)] = got
        if job.get("search"):
            results["distributed"] = distributed_job(mesh, job, out)
        if job.get("pipeline"):
            results["pipeline"] = pipeline_job(mesh, job)
    finally:
        dist.destroy_process_group()
    torch.save(results, out / f"rank{rank}.pt")
