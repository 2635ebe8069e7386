"""The ranks of tests/test_torch_parallel.py.

Each rank is a process started by ``torch.multiprocessing.spawn``: it
runs on one CPU thread under gloo with a ``file://`` store, imports no
JAX, works through the job it is given on each mesh layout the job names,
and saves what it found to ``<out>/rank<r>.pt`` for the test process,
which holds it against JAX and against the port on one device.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from palace_tpu_torch.models import checkpoint, gcn, scoring, train
from palace_tpu_torch.parallel import distributed, mesh as pmesh

#: JAX's small architecture of tests/test_train_and_sharding.py:
#: pnode_d 192 wide, d1 43·64 = 2,752 rows
TRAIN_CFG = gcn.GCNConfig(fnode_num=8)
TRAIN_CFG0 = dataclasses.replace(TRAIN_CFG, drop_rate=0.0)
#: the scorer needs K1's 3·64·64 features: 64 f-nodes, narrow elsewhere
SCORE_CFG = gcn.GCNConfig(gcn_dim=16, cnn_dim=8, fc_dim=8)
LR = 1e-3


def score_params(seed: int) -> dict:
    """``SCORE_CFG`` parameters from a seed, d1 and d2 scaled (×3, ×30) so
    the probabilities spread, as tests/test_torch_scoring.py does."""
    p = gcn.init_params(torch.Generator().manual_seed(seed), SCORE_CFG)
    p["d1.w"], p["d2.w"] = p["d1.w"] * 3.0, p["d2.w"] * 30.0
    return p


def _np(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def _tensors(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def _train_step(mesh, job) -> dict:
    """One step at ``TRAIN_CFG0`` from the job's parameters on this rank's
    block of the job's batch: the global loss, the whole updated state and
    the shapes of this rank's shards."""
    state = train.init_train_state(_tensors(job["params"]), TRAIN_CFG0, LR, mesh=mesh)
    x_p, x_f, y = (pmesh.data_sharding(torch.from_numpy(job[k]), mesh)
                   for k in ("x_p", "x_f", "y"))
    _, loss = train.train_step(state, x_p, x_f, y, None, TRAIN_CFG0, LR)
    whole = checkpoint.gather_train_state(state)
    return dict(loss=float(loss), params=_np(whole["params"]), specs=dict(state.specs),
                shapes={n: tuple(p.shape) for n, p in state.model.params().items()})


def _fit(mesh, job) -> dict:
    state, losses = train.fit(job["feats"], job["labels"], TRAIN_CFG, epochs=2,
                              batch_size=job["batch"], learning_rate=LR, seed=job["seed"],
                              device="cpu", mesh=mesh)
    return dict(losses=losses, params=_np(checkpoint.gather_train_state(state)["params"]))


def _score(mesh, job, out: Path) -> dict:
    """``score_sequences`` and ``score_fasta`` on the job's contigs; the file
    is named by the layout (``1x1``: one rank, no mesh)."""
    params = score_params(job["score_seed"])
    probs = scoring.score_sequences(params, job["contigs"], SCORE_CFG,
                                    batch_size=job["score_batch"], device="cpu", mesh=mesh)
    layout = "1x1" if mesh is None else f"{mesh.dp}x{mesh.mp}"
    n = scoring.score_fasta(params, job["fasta"], out / f"node_scores_{layout}.out", SCORE_CFG,
                            batch_size=job["score_batch"], device="cpu", mesh=mesh)
    return dict(probs=probs, n=n)


def _global_arrays(mesh, job) -> dict:
    """``global_array_from_local`` from each rank's block under each spec."""
    whole = torch.from_numpy(job["global"])
    return {spec: distributed.global_array_from_local(pmesh.local_shard(whole, spec, mesh)
                                                      .clone(), mesh, spec).numpy()
            for spec in (("data", None), (None, "model"), ("data", "model"))}


def _checkpoint(ckpt: Path, job) -> dict:
    """A step under (1, mp) saved; the file restored under (mp, 1)."""
    world = dist.get_world_size()
    wide = pmesh.make_mesh(model_parallel=world, device="cpu")
    state = train.init_train_state(_tensors(job["params"]), TRAIN_CFG0, LR, mesh=wide)
    x_p, x_f, y = (torch.from_numpy(job[k]) for k in ("x_p", "x_f", "y"))
    train.train_step(state, x_p, x_f, y, None, TRAIN_CFG0, LR)
    step = checkpoint.save_train_state(ckpt, state)
    saved = checkpoint.gather_train_state(state)
    tall = pmesh.make_mesh(model_parallel=1, device="cpu")
    template = train.init_train_state({k: torch.zeros(v.shape) for k, v in job["params"].items()},
                                      TRAIN_CFG0, LR, mesh=tall)
    restored = checkpoint.gather_train_state(checkpoint.restore_train_state(ckpt, template))
    return dict(step=step, layouts=((wide.dp, wide.mp), (tall.dp, tall.mp)),
                saved={k: _np(saved[k]) for k in ("params", "exp_avg", "exp_avg_sq")},
                restored={k: _np(restored[k]) for k in ("params", "exp_avg", "exp_avg_sq")},
                adam_step=(saved["adam_step"], restored["adam_step"]))


def run(rank: int, world: int, store: str, out: str, job: dict) -> None:
    """One rank: every mesh layout of ``job["model_parallel"]``, then the
    one-device references (rank 0) and the job's extras."""
    torch.set_num_threads(1)
    assert not any(m.split(".")[0] in ("jax", "palace_tpu") for m in sys.modules), \
        "a rank imported JAX"
    assert distributed.initialize(f"file://{store}", world, rank, device="cpu")
    results: dict = {"layouts": {}}
    try:
        for mp in job["model_parallel"]:
            mesh = pmesh.make_mesh(model_parallel=mp, device="cpu")
            got = dict(coords=mesh.coords, rank=mesh.rank,
                       train_step=_train_step(mesh, job),
                       global_arrays=_global_arrays(mesh, job))
            if job.get("fit"):
                got["fit"] = _fit(mesh, job)
            if job.get("score"):
                got["score"] = _score(mesh, job, Path(out))
            results["layouts"][(mesh.dp, mesh.mp)] = got
        if job.get("checkpoint"):
            results["checkpoint"] = _checkpoint(Path(out) / "ckpt", job)
        if rank == 0 and job.get("fit"):
            results["fit_one_device"] = _fit(None, job)
        if rank == 0 and job.get("score"):
            results["score_one_rank"] = _score(None, job, Path(out))
    finally:
        dist.destroy_process_group()
    torch.save(results, Path(out) / f"rank{rank}.pt")
