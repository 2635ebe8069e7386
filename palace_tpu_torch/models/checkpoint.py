"""Checkpoint and resume of the GCN training state, the counterpart of
``palace_tpu/models/checkpoint.py`` (orbax there).

One file a step, ``<ckpt_dir>/<step>.pt``: the parameters under their JAX
names, Adam's ``exp_avg``/``exp_avg_sq`` and step count, and the train
step.  A save writes to a temporary name and renames it into place, so
an interrupted save leaves the last good checkpoint; the newest
``max_to_keep`` stay.  A restore reads with ``torch.load(...,
weights_only=True)`` onto the template's device: a checkpoint holds
tensors and numbers only and never runs code when read (unlike a
reference ``.pt``, which ``gcn.load_torch_state_dict`` unpickles).

Under a mesh (``TrainState.mesh``) every rank calls both: a save gathers
the whole state over the model group, rank 0 writes the same file a
one-device ``fit`` writes, and every rank waits for it; a restore reads
the whole state on every rank and keeps its shards under the template's
specs, whatever layout wrote the file (orbax's restore into the target's
sharding).
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from palace_tpu_torch.models.train import TrainState, adam_moments, set_adam_moments
from palace_tpu_torch.parallel.distributed import global_array_from_local
from palace_tpu_torch.parallel.mesh import local_shard
from palace_tpu_torch.utils.logging import get_logger

logger = get_logger("palace")

_FILE = re.compile(r"^(\d+)\.pt$")


def _steps(ckpt_dir: str | Path) -> List[int]:
    path = Path(ckpt_dir)
    if not path.is_dir():
        return []
    return sorted(int(m.group(1)) for f in path.iterdir() if (m := _FILE.match(f.name)))


def checkpoint_path(ckpt_dir: str | Path, step: int) -> Path:
    return Path(ckpt_dir) / f"{step}.pt"


def _whole(state: TrainState, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The whole tensors from this rank's shards under the state's specs
    (the model axis is the only one a parameter is split over)."""
    if state.mesh is None:
        return tensors
    return {name: global_array_from_local(t, state.mesh, state.specs[name])
            for name, t in tensors.items()}


def gather_train_state(state: TrainState) -> dict:
    """The whole state as a checkpoint holds it; under a mesh a collective
    of the model group, which every rank must call."""
    mu, nu, count = adam_moments(state)
    return {"step": int(state.step), "adam_step": count,
            "params": _whole(state, {n: p.detach() for n, p in state.model.params().items()}),
            "exp_avg": _whole(state, mu), "exp_avg_sq": _whole(state, nu)}


def save_train_state(ckpt_dir: str | Path, state: TrainState, max_to_keep: int = 3) -> int:
    """Save ``state`` under its own step number; returns that step.  Under
    a mesh every rank calls it and returns once rank 0 has written."""
    payload = gather_train_state(state)
    step = payload["step"]
    mesh = state.mesh
    if mesh is None or mesh.rank == 0:
        _write(Path(ckpt_dir), step, payload, max_to_keep)
    if mesh is not None and dist.is_initialized():
        dist.barrier()
    return step


def _write(path: Path, step: int, payload: dict, max_to_keep: int) -> None:
    path.mkdir(parents=True, exist_ok=True)
    final = checkpoint_path(path, step)
    tmp = path / f".{final.name}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, final)
    for old in _steps(path)[:-max_to_keep]:
        checkpoint_path(path, old).unlink()
    logger.info("Saved training checkpoint step=%d → %s", step, path)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The newest saved step, or None when the directory holds none."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_train_state(ckpt_dir: str | Path, template: TrainState,
                        step: Optional[int] = None) -> Optional[TrainState]:
    """Restore the latest (or a given) checkpoint into ``template``, in
    place, on its device, and return it; None when the directory holds
    no checkpoint.  Under the template's mesh each rank keeps its shards."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    saved = torch.load(checkpoint_path(ckpt_dir, step), map_location=template.device,
                       weights_only=True)
    params = template.model.params()
    if set(saved["params"]) != set(params):
        raise ValueError(f"checkpoint {step} of {ckpt_dir} holds other parameters than the "
                         f"template")

    def shard(tensors):  # this rank's shards, as tensors of their own
        if template.mesh is None:
            return tensors
        return {n: local_shard(t, template.specs[n], template.mesh)
                .clone(memory_format=torch.contiguous_format) for n, t in tensors.items()}

    with torch.no_grad():
        for name, t in shard(saved["params"]).items():
            params[name].copy_(t)
    set_adam_moments(template, shard(saved["exp_avg"]), shard(saved["exp_avg_sq"]),
                     saved["adam_step"])
    template.step = int(saved["step"])
    logger.info("Restored training checkpoint step=%d from %s", step, ckpt_dir)
    return template
