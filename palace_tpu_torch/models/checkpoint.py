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
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

import torch

from palace_tpu_torch.models.train import TrainState, adam_moments, set_adam_moments
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


def save_train_state(ckpt_dir: str | Path, state: TrainState, max_to_keep: int = 3) -> int:
    """Save ``state`` under its own step number; returns that step."""
    path = Path(ckpt_dir)
    path.mkdir(parents=True, exist_ok=True)
    step = int(state.step)
    mu, nu, count = adam_moments(state)
    payload = {"step": step, "adam_step": count,
               "params": {n: p.detach() for n, p in state.model.params().items()},
               "exp_avg": mu, "exp_avg_sq": nu}
    final = checkpoint_path(path, step)
    tmp = path / f".{final.name}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, final)
    for old in _steps(path)[:-max_to_keep]:
        checkpoint_path(path, old).unlink()
    logger.info("Saved training checkpoint step=%d → %s", step, ckpt_dir)
    return step


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The newest saved step, or None when the directory holds none."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_train_state(ckpt_dir: str | Path, template: TrainState,
                        step: Optional[int] = None) -> Optional[TrainState]:
    """Restore the latest (or a given) checkpoint into ``template``, in
    place, on its device, and return it; None when the directory holds
    no checkpoint."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    saved = torch.load(checkpoint_path(ckpt_dir, step), map_location=template.device,
                       weights_only=True)
    params = template.model.params()
    if set(saved["params"]) != set(params):
        raise ValueError(f"checkpoint {step} of {ckpt_dir} holds other parameters than the "
                         f"template")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(saved["params"][name])
    set_adam_moments(template, saved["exp_avg"], saved["exp_avg_sq"], saved["adam_step"])
    template.step = int(saved["step"])
    logger.info("Restored training checkpoint step=%d from %s", step, ckpt_dir)
    return template
