"""Stage engine with artifact checkpointing.

The reference driver runs six steps with skip-if-output-exists
semantics (``check_skip_step`` / ``file_exists_with_content``,
palace:121-149) and exit-on-error (``handle_error``, palace:152-160).
Every stage is resumable because all state is on disk.

This re-design makes that pattern first-class: a ``Stage`` declares its
output artifacts; the ``StageRunner`` skips a stage whose artifacts all
exist non-empty, times every stage into the global metrics registry,
and raises on failure so the driver stops exactly like
``set -euo pipefail``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from palace_tpu_torch.utils.logging import get_logger, show_progress
from palace_tpu_torch.utils.timers import GLOBAL_METRICS, Metrics, StageTimer

logger = get_logger("palace")


def file_exists_with_content(path: str | Path) -> bool:
    """``[ -s "$1" ]`` (palace:122-124)."""
    try:
        return os.path.getsize(path) > 0
    except OSError:
        return False


class StageSkipped(Exception):
    """Raised internally to mark a stage skipped (not an error)."""


@dataclass
class Stage:
    name: str
    run: Callable[[], None]
    outputs: Sequence[str | Path] = field(default_factory=list)
    #: outputs that may legitimately be empty (e.g. blast file when no refs,
    #: palace:533 ``touch``) — existence alone is enough to skip.
    allow_empty: bool = False

    def is_complete(self) -> bool:
        if not self.outputs:
            return False
        if self.allow_empty:
            return all(os.path.exists(p) for p in self.outputs)
        return all(file_exists_with_content(p) for p in self.outputs)


@dataclass
class StageResult:
    name: str
    skipped: bool
    seconds: float


class StageRunner:
    def __init__(self, metrics: Optional[Metrics] = None, force: bool = False):
        self.metrics = metrics if metrics is not None else GLOBAL_METRICS
        self.force = force
        self.results: List[StageResult] = []

    def run(self, stage: Stage, step: int = 0, total: int = 0) -> StageResult:
        if total:
            show_progress(step, total, stage.name)
        if not self.force and stage.is_complete():
            logger.warning(
                "Output for %s already exists. Skipping %s", stage.name, stage.name
            )
            result = StageResult(stage.name, skipped=True, seconds=0.0)
            self.results.append(result)
            return result
        for out in stage.outputs:
            Path(out).parent.mkdir(parents=True, exist_ok=True)
        try:
            with StageTimer(f"stage:{stage.name}", metrics=self.metrics) as span:
                stage.run()
        except Exception:
            logger.error("Stage %s failed", stage.name)
            raise
        dt = span.seconds
        logger.log(25, "Stage %s completed in %.2fs", stage.name, dt)
        result = StageResult(stage.name, skipped=False, seconds=dt)
        self.results.append(result)
        return result

    def run_all(self, stages: Sequence[Stage]) -> List[StageResult]:
        total = len(stages)
        for i, stage in enumerate(stages, 1):
            self.run(stage, step=i, total=total)
        return self.results
