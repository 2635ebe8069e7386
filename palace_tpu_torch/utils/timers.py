"""Per-stage wall-clock and item counters, and the span that feeds them.

``Metrics`` is a registry of stage records; ``GLOBAL_METRICS`` is the
process-wide one the stages report into (contigs scored, reads counted,
references scanned, each pipeline step, and the parts of each).
``StageTimer`` is the port's one kind of span: it times its block on the
host clock into a registry and, while a torch profiler runs, also opens a
profiler range of the same name, so the span shows in the profiler's
trace on the clock of the card's kernels and copies.  Spans
nest on their thread: a span's parent is the span that encloses it.  The
pipeline driver writes the registry's summary to ``{prefix}_metrics.json``.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass
class StageRecord:
    seconds: float = 0.0
    items: float = 0.0
    unit: str = "items"
    calls: int = 0

    @property
    def throughput(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


@dataclass
class Metrics:
    """Stage records by name; ``record`` may be called from any thread."""

    stages: Dict[str, StageRecord] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def record(self, stage: str, seconds: float, items: float = 0.0,
               unit: str = "items") -> None:
        with self._lock:
            rec = self.stages.setdefault(stage, StageRecord(unit=unit))
            rec.seconds += seconds
            rec.items += items
            rec.unit = unit
            rec.calls += 1

    def summary(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "seconds": round(rec.seconds, 4),
                    "items": rec.items,
                    "unit": rec.unit,
                    "throughput": round(rec.throughput, 3),
                    "calls": rec.calls,
                }
                for name, rec in self.stages.items()
            }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2, sort_keys=True)


GLOBAL_METRICS = Metrics()


def profiling() -> bool:
    """Whether a torch profiler runs in this process.  Read from the flag
    ``torch.autograd.profiler`` sets for every kind of profiler, which every
    thread sees: ``torch.autograd._profiler_enabled()`` reads False on a
    thread the profiler does not trace, and on every thread under
    ``_ExperimentalConfig(profile_all_threads=True)``."""
    return _autograd_profiler._is_profiler_enabled


class StageTimer:
    """``with StageTimer(stage, items, unit):`` times the block on the host
    clock and adds it to ``metrics`` (``GLOBAL_METRICS`` by default) under
    ``stage``, with ``items`` of ``unit``, whether or not a profiler runs;
    while one runs (``profiling()``), the block is also a profiler range
    named ``stage``, and the time includes opening and closing it.
    ``items`` may be set on the span inside the block, where the count is
    known only there; ``seconds`` holds the block's time after it.

    The range is ``torch._C._profiler._RecordFunctionFast``, the C
    implementation of ``torch.profiler.record_function``'s range (the
    trace's category is ``cpu_op``): ``record_function`` opens and closes
    its range through two operator calls, each of which releases the
    interpreter lock, so under a profiler every span's edges would hand the
    lock to any thread waiting for it (the scorer's host step), and the
    caller's wait for it back would fall between spans."""

    __slots__ = ("stage", "items", "unit", "metrics", "seconds", "_t0", "_range")

    def __init__(self, stage: str, items: float = 0.0, unit: str = "items",
                 metrics: Optional[Metrics] = None):
        self.stage = stage
        self.items = items
        self.unit = unit
        self.metrics = metrics if metrics is not None else GLOBAL_METRICS
        self.seconds = 0.0
        self._range = None

    def __enter__(self) -> "StageTimer":
        self._t0 = time.perf_counter()
        if profiling():
            self._range = torch._C._profiler._RecordFunctionFast(self.stage)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.seconds = time.perf_counter() - self._t0
        self.metrics.record(self.stage, self.seconds, self.items, self.unit)
        return False
