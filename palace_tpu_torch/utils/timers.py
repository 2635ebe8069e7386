"""Per-stage wall-clock and item counters.

``Metrics`` is a registry of stage records; ``GLOBAL_METRICS`` is the
process-wide one the stages report into (contigs scored, reads counted,
references scanned, and each pipeline step), and ``StageTimer`` is a
context manager that feeds it.  The pipeline driver writes its summary
to ``{prefix}_metrics.json``."""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional


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
    stages: Dict[str, StageRecord] = field(default_factory=dict)

    def record(self, stage: str, seconds: float, items: float = 0.0,
               unit: str = "items") -> None:
        rec = self.stages.setdefault(stage, StageRecord(unit=unit))
        rec.seconds += seconds
        rec.items += items
        rec.unit = unit
        rec.calls += 1

    def summary(self) -> Dict[str, dict]:
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


@contextmanager
def StageTimer(stage: str, items: float = 0.0, unit: str = "items",
               metrics: Optional[Metrics] = None) -> Iterator[None]:
    m = metrics if metrics is not None else GLOBAL_METRICS
    t0 = time.perf_counter()
    try:
        yield
    finally:
        m.record(stage, time.perf_counter() - t0, items=items, unit=unit)
