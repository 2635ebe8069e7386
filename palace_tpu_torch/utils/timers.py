"""Per-stage wall-clock and item counters.

``Metrics`` is a registry of stage records; ``GLOBAL_METRICS`` is the
process-wide one the scoring stage reports into (contigs scored and the
seconds they took)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class StageRecord:
    seconds: float = 0.0
    items: float = 0.0
    unit: str = "items"
    calls: int = 0


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


GLOBAL_METRICS = Metrics()
