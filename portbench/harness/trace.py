"""The traced window: ``torch.profiler`` over it, read back from its trace.

The profiler records the host's operations and ranges and the device's
kernels, copies and memsets; its Chrome trace is written to a temporary
file, read, and deleted.  From it come the device's busy time (the union
of its intervals within the window), kernel time by name, and the idle
gaps, each named by what the host was doing at its middle: the innermost
operation of the main thread, or, where the main thread is in none but
the harness's span of the whole call (waiting on another thread, or in
Python), the innermost of another thread.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
#: the harness's span of one whole timed call
CALL_SPAN = "portbench.sample"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}
TOP = 10


@dataclass
class Trace:
    window_us: Tuple[float, float] = (0.0, 0.0)
    device: List[Tuple[str, float, float]] = field(default_factory=list)   # name, start, end
    host: List[Tuple[str, float, float]] = field(default_factory=list)     # main thread
    other: Dict[object, List[Tuple[str, float, float]]] = field(default_factory=dict)  # by thread

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window_us
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_s(self, patterns: Iterable[str]) -> Optional[float]:
        """Device seconds of the kernels whose names hold any of ``patterns``
        within the window, or None where none ran."""
        pats = tuple(patterns)
        lo, hi = self.window_us
        hit = [e - s for name, s, e in self.device
               if s >= lo and e <= hi and any(p in name for p in pats)]
        return sum(hit) / 1e6 if hit else None

    def device_ops(self) -> List[List]:
        """The device operations that took most time: [[name, seconds], ...]."""
        by: Dict[str, float] = defaultdict(float)
        lo, hi = self.window_us
        for name, s, e in self.device:
            if s >= lo and e <= hi:
                by[_short(name)] += (e - s) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """Idle seconds on the device within the window, summed by what the
        host was doing at each gap's middle (see the module's docstring)."""
        lo, hi = self.window_us
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        mids = [((s + e) / 2, e - s) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        main = _innermost(self.host, mids)
        others = [_innermost(events, mids) for _, events in sorted(self.other.items(), key=str)]
        by: Dict[str, float] = defaultdict(float)
        for i, (_, gap) in enumerate(mids):
            m = main[i]
            o = next((names[i] for names in others if names[i] is not None), None)
            if m is not None and m != CALL_SPAN:
                name = m
            elif o is not None:
                name = "other thread: " + o
            else:
                name = m or "Python, no operation"
            by["host: " + _short(name)] += gap / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def _innermost(events: List[Tuple[str, float, float]],
               mids: List[Tuple[float, float]]) -> List[Optional[str]]:
    """For each time in ``mids`` (ascending), the name of the innermost of
    ``events`` (nested ranges) that holds it, or None: one sweep, events
    by start (a parent before its child), a stack of those still open."""
    events = sorted((h for h in events if h[0] != WINDOW), key=lambda h: (h[1], -h[2]))
    stack: List[Tuple[str, float, float]] = []
    out: List[Optional[str]] = []
    i = 0
    for mid, _ in mids:
        while i < len(events) and events[i][1] <= mid:
            while stack and stack[-1][2] < events[i][1]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def _short(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


class Profiler:
    """``with Profiler(on):`` traces the block when ``on``; ``read()`` then
    gives its ``Trace``.  The block is marked as the window on the main
    thread."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.device = device
        self._prof = None
        self._mark = None

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        self._mark.__exit__(*exc)
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return parse(events)


def parse(events: List[dict]) -> Trace:
    """A Chrome trace's events → the window, the device's intervals and the
    main thread's host operations."""
    trace = Trace()
    main = None
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == WINDOW:
            trace.window_us = (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
            main = (ev.get("pid"), ev.get("tid"))
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0))
        if cat in DEVICE_CATS:
            trace.device.append((ev.get("name", ""), s, e))
        elif cat in HOST_CATS:
            tid = (ev.get("pid"), ev.get("tid"))
            events = trace.host if tid == main else trace.other.setdefault(tid, [])
            events.append((ev.get("name", ""), s, e))
    return trace
