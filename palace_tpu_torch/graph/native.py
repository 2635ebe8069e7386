"""Run the native C++ BAM runtime (``palace_tpu_torch/native/bamgraph.cpp``).

The reference's graph builder and depth pass are native C++ (htslib /
samtools); the port's is the self-contained ``palace_native`` program,
built with ``g++`` at first use (``native/_build.py``).  Where it cannot
be built, the stages take the Python versions in
``palace_tpu_torch.graph.{builder,depth}``, which write the same files
(tests/test_torch_graph.py holds both to the JAX package's).  ``RUNS``
counts the runs of each.
"""
from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Dict, Optional

from palace_tpu_torch.native import _build
from palace_tpu_torch.utils.logging import get_logger

logger = get_logger("palace")

#: stage runs by route: ``graph.native``, ``graph.python``, ``depth.native``,
#: ``depth.python``
RUNS: Dict[str, int] = {"graph.native": 0, "graph.python": 0,
                        "depth.native": 0, "depth.python": 0}


def ensure_native_binary() -> Optional[Path]:
    """The ``palace_native`` program, built on first use; None where it
    cannot be built."""
    path, message = _build.build_all(["palace_native"])["palace_native"]
    if path is None:
        logger.warning("palace_native unavailable, using the Python BAM path: %s", message)
    return path


def native_graph(bam: str | Path, fastg_fai: str | Path, out: str | Path,
                 avg_depth: float) -> bool:
    binary = ensure_native_binary()
    if binary is None:
        return False
    subprocess.run([str(binary), "graph", str(bam), str(fastg_fai), str(out), str(avg_depth)],
                   check=True)
    return True


def native_depth(bam: str | Path, out: str | Path) -> bool:
    binary = ensure_native_binary()
    if binary is None:
        return False
    subprocess.run([str(binary), "depth", str(bam), str(out)], check=True)
    return True


def build_graph(bam: str | Path, fastg_fai: str | Path, out: str | Path,
                avg_depth: float, prefer_native: bool = True) -> None:
    """Graph stage entry point: the native program, else the Python builder."""
    if prefer_native and native_graph(bam, fastg_fai, out, avg_depth):
        RUNS["graph.native"] += 1
        return
    from palace_tpu_torch.graph.builder import build_graph_from_bam, write_graph_output

    graph = build_graph_from_bam(bam, fastg_fai, avg_depth)
    write_graph_output(out, graph)
    RUNS["graph.python"] += 1


def compute_depth_file(bam: str | Path, out: str | Path,
                       prefer_native: bool = True) -> None:
    """Depth stage entry point: the native program, else the Python pass."""
    if prefer_native and native_depth(bam, out):
        RUNS["depth.native"] += 1
        return
    from palace_tpu_torch.graph.depth import compute_depth

    compute_depth(bam).write_text(out)
    RUNS["depth.python"] += 1
