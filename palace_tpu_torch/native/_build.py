"""Build the port's host C++ sources with ``g++`` at first use.

``fastqcodec.cpp``, eref Phase A's FASTQ loader, becomes a shared library
loaded with ctypes (``io/fastq_native.py``); ``bamgraph.cpp`` becomes the
``palace_native`` program of the graph and depth stages
(``graph/native.py``).  Each is compiled with ``CXX_FLAGS`` into
``build/palace_tpu_torch_native/`` beside the package, named by a hash of
its source and flags, so an edited source is rebuilt and a stale build is
never loaded.  The sources not built yet compile at once, one ``g++``
process each.

Nothing is built at import time.  Where ``g++`` or zlib's headers are
missing, a build gives the compiler's message instead of a path, and the
callers take their Python versions, which write the same output.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CXX_FLAGS = ["-O3", "-std=c++17", "-Wall", "-pthread"]
LIBS = ["-lz"]

# target → (source, extra flags, file suffix)
TARGETS = {
    "fastqcodec": ("fastqcodec.cpp", ["-shared", "-fPIC"], ".so"),
    "palace_native": ("bamgraph.cpp", [], ""),
}

#: target → (artifact or None, the compiler's message where it failed)
_RESULTS: Dict[str, Tuple[Optional[Path], str]] = {}
_LOCK = threading.Lock()


def source_dir() -> Path:
    return Path(__file__).resolve().parent


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "palace_tpu_torch_native"


def artifact_path(name: str) -> Path:
    source, extra, suffix = TARGETS[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + extra + LIBS).encode())
    h.update((source_dir() / source).read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}{suffix}"


def build_all(names: List[str] | None = None) -> Dict[str, Tuple[Optional[Path], str]]:
    """Compile the named targets (default: all) that are not built yet, one
    ``g++`` a source, all started together.  Returns target → (path, "")
    where it is built, (None, the compiler's message) where it is not; a
    failed target is not tried again in this process."""
    names = list(TARGETS) if names is None else names
    with _LOCK:
        todo = [n for n in names if n not in _RESULTS and not artifact_path(n).exists()]
        for n in names:
            if n not in _RESULTS and n not in todo:
                _RESULTS[n] = (artifact_path(n), "")
        cxx = shutil.which("g++")
        procs = []
        if todo and cxx is None:
            for n in todo:
                _RESULTS[n] = (None, "g++ not found on PATH")
            todo = []
        if todo:
            build_dir().mkdir(parents=True, exist_ok=True)
        for n in todo:
            source, extra, _ = TARGETS[n]
            out = artifact_path(n)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, *extra, "-o", str(tmp), str(source_dir() / source), *LIBS]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for n, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                _RESULTS[n] = (None, f"g++ exit {proc.returncode}: {log.strip()}")
                continue
            os.replace(tmp, out)
            _RESULTS[n] = (out, "")
        return {n: _RESULTS[n] for n in names}
