"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``palace_tpu_torch/csrc/`` is compiled on first use
into its own shared library with a plain C interface, for ``sm_90a``
(Hopper).  The libraries go into ``build/palace_tpu_torch_kernels/``
beside the package, named by a hash of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded.  All
sources are compiled at once, one ``nvcc`` process each.

Nothing here runs at import time: the package imports on a host
without the CUDA toolkit, and only a launch on a CUDA tensor builds.

``LAUNCHES`` counts, per kernel, the launches its wrapper made
(``ops/kernels.py`` adds one where it launches, and nowhere else), so
a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

# kernel name → (source file, C entry point, argtypes).  Every pointer and
# the stream are c_void_p, a byte count c_int64; each entry returns
# cudaGetLastError() as int.
KERNELS = {
    "transition_counts": ("transition_counts.cu", "palace_transition_features",
                          [_P, _P, _P, _P, _P, _I, _L, _I, _P]),
    "transition_counts_codes": ("transition_counts.cu", "palace_transition_counts_codes",
                                [_P, _P, _P, _P, _I, _L, _I, _P]),
    "sage_rounds": ("sage_rounds.cu", "palace_sage_rounds",
                    [_P, _P, _P, _P, _I, _I, _P]),
    "conv_head": ("conv_head.cu", "palace_conv_layer",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "good_windows": ("good_windows.cu", "palace_good_windows",
                     [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "scan_chunk": ("good_windows.cu", "palace_scan_chunk",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "scan_hits": ("good_windows.cu", "palace_scan_hits",
                  [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _L, _L, _P]),
    "hit_filter": ("good_windows.cu", "palace_hit_filter", [_P, _L, _P, _I, _I, _P]),
    "window_hits": ("good_windows.cu", "palace_window_hits",
                    [_P, _P, _I, _I, _I, _I, _I, _P]),
    "count_codes": ("count_codes.cu", "palace_count_codes",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
PTXAS_LOG: Dict[str, str] = {}

_ENTRIES: Dict[str, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def csrc_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "csrc"


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "palace_tpu_torch_kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)")


def _library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(csrc_dir().glob("*.cuh")) + [csrc_dir() / source]:
        h.update(f.read_bytes())
    return build_dir() / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(names: List[str] | None = None) -> Dict[str, Path]:
    """Compile the sources of the named kernels (default: all) that are not
    built yet, one ``nvcc`` a source, all started together.  Returns name →
    library (kernels of one source share it).  Raises ``RuntimeError``
    with the compiler's output on failure."""
    names = list(KERNELS) if names is None else names
    out = {n: _library_path(KERNELS[n][0]) for n in names}
    todo = sorted({KERNELS[n][0] for n in names if not out[n].exists()})
    procs = []
    if todo:
        build_dir().mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        for src in todo:
            lib = _library_path(src)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc_dir() / src)]
            procs.append((src, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {src} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for n in names:
        log = out[n].with_suffix(".log")
        PTXAS_LOG[n] = log.read_text() if log.exists() else ""
    return out


def entry(name: str):
    """The C entry point of kernel ``name``, building it on first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        with _LOCK:
            fn = _ENTRIES.get(name)
            if fn is None:
                source, symbol, argtypes = KERNELS[name]
                lib = ctypes.CDLL(str(build_all([name])[name]))
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _ENTRIES[name] = fn
    return fn


def kernels_built() -> bool:
    """True when every kernel's library is built for the current sources."""
    return all(_library_path(src).exists() for src, _, _ in KERNELS.values())


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
