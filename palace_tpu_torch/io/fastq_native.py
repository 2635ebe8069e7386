"""ctypes bindings of the native FASTQ code-batch loader
(``palace_tpu_torch/native/fastqcodec.cpp``).

eref Phase A streams the reads into the count table on the card (the
reference's extract_ref.cpp:905-1008 does it in pthread byte-range
shards); reading FASTQ line by line in Python is the host's cost there,
so the parse runs in C (zlib's gzread takes .gz and plain files alike)
and yields ``(batch, maxlen)`` uint8 code matrices.

Where the library cannot be built, :func:`available` is False and the
callers take the Python reader (``search/eref.py`` ``_py_read_batches``),
which gives the same batches: pad code 4, the same deterministic
down-sampling, reads longer than a row split with a k-1 overlap.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from palace_tpu_torch.native import _build
from palace_tpu_torch.utils.logging import get_logger

logger = get_logger("palace")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_LOCK = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _LOCK:
        if _lib_tried:
            return _lib
        _lib_tried = True
        path, message = _build.build_all(["fastqcodec"])["fastqcodec"]
        if path is None:
            logger.warning("native FASTQ loader unavailable, using the Python reader: %s",
                           message)
            return None
        lib = ctypes.CDLL(str(path))
        lib.fqc_open.restype = ctypes.c_void_p
        lib.fqc_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.fqc_next_batch.restype = ctypes.c_long
        lib.fqc_next_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_int, ctypes.c_int]
        lib.fqc_close.restype = None
        lib.fqc_close.argtypes = [ctypes.c_void_p]
        lib.fqc_count_bases.restype = ctypes.c_double
        lib.fqc_count_bases.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the loader is built (building it on first call)."""
    return _load() is not None


def count_bases(path: str | Path) -> Optional[int]:
    """Total sequence bases of a FASTQ file; None where the loader is
    unavailable or the file cannot be opened or decompressed."""
    lib = _load()
    if lib is None:
        return None
    n = lib.fqc_count_bases(str(path).encode())
    return None if n < 0 else int(n)


def native_batches(path: str | Path, batch: int, maxlen: int, ratio: int = 100,
                   k: int = 32) -> Iterator[np.ndarray]:
    """Yield (rows ≤ batch, maxlen) uint8 code matrices, the last one
    possibly short.  Raises RuntimeError where the loader is unavailable
    or the input is corrupt."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native FASTQ loader unavailable")
    h = lib.fqc_open(str(path).encode(), int(ratio), int(k))
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            out = np.empty((batch, maxlen), dtype=np.uint8)
            n = lib.fqc_next_batch(h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                   batch, maxlen)
            if n < 0:
                raise RuntimeError(f"fastqcodec parse error on {path}")
            if n == 0:
                return
            yield out[:n]
    finally:
        lib.fqc_close(h)
