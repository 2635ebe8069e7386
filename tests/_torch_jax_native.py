"""The JAX package's native artifacts, built once into a private directory
for the port's tests.

``palace_tpu`` builds ``native/palace_native`` and ``libfastqcodec.so`` on
demand with ``make -C native``, and the Makefile writes each artifact in
place, so under xdist one worker can exec a binary that another worker
is still writing ("Text file busy").  Here the Makefile and its two
sources are copied into ``build/jax_native/<hash of the sources>``, made
there, and the directory is published with ``os.replace`` under an
``fcntl.flock``: concurrent workers build once and never see a
half-written file.  The fixture ``jax_native_dir`` points
``PALACE_NATIVE_DIR`` at it, which ``palace_tpu._native.find_artifact``
reads before the source tree; without g++ or make it leaves the variable
unset, and JAX behaves as it always does.

Import the fixture into a test module that runs JAX's driver or binary:
``from _torch_jax_native import jax_native_dir  # noqa: F401``.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("Makefile", "bamgraph.cpp", "fastqcodec.cpp")
ARTIFACTS = ("palace_native", "libfastqcodec.so")


def _complete(path: Path) -> bool:
    return all((path / name).exists() for name in ARTIFACTS)


def private_native_dir(build_root: Path = ROOT / "build" / "jax_native") -> Optional[Path]:
    """The directory holding JAX's two artifacts built from ``native/``'s
    current sources, made on first call; None without g++ or make, or
    when the build fails (JAX then takes its Python routes)."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        return None
    src = ROOT / "native"
    digest = hashlib.sha256(b"".join((src / n).read_bytes() for n in SOURCES)).hexdigest()[:16]
    out = build_root / digest
    if _complete(out):
        return out
    build_root.mkdir(parents=True, exist_ok=True)
    with open(build_root / f".{digest}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _complete(out):  # another worker built it while this one waited
            return out
        tmp = Path(tempfile.mkdtemp(prefix=f".{digest}-", dir=build_root))
        try:
            for name in SOURCES:
                shutil.copy(src / name, tmp / name)
            subprocess.run(["make", "-C", str(tmp)], check=True, capture_output=True)
        except subprocess.CalledProcessError:
            shutil.rmtree(tmp, ignore_errors=True)
            return None
        os.replace(tmp, out)
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_native_dir():
    """``PALACE_NATIVE_DIR`` set to the private build for the module's
    tests and fixtures, restored after them."""
    path = private_native_dir()
    with pytest.MonkeyPatch.context() as mp:
        if path is not None:
            mp.setenv("PALACE_NATIVE_DIR", str(path))
        yield path
