"""The port's native FASTQ loader against the JAX package's, on the cases
of tests/test_fastq_native.py: the same code batches from the port's
native loader, its Python reader, JAX ``native_batches`` and JAX
``_py_read_batches``; the same base counts and down-sampling ratios; and
Phase A takes the native loader, with the Python reader where it cannot
be built."""
import gzip
import shutil
from pathlib import Path

import numpy as np
import pytest

from palace_tpu.io import fastq_native as jfastq_native
from palace_tpu.search import eref as jeref
from palace_tpu_torch.io import fastq_native
from palace_tpu_torch.native import _build
from palace_tpu_torch.search import eref

RNG = np.random.default_rng(7)


def _mk_fastq(path: Path, seqs, crlf=False, no_final_newline=False):
    eol = "\r\n" if crlf else "\n"
    text = "".join(f"@read{i} extra{eol}{s}{eol}+{eol}{'I' * len(s)}{eol}"
                   for i, s in enumerate(seqs))
    if no_final_newline:
        text = text.rstrip("\r\n")
    if path.suffix == ".gz":
        path.write_bytes(gzip.compress(text.encode()))
    else:
        path.write_text(text)


def _seqs(n, lens):
    return ["".join(RNG.choice(list("ACGTacgtN"), lens[i % len(lens)])) for i in range(n)]


def _collect(gen):
    rows = list(gen)
    return np.concatenate(rows, axis=0) if rows else np.zeros((0, 0), np.uint8)


def _all_four(fq, batch, maxlen, ratio, k):
    """The batches of the port's native loader and Python reader, and JAX's."""
    args = (fq, batch, maxlen, ratio, k)
    return {"port native": list(fastq_native.native_batches(*args)),
            "port python": list(eref._py_read_batches(*args)),
            "jax native": list(jfastq_native.native_batches(*args)),
            "jax python": list(jeref._py_read_batches(*args))}


def _assert_same_batches(got: dict):
    want = got["jax python"]
    for name, batches in got.items():
        assert [b.shape for b in batches] == [b.shape for b in want], name
        for g, w in zip(batches, want):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_the_loader_builds_where_gxx_is():
    assert fastq_native.available() == (shutil.which("g++") is not None)
    assert jfastq_native.available()
    path, message = _build.build_all(["fastqcodec"])["fastqcodec"]
    assert path is not None and message == ""
    assert path.parent == _build.build_dir() and path.parent.parent.name == "build"


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("ratio", [100, 37])
def test_batches_equal_jax(tmp_path, gz, ratio):
    """Reads longer than a row (500 bp) and shorter than k (40 bp), N and
    lower-case bases, plain and gzip input, with and without down-sampling."""
    seqs = _seqs(300, [150, 151, 40, 500, 149])
    fq = tmp_path / ("r.fastq.gz" if gz else "r.fastq")
    _mk_fastq(fq, seqs)
    got = _all_four(fq, 64, 160, ratio, 32)
    _assert_same_batches(got)
    rows = np.concatenate(got["port native"])
    assert rows.shape[1] == 160 and (rows == 4).any()
    n_long = sum(len(s) > 160 for i, s in enumerate(seqs) if eref._keep_read(i, ratio))
    assert rows.shape[0] > sum(eref._keep_read(i, ratio) for i in range(300)) and n_long > 0


@pytest.mark.parametrize("crlf", [False, True])
@pytest.mark.parametrize("no_final_newline", [False, True])
def test_crlf_and_missing_final_newline(tmp_path, crlf, no_final_newline):
    fq = tmp_path / "c.fastq"
    _mk_fastq(fq, _seqs(17, [150, 31, 220]), crlf=crlf, no_final_newline=no_final_newline)
    _assert_same_batches(_all_four(fq, 8, 160, 100, 32))


@pytest.mark.parametrize("k", [20, 32])
def test_long_read_rows_overlap_by_k_minus_1(tmp_path, k):
    seq = "".join(RNG.choice(list("ACGT"), 1000))
    fq = tmp_path / "long.fastq"
    _mk_fastq(fq, [seq])
    got = _all_four(fq, 4, 160, 100, k)
    _assert_same_batches(got)
    rows = _collect(got["port native"])
    stride = 160 - (k - 1)
    codes = eref.BASE_LUT[np.frombuffer(seq.encode(), np.uint8)]
    for i, row in enumerate(rows):
        part = codes[i * stride:i * stride + 160]
        np.testing.assert_array_equal(row[:len(part)], part)


def test_empty_reads(tmp_path):
    fq = tmp_path / "e.fastq"
    fq.write_text("@r0\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n+\n"
                  "IIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n@r1\n\n+\n\n@r2\nACGT\n+\nIIII\n")
    got = _all_four(fq, 8, 160, 100, 32)
    _assert_same_batches(got)
    rows = _collect(got["port native"])
    assert rows.shape[0] == 3 and (rows[1] == 4).all()


@pytest.mark.parametrize("gz,crlf", [(False, False), (True, True)])
def test_count_bases_equal_jax(tmp_path, gz, crlf):
    seqs = _seqs(50, [150, 75, 301])
    fq = tmp_path / ("b.fastq.gz" if gz else "b.fastq")
    _mk_fastq(fq, seqs, crlf=crlf)
    assert fastq_native.count_bases(fq) == jfastq_native.count_bases(fq) == sum(map(len, seqs))


@pytest.mark.parametrize("target,want", [(2000, 10), (20_000, 100), (10**9, 5_000_000)])
def test_downsample_ratio_equal_jax(tmp_path, target, want):
    fq = tmp_path / "d.fastq"
    _mk_fastq(fq, _seqs(100, [100]))  # 10 kb → ×2 = 20 kb
    assert eref.compute_downsample_ratio(fq, target) == \
        jeref.compute_downsample_ratio(fq, target) == want


def test_corrupt_gzip_raises(tmp_path):
    good = tmp_path / "g.fastq.gz"
    _mk_fastq(good, _seqs(200, [150]))
    bad = tmp_path / "bad.fastq.gz"
    data = good.read_bytes()
    bad.write_bytes(data[: len(data) // 2])
    for pkg in (fastq_native, jfastq_native):
        with pytest.raises(RuntimeError):
            _collect(pkg.native_batches(bad, 64, 160, 100, 32))
        assert pkg.count_bases(bad) is None
    with pytest.raises(FileNotFoundError):
        _collect(fastq_native.native_batches(tmp_path / "missing.fastq", 8, 160, 100, 32))


def test_phase_a_reads_natively_and_falls_back_to_python(tmp_path, monkeypatch):
    """``read_code_batches`` takes the native loader and counts it in
    ``READERS``; where the loader is unavailable it takes the Python
    reader, with the same batches and the same ratio."""
    seqs = _seqs(120, [150, 420, 0, 33])
    fq = tmp_path / "p.fastq"
    _mk_fastq(fq, seqs)
    before = dict(eref.READERS)
    native = list(eref.read_code_batches(fq, 32, 160, 61, 32))
    assert eref.READERS["native"] == before["native"] + 1
    monkeypatch.setattr(fastq_native, "_lib", None)
    monkeypatch.setattr(fastq_native, "_lib_tried", True)
    assert not fastq_native.available() and fastq_native.count_bases(fq) is None
    python = list(eref.read_code_batches(fq, 32, 160, 61, 32))
    assert eref.READERS["python"] == before["python"] + 1
    assert len(native) == len(python) > 1
    for n, p in zip(native, python):
        np.testing.assert_array_equal(n, p)
    assert eref.compute_downsample_ratio(fq, 4000) == jeref.compute_downsample_ratio(fq, 4000)


def test_a_failed_build_reports_the_compiler(tmp_path, monkeypatch):
    """A source the compiler refuses gives its message and no path, and is
    not retried in the process; the callers take the Python paths."""
    src = tmp_path / "broken.cpp"
    src.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setitem(_build.TARGETS, "broken", ("broken.cpp", [], ""))
    monkeypatch.setattr(_build, "source_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "out")
    monkeypatch.setattr(_build, "_RESULTS", {})
    path, message = _build.build_all(["broken"])["broken"]
    if shutil.which("g++") is None:
        assert message == "g++ not found on PATH"
    else:
        assert path is None and "no_such_header_here.h" in message and "g++ exit" in message
    assert _build.build_all(["broken"])["broken"] == (path, message)
