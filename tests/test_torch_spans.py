"""The port's spans (``palace_tpu_torch.utils.timers.StageTimer``) on the
CPU: with no profiler a span records into its registry and opens no
profiler range; under a profiler it is also a range of the same name in
the trace, nested in its parent, on any thread the profiler traces; the
registry loses no record across threads; and the scorer and eref record
each of their spans as often as their calls make them."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from palace_tpu_torch.config import KmerParams
from palace_tpu_torch.io.fasta import reverse_complement, write_fasta
from palace_tpu_torch.models import gcn, scoring
from palace_tpu_torch.search import eref, index
from palace_tpu_torch.utils import timers
from palace_tpu_torch.utils.timers import Metrics, StageTimer

CPU = [ProfilerActivity.CPU]


class _CountingRange:
    """The span's profiler range class that counts its instances."""

    made = 0

    def __init__(self, name, real=torch._C._profiler._RecordFunctionFast):
        type(self).made += 1
        self._inner = real(name)

    def __enter__(self):
        return self._inner.__enter__()

    def __exit__(self, *exc):
        return self._inner.__exit__(*exc)


@pytest.fixture
def counting_range(monkeypatch):
    _CountingRange.made = 0
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _CountingRange)
    return _CountingRange


@pytest.fixture
def metrics(monkeypatch):
    """A fresh ``GLOBAL_METRICS`` for the spans the program opens."""
    fresh = Metrics()
    monkeypatch.setattr(timers, "GLOBAL_METRICS", fresh)
    return fresh


def _trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def _spans(events, name):
    return [e for e in events if e["name"] == name]


def _inside(child, parent):
    return (child["tid"] == parent["tid"] and child["ts"] >= parent["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def test_span_without_a_profiler_records_and_opens_no_range(counting_range):
    m = Metrics()
    assert not timers.profiling()
    with StageTimer("t.block", 3, unit="rows", metrics=m) as span:
        time.sleep(0.002)
        span.items += 2
    with StageTimer("t.block", 1, unit="rows", metrics=m):
        pass
    rec = m.stages["t.block"]
    assert rec.calls == 2 and rec.items == 6 and rec.unit == "rows"
    assert rec.seconds >= 0.002 and span.seconds >= 0.002
    assert counting_range.made == 0
    # the same span under a profiler does open one range: the count above sees ranges
    with profile(activities=CPU):
        with StageTimer("t.block", metrics=m):
            pass
    assert counting_range.made == 1 and m.stages["t.block"].calls == 3


def test_span_is_a_range_of_its_name_nested_in_its_parent(tmp_path):
    m = Metrics()
    with profile(activities=CPU) as prof:
        assert timers.profiling()
        with StageTimer("t.outer", metrics=m):
            with StageTimer("t.inner", metrics=m):
                time.sleep(0.02)
            time.sleep(0.005)
    assert not timers.profiling()
    events = _trace(prof, tmp_path)
    [outer], [inner] = _spans(events, "t.outer"), _spans(events, "t.inner")
    assert _inside(inner, outer) and outer["dur"] > inner["dur"]
    for ev in (outer, inner):
        seconds = m.stages[ev["name"]].seconds
        assert abs(ev["dur"] / 1e6 - seconds) <= max(0.1 * seconds, 200e-6), ev["name"]


def test_gate_reads_true_on_every_thread_under_all_thread_profiling(tmp_path):
    """The span's gate is the process-wide flag ``torch.autograd.profiler.
    _is_profiler_enabled``: ``torch.autograd._profiler_enabled()`` reads False
    on every thread here, so a gate on it would drop the worker's span.
    A torch that drops the flag fails here."""
    m, seen = Metrics(), {}

    def worker():
        seen["gate"] = timers.profiling()
        with StageTimer("t.worker", metrics=m):
            time.sleep(0.005)

    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=CPU, experimental_config=config) as prof:
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join(timeout=30)
        main_tid = threading.get_native_id()
    assert not thread.is_alive() and seen["gate"] is True
    [span] = _spans(_trace(prof, tmp_path), "t.worker")
    assert span["tid"] != main_tid and m.stages["t.worker"].calls == 1


def test_threads_recording_under_one_name_lose_nothing():
    m, threads, each = Metrics(), 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(each):
                m.record("t.shared", 0.5, items=1.0, unit="rows")

        pool = [threading.Thread(target=worker) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    rec = m.stages["t.shared"]
    assert rec.calls == threads * each and rec.items == threads * each
    assert rec.seconds == 0.5 * threads * each


# -- the scorer's spans -------------------------------------------------------------------

SMALL = gcn.GCNConfig(fnode_num=8, gcn_dim=16, cnn_dim=8, fc_dim=10)


def _pooled(feats):
    """K1's (B, 3·64·64) features summed over 8 × 8 blocks of 3-mer codes:
    the (B, 3·8·8) width of the small config."""
    return feats.reshape(-1, 3, 8, 8, 8, 8).sum(dim=(3, 5)).reshape(-1, 3 * 64)


@pytest.fixture
def small_scorer(monkeypatch):
    encode = scoring.features_from_bytes
    monkeypatch.setattr(scoring, "features_from_bytes", lambda *rows: _pooled(encode(*rows)))
    params = gcn.init_params(torch.Generator().manual_seed(0), SMALL)
    rng = np.random.default_rng(1)
    contigs = [(f"c{i}", "".join(rng.choice(list("ACGT"), size=600 + 50 * i)))
               for i in range(5)]
    return params, contigs


def test_score_sequences_records_each_span(small_scorer, metrics):
    params, contigs = small_scorer
    got = scoring.score_sequences(params, contigs, SMALL, batch_size=2, device="cpu")
    assert [name for name, _ in got] == [name for name, _ in contigs]
    calls = {name: rec.calls for name, rec in metrics.stages.items()}
    assert calls == {"score.model": 1, "gcn.score": 1, "score.host_batch": 3,
                     "score.host_wait": 3, "score.dispatch": 3, "gcn.lift": 3, "gcn.sage": 3,
                     "gcn.conv": 3, "gcn.fc": 3, "score.fetch": 1, "score.results": 1}
    st = metrics.stages
    assert st["gcn.score"].items == st["score.results"].items == st["score.fetch"].items == 5
    assert st["score.dispatch"].items == 6 and st["score.host_wait"].items == 3
    assert st["score.host_batch"].items == sum(len(s) for _, s in contigs) + 4
    main = ("score.host_wait", "score.dispatch", "score.fetch", "score.results")
    assert sum(st[n].seconds for n in main) <= st["gcn.score"].seconds
    assert sum(st[f"gcn.{p}"].seconds for p in ("lift", "sage", "conv", "fc")) \
        <= st["score.dispatch"].seconds


def test_score_spans_nest_in_the_trace(small_scorer, metrics, tmp_path):
    """On the main thread: the forward's parts in ``score.dispatch``, and it
    and the wait in ``gcn.score``."""
    params, contigs = small_scorer
    with profile(activities=CPU) as prof:
        scoring.score_sequences(params, contigs, SMALL, batch_size=2, device="cpu")
    events = _trace(prof, tmp_path)
    [call] = _spans(events, "gcn.score")
    dispatch, waits = _spans(events, "score.dispatch"), _spans(events, "score.host_wait")
    assert len(dispatch) == len(waits) == 3
    assert all(_inside(e, call) for e in dispatch + waits + _spans(events, "score.fetch"))
    for part in ("gcn.lift", "gcn.sage", "gcn.conv", "gcn.fc"):
        spans = _spans(events, part)
        assert len(spans) == 3 and all(any(_inside(s, d) for d in dispatch) for s in spans)


# -- eref's spans -------------------------------------------------------------------------

@pytest.fixture
def mini_world(tmp_path):
    """``tests/test_torch_eref.py``'s world: reads tiled three times from ref
    B of three random 3 kb refs."""
    rng = np.random.default_rng(5)
    refs_ = {name: "".join(rng.choice(list("ACGT"), size=3000))
             for name in ("phageA", "phageB", "phageC")}
    db = tmp_path / "phagedb.fasta"
    write_fasta(db, list(refs_.items()))
    reads = [refs_["phageB"][off:][i:i + 100] for off in (0, 3, 7)
             for i in range(0, 3000 - off - 100 + 1, 10)]
    fq1, fq2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
    for path, rows in ((fq1, reads), (fq2, [reverse_complement(r) for r in reads])):
        path.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in enumerate(rows)))
    return db, fq1, fq2, len(reads)


EREF_SPANS = ("eref.run_search", "eref.table_create", "eref.downsample_ratio",
              "eref.count_reads", "eref.read", "eref.pack", "eref.add_packed",
              "eref.count_sync", "eref.scan_refs", "eref.upload", "eref.plan", "eref.scan",
              "eref.scan_check", "eref.scan_fetch", "eref.verdicts", "eref.write")


def test_run_search_records_each_span(mini_world, metrics, tmp_path, monkeypatch):
    db, fq1, fq2, n_reads = mini_world
    monkeypatch.setattr(eref, "READ_BATCH", 64)  # several batches a file, the last short
    idx = index.build_index(db, k=16, coder_seed=1, save=False)
    params = KmerParams(k=16, window=100)
    hits = eref.run_search(fq1, fq2, idx, params, tmp_path / "ref_names.txt", device="cpu")
    assert [h.ref_index for h in hits] == [2]
    st = metrics.stages
    assert set(EREF_SPANS) <= set(st) and "eref.scan_launch" not in st
    assert "eref.hit_filter" not in st  # one device, no shard
    batches = 2 * -(-n_reads // 64)
    chunks = len(eref.plan_chunks(idx))
    calls = {name: st[name].calls for name in EREF_SPANS}
    assert calls == {**{name: 1 for name in EREF_SPANS}, "eref.read": batches + 2,
                     "eref.pack": batches, "eref.add_packed": batches, "eref.scan": chunks,
                     "eref.scan_check": chunks, "eref.scan_fetch": chunks,
                     "eref.verdicts": chunks}
    assert st["eref.count_reads"].items == st["eref.read"].items == st["eref.pack"].items \
        == 2 * n_reads
    assert st["eref.add_packed"].items == batches * 64  # pad rows included
    assert st["eref.downsample_ratio"].items == 100 * n_reads
    assert st["eref.verdicts"].items == st["eref.scan_refs"].items == idx.n_refs
    assert st["eref.write"].items == 1 and st["eref.run_search"].items == 1
    children = {"eref.count_reads": ("eref.read", "eref.pack", "eref.add_packed",
                                     "eref.count_sync"),
                "eref.scan_refs": ("eref.plan", "eref.upload", "eref.scan", "eref.scan_fetch",
                                   "eref.verdicts")}
    for parent, parts in children.items():
        assert sum(st[n].seconds for n in parts) <= st[parent].seconds, parent
