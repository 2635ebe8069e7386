"""The readers of the program's spans: their arithmetic on a synthetic
context, and their metrics in the traced result line of each tiny cell on
the CPU."""
from types import SimpleNamespace

import pytest

from portbench.harness import cell
from portbench.tests import _tiny

BENCH = _tiny.bench()

#: the readers of the program's spans: metric, span, the work it is divided by, scale
SPAN_READERS = [
    ("score_bf16.host_batch_ms", "score.host_batch", "batches", 1e3),
    ("score_bf16.host_wait_ms", "score.host_wait", "batches", 1e3),
    ("score_bf16.dispatch_ms", "score.dispatch", "batches", 1e3),
    ("score.host_wait_ms", "score.host_wait", "batches", 1e3),
    ("eref.downsample_s", "eref.downsample_ratio", "samples", 1.0),
    ("eref.reader_s", "eref.read", "samples", 1.0),
    ("eref.pack_s", "eref.pack", "samples", 1.0),
    ("eref.add_packed_s", "eref.add_packed", "samples", 1.0),
    ("eref.verdicts_s", "eref.verdicts", "samples", 1.0),
]


@pytest.mark.parametrize("name,span,per,scale", SPAN_READERS)
def test_span_reader(name, span, per, scale):
    """A span's growth over the window: ms a batch, s a sample; None where
    the span never ran (a program without it) or no work was counted."""
    read = cell.load_reader(name)
    work = {"samples": 4, "batches": 160, "contigs": 80_000}
    ctx = SimpleNamespace(program={f"seconds:{span}": 2.5, "seconds:other": 9.0}, work=work)
    assert read(ctx) == pytest.approx(scale * 2.5 / work[per])
    assert read(SimpleNamespace(program={"seconds:other": 9.0}, work=work)) is None
    assert read(SimpleNamespace(program={f"seconds:{span}": 2.5}, work={})) is None


@pytest.mark.parametrize("kind,dtype", [("eref", "float32"), ("score", "float32"),
                                        ("score", "bfloat16")])
def test_traced_result_line_reads_the_programs_spans(kind, dtype):
    """Every per-layer metric read from the program's spans is in the traced
    line of its cell."""
    p = _tiny.parts(kind, dtype)
    res = _tiny.run(p, trace=True)
    want = {m["name"] for m in BENCH["per_layer"]
            if m["source"] == "program_span" and cell.applies(m, p["cell"]["name"])}
    assert want and want <= set(res["metrics"])
    assert all(res["metrics"][n]["value"] > 0 for n in want)
