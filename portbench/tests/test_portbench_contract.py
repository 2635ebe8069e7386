"""BENCHMARK.json against the benchmark's contract, every name found by
name, and the result line a run prints (tiny cells on the CPU)."""
import json
import re
import subprocess
import sys

import pytest

from portbench.harness import cell
from portbench.tests import _tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = _tiny.bench()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((cell.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["source"].startswith("https://")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] == 0.25 and "workloads" not in E2E["setup_s"]
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_it_must():
    for name in CELLS:
        e2e = [m for m in BENCH["end_to_end"] if cell.applies(m, name)]
        per = [m for m in BENCH["per_layer"] if cell.applies(m, name)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per, name
    for m in BENCH["per_layer"]:
        moved = E2E[m["moves"]]
        for name in m["workloads"]:
            assert name in CELLS and cell.applies(moved, name), (m["name"], name)


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    parts = cell.find_cell(BENCH, name)
    assert callable(cell.load_driver(parts["mix"]["driver"]))
    assert parts["limits"]["checks"] and parts["limits"]["control"]
    for spec in parts["limits"]["checks"].values():
        assert spec["limit"] >= 0


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(name):
    assert callable(cell.load_reader(name))


@pytest.mark.parametrize("kind", ["score", "eref"])
def test_result_line(kind):
    res = _tiny.run(_tiny.parts(kind))
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell.applies(m, _tiny.parts(kind)["cell"]["name"])}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(res)


def test_traced_result_line():
    res = _tiny.run(_tiny.parts("eref"), trace=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert {"eref.phase_a_s", "eref.phase_b_s"} <= set(res["metrics"])
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_without_a_card_prints_no_result(tmp_path):
    proc = subprocess.run([sys.executable, str(cell.BENCH / "run.py"), "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""
