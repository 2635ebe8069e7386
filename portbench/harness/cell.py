"""One run of one cell: set-up, the window, the check, the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration (``configs/<config>.json``) and traffic
(``mixes/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``);
its check's limits are ``limits/<cell>.json``; each per-layer metric is
read by ``metrics/<metric>.py``.  A new kind of traffic is a new driver
file, a new mix, a new metric a new reader: no file here changes.

A driver file defines ``Driver(config, mix, seed, device, tmp)`` with
``setup()`` (inputs from the mix and the seed, the warm sample),
``sample()`` (one whole timed call), ``work(samples)`` (counts of what
the samples did, for the readers), ``end_to_end(metrics, samples,
window_s)`` (the value of each of the cell's end-to-end ``metrics``, by
its name), ``release()`` (the program's state freed), ``check(**control)``
(the numbers the limits hold, from the plain reference; with the
control's arguments, the control's) and ``close()``; its ``reference_s``
is the set-up's seconds spent in the plain reference, which ``setup_s``
leaves out.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Mapping

import torch

from portbench.harness import trace as tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
#: top-level module names that must not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "palace_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(bench: Mapping, name: str) -> Dict[str, dict]:
    """The cell's entry, configuration, mix and limits, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {"cell": cell, "config": load_json(ROOT / entry["file"]),
            "mix": load_json(BENCH / "mixes" / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json")}


def applies(metric: Mapping, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_file(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under the benchmark's folder."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read(ctx)``."""
    return load_file("metrics", name).read


def load_driver(name: str) -> Callable:
    """``drivers/<name>.py``'s ``Driver``."""
    return load_file("drivers", name).Driver


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return f"device: {device} (no card)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        out = [f"nvidia-smi unavailable: {exc}"]
    idx = device.index or 0
    return f"card: {out[idx] if idx < len(out) else out}"


def spread_line(times: List[float]) -> str:
    """The median sample time and the highest percentile with ten samples
    beyond it, where there are that many."""
    n = len(times)
    line = f"sample_s: n {n}, median {statistics.median(times)!r}" if n else "sample_s: n 0"
    if n > 10:
        s = sorted(times)
        line += f", p{100 * (n - 10) / n:.1f} {s[n - 11]!r}"
    return line


def program_counters() -> Dict[str, float]:
    """The program's cumulative stage seconds (``GLOBAL_METRICS``) and
    kernel launches (``LAUNCHES``)."""
    from palace_tpu_torch.ops import _build
    from palace_tpu_torch.utils.timers import GLOBAL_METRICS

    out = {f"seconds:{k}": v.seconds for k, v in GLOBAL_METRICS.stages.items()}
    out.update({f"launches:{k}": float(v) for k, v in _build.LAUNCHES.items()})
    return out


def run_cell(bench: Mapping, parts: Mapping, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, say: Callable[[str], None] = print) -> dict:
    """Set up, run the window, check; returns the result object."""
    cell, config, mix, limits = parts["cell"], parts["config"], parts["mix"], parts["limits"]
    peaks = load_json(BENCH / "peaks.json")
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    driver = load_driver(mix["driver"])(config, mix, seed, device, tmp)
    try:
        driver.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        gc.collect()  # set-up's garbage is not the window's to collect
        setup_s = time.perf_counter() - t0 - driver.reference_s
        before = program_counters()
        times: List[float] = []
        prof = tracing.Profiler(trace, device)
        with prof:
            w0 = time.perf_counter()
            while True:
                t = time.perf_counter()
                with torch.profiler.record_function(tracing.CALL_SPAN):
                    driver.sample()
                times.append(time.perf_counter() - t)
                if time.perf_counter() - w0 >= seconds:
                    break
            window_s = time.perf_counter() - w0
        after = program_counters()
        samples = len(times)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        say(spread_line(times))
        result: dict = {"correct": False, "attempted": samples, "failed": 0, "metrics": {},
                        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                                   "kind": (torch.cuda.get_device_name(device)
                                            if device.type == "cuda" else "cpu"),
                                   "count": cell["chips"], "memory_peak_bytes": peak}}
        work = driver.work(samples)
        if trace:
            tr = prof.read()
            ctx = SimpleNamespace(cell=cell, config=config, mix=mix, peaks=peaks, trace=tr,
                                  window_s=tr.window_s, work=work,
                                  program={k: after[k] - before.get(k, 0.0) for k in after})
            for m in bench["per_layer"]:
                if applies(m, cell["name"]):
                    value = load_reader(m["name"])(ctx)
                    if value is not None:
                        result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
            result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        else:
            wanted = [m for m in bench["end_to_end"] if applies(m, cell["name"])]
            values = driver.end_to_end([m for m in wanted if m["name"] != "setup_s"],
                                       samples, window_s)
            values["setup_s"] = setup_s
            for m in wanted:
                if m["name"] not in values:
                    raise SystemExit(f"portbench: driver {mix['driver']!r} reports no "
                                     f"{m['name']!r} ({m['unit']})")
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        driver.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = driver.check()
        say(f"set-up: {json.dumps(getattr(driver, 'setup_parts', {}))}; work: {json.dumps(work)}; "
            f"reference: {json.dumps(getattr(driver, 'info', {}))}")
        checks = {}
        for name, spec in limits["checks"].items():
            value = numbers.get(name, math.inf)
            checks[name] = {"value": value, "limit": spec["limit"]}
        result["correct"] = bool(checks) and all(
            c["value"] <= c["limit"] for c in checks.values())
        result["checks"] = checks
        return result
    finally:
        driver.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main(args, t0: float) -> int:
    bench = load_json(ROOT / "BENCHMARK.json")
    parts = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < parts["cell"]["chips"]:
        print(f"portbench: the cell needs {parts['cell']['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    import palace_tpu_torch  # the program: this checkout's, or no run

    if ROOT not in Path(palace_tpu_torch.__file__).resolve().parents:
        print(f"portbench: palace_tpu_torch comes from {palace_tpu_torch.__file__}, "
              f"not from {ROOT}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    peaks = load_json(BENCH / "peaks.json")
    print(card_line(device) + "; peaks " + json.dumps(
        {k: v for k, v in peaks.items() if k != "source"}), flush=True)
    result = run_cell(bench, parts, args.seed, args.seconds, bool(args.trace), device, t0,
                      say=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port must not use: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
