"""chip_smoke.py without a card: it refuses to run and prints no result,
also when it is copied out of the repository; and its helpers count
bounds, parse ptxas output and make the contigs they say."""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]


def _run(script: Path, cwd: Path):
    return subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_a_card_and_prints_no_result(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    r = _run(script, script.parent)
    assert r.returncode != 0
    assert r.stdout == "" and "CUDA" in r.stderr


def test_bound_takes_the_larger_of_bytes_and_operations():
    ms, by = chip_smoke.bound(3.35e9, 1e9, torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = chip_smoke.bound(1e6, 989e9 * 2, torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(2.0)
    ms, by = chip_smoke.bound(1e6, 67e9, torch.float32)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_ptxas_summary_names_each_entry_by_dtype():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z6kernelI13__nv_bfloat16EvPKT_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 59 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z6kernelIfEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 66 registers, used 1 barriers, 41472 bytes smem",
    ])
    assert chip_smoke.ptxas_summary(log) == [
        "bf16: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "bf16: Used 59 registers, used 1 barriers",
        "f32: Used 66 registers, used 1 barriers, 41472 bytes smem",
    ]


def test_make_contigs():
    uniform = chip_smoke.make_contigs(3, 500, seed=1)
    assert [n for n, _ in uniform] == ["contig_0", "contig_1", "contig_2"]
    assert all(len(s) == 500 and set(s) <= set("ACGT") for _, s in uniform)
    assert uniform == chip_smoke.make_contigs(3, 500, seed=1)
    spread = chip_smoke.make_contigs(8, 4000, seed=1, gc_spread=True)
    gc = [(s.count("G") + s.count("C")) / len(s) for _, s in spread]
    assert gc[0] < 0.25 and gc[-1] > 0.75 and np.all(np.diff(gc) > 0)


def test_phases_run_on_the_cpu_at_a_small_size(monkeypatch):
    """The script's phases at 4 contigs a batch on the CPU, where every
    wrapper takes its plain version: every check passes except the ones
    that the main path launched each kernel."""
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters, warmup=2: (fn(), 0.0)[1])
    for name, value in (("synchronize", None), ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0), ("empty_cache", None)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value: _v)
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    monkeypatch.setattr(chip_smoke, "N_CONTIGS", 8)
    monkeypatch.setattr(chip_smoke, "CONTIG_LEN", 2000)
    smoke = chip_smoke.Smoke("cpu")
    chip_smoke.run_phases(smoke)
    assert smoke.failures == [f"main path launched {name} (0 times)"
                              for name in chip_smoke.KERNELS]
    assert {"transition_counts", "sage_rounds", "conv_head", "slice"} <= set(smoke.records)
    assert smoke.records["slice_err_float32"] <= chip_smoke.PROB_ATOL
