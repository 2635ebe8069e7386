"""chip_smoke.py's phases 22-24 (eref and the pipeline across devices) on
the CPU under gloo, at the small eref and pipeline worlds of
tests/test_torch_chip_smoke.py; a file of their own so that the test
runner can place their spawned ranks beside the other phases' tests."""
import torch

import chip_smoke
from _torch_jax_native import jax_native_dir  # noqa: F401  (JAX's native build, private)
from test_torch_chip_smoke import (SMALL_GCN, _jax_hits_on_the_small_world, _small_eref_world,
                                   _small_pipeline_world)


def _small_pipeline_rank():
    """Run first by each rank of phases 23-24 on the CPU: the small config
    the pipeline's default scorer reads (``_small_pipeline_world``), one
    thread."""
    from palace_tpu_torch.models import gcn

    gcn.DEFAULT_CONFIG = gcn.GCNConfig(**SMALL_GCN)
    torch.set_num_threads(1)


def test_across_devices_phases_run_on_the_cpu_at_a_small_size(monkeypatch, tmp_path):
    """Phases 22-24 on the small eref and pipeline worlds, after the phases
    they are held to (6-7, 14-15): every check passes except that the
    card's kernels were launched, on one rank, on each of two ranks for
    ``run_search`` and ``run_search_distributed``, and in the pipeline on
    each of two ranks."""
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters, warmup=2: (fn(), 0.0)[1])
    for name, value in (("synchronize", None), ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0), ("empty_cache", None)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value: _v)
    _small_eref_world(monkeypatch)
    (tmp_path / "jax").mkdir()
    monkeypatch.setattr(chip_smoke, "EREF_JAX_HITS",
                        _jax_hits_on_the_small_world(tmp_path / "jax"))
    _small_pipeline_world(monkeypatch)
    monkeypatch.setattr(chip_smoke, "MESH_SETUP", _small_pipeline_rank)
    monkeypatch.setattr(chip_smoke, "ACROSS_TIMEOUT_S", 240)
    smoke = chip_smoke.Smoke("cpu")
    keep = tmp_path / "keep"
    keep.mkdir()
    with torch.inference_mode():
        world = smoke.phase("eref world", smoke.eref_world, keep)
        smoke.phase("eref slice", smoke.eref_slice, world)
    config = chip_smoke.run_pipeline_phases(smoke, keep)
    before = len(smoke.failures)
    chip_smoke.run_across_devices_phases(smoke, world, config, keep)
    failures = smoke.failures[before:]
    assert len(failures) == 1 + 2 * 2 + 2, failures
    assert failures[0].startswith("one rank: launched scan_hits and window_hits once a chunk")
    assert all("launched" in f and "(0, 0, 0;" in f for f in failures[:5]), failures
    assert all(f.startswith(f"pipeline, rank {r}: launched") for r, f in enumerate(failures[5:]))
    for name in ("scan_hits", "window_hits"):
        rec = smoke.records[name]
        assert rec["max_abs_err"] == 0 and rec["chunks"] >= 2 and rec["bound"][1] == "bytes"
    assert smoke.records["eref_mesh"]["launches"]["scan_hits"] == 0
    shares = smoke.records["scan_hits_shares"]  # rank 0's and the last rank's of 2 and 4
    assert set(shares) == {"2/0", "2/1", "4/0", "4/3"}
    assert 0 < shares["4/0"]["reads"] < shares["2/0"]["reads"] and shares["4/3"]["reads"] > 0
    rec = smoke.records["scan_hits"]
    assert 0 < rec["shard_reads"] < rec["probes"]
    for s in shares.values():  # each share's bound from its own shard reads behind set bits
        assert 0 < s["shard_reads"] < s["reads"]
        assert s["bound"] == chip_smoke.scan_hits_bound(rec["positions"], rec["rows"],
                                                        s["fbits"], s["shard_reads"])
    ranks = smoke.records["eref_two_ranks"]
    assert [r["coords"] for r in ranks] == [(0, 0), (1, 0)]
    for r in ranks:
        for run in r["runs"].values():
            assert run["shard"][1] and run["collectives"]["A"][1] > 0
            assert run["collectives"]["B"][1] > 0
    assert [r["rank"] for r in smoke.records["pipeline_mesh"]] == [0, 1]
    assert set(chip_smoke.KERNELS) >= {"scan_hits", "window_hits", "hit_filter"}
    rec = smoke.records["hit_filter"]  # the one rank's shard, the whole 2^20-slot table
    assert rec["max_abs_err"] == 0 and rec["bound"][1] == "bytes" and 0 < rec["set_share"] < 1
