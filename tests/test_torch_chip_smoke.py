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
from _torch_jax_native import jax_native_dir  # noqa: F401  (JAX's native build, private)

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


def test_ptxas_summary_names_the_conv_head_variants():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115conv_mma_kernelI13__nv_bfloat16Li128ELb1ELb0EEEvPKT_S4_S4_PS2_iii' "
        "for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115conv_mma_kernelI6__halfLi64ELb0ELb1EEEvPKT_S4_S4_PS2_iii' "
        "for 'sm_90a'",
        "ptxas info    : Used 96 registers, used 1 barriers",
    ])
    assert chip_smoke.ptxas_summary(log) == [
        "bf16 C=128 (B,C,L)->(B,L,C): Used 168 registers, used 1 barriers",
        "f16 C=64 (B,L,C)->(B,C,L): Used 96 registers, used 1 barriers",
    ]


def test_ptxas_summary_names_an_entry_without_a_dtype_by_its_kernel():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN48_GLOBAL__N__48915f66_15_good_windows_cu_e244ca9817scan_chunk_kernelEPKhS1_PKlS1_"
        "NS_10CoderMasksEPhiiiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 32 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119good_windows_kernelEPKhPKlPhiiiii' for 'sm_90a'",
        "ptxas info    : Used 33 registers, used 1 barriers, 32 bytes smem",
    ])
    assert chip_smoke.ptxas_summary(log) == [
        "scan_chunk_kernel: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "scan_chunk_kernel: Used 40 registers, used 1 barriers, 32 bytes smem",
        "good_windows_kernel: Used 33 registers, used 1 barriers, 32 bytes smem",
    ]
    assert chip_smoke.kernel_name("_Z6kernelIfEvPKT_") is None


def test_make_contigs():
    uniform = chip_smoke.make_contigs(3, 500, seed=1)
    assert [n for n, _ in uniform] == ["contig_0", "contig_1", "contig_2"]
    assert all(len(s) == 500 and set(s) <= set("ACGT") for _, s in uniform)
    assert uniform == chip_smoke.make_contigs(3, 500, seed=1)
    spread = chip_smoke.make_contigs(8, 4000, seed=1, gc_spread=True)
    gc = [(s.count("G") + s.count("C")) / len(s) for _, s in spread]
    assert gc[0] < 0.25 and gc[-1] > 0.75 and np.all(np.diff(gc) > 0)


def test_make_assembly_contigs(monkeypatch):
    monkeypatch.setattr(chip_smoke, "LONG_CONTIG", 60_000)
    contigs = chip_smoke.make_assembly_contigs(40, seed=3)
    lens = [len(s) for _, s in contigs]
    assert len(contigs) == 40 and lens == sorted(lens, reverse=True) and lens[0] == 60_000
    seqs = [s for _, s in contigs]
    assert 500 <= min(lens) and "AT" * 25_000 in seqs
    # a 100-N gap in every tenth of the 36 log-normal contigs
    assert sum("N" * 100 in s and "N" * 101 not in s for s in seqs) == 4
    # gaps longer than K1's 8 KiB chunk, one at the start, one on a tile edge
    assert sum(s.startswith("N" * 9000) and len(s) == 14_000 for s in seqs) == 1
    assert sum(s[16_384:25_384] == "n" * 9000 and len(s) == 40_000 for s in seqs) == 1
    assert contigs == chip_smoke.make_assembly_contigs(40, seed=3)


def test_k1_tiles_and_bound_count_the_rows():
    offsets = torch.tensor([0, 0, 10, 16384, 32769, 32769 + 50_000])
    assert chip_smoke.k1_tiles(offsets, 16384) == 1 + 1 + 1 + 2 + 4
    data = torch.frombuffer(bytearray(b"ACGTACGTNN" + b"A" * 16374 + b"C" * 16385 + b"G" * 50_000),
                            dtype=torch.uint8)
    lens = offsets.diff().to(torch.int32)
    feats = torch.zeros(5, 12288)
    ms, by = chip_smoke.k1_bound(data, offsets, lens, feats)
    # codes 0, 8, 16374, 16385, 50000: pairs sum over rows of max(n - 5 - d, 0)
    pairs = sum(max(n - 5 - d, 0) for n in (0, 8, 16374, 16385, 50_000) for d in range(3))
    want, _ = chip_smoke.bound(data.numel() + 6 * 8 + 5 * 4 + 5 * 12288 * 4, pairs, torch.float32)
    assert by == "bytes" and ms == pytest.approx(want)


def _small_eref_world(monkeypatch):
    """chip_smoke's eref world at a size the CPU runs in seconds: 50 refs
    of 3-12 kb, 3,000 reads from the one planted ref, k = 20."""
    monkeypatch.setattr(chip_smoke, "EREF_REFS", 50)
    monkeypatch.setattr(chip_smoke, "EREF_READS", 3000)
    monkeypatch.setattr(chip_smoke, "EREF_LEN_RANGE", (3000, 12000))
    monkeypatch.setattr(chip_smoke, "EREF_K", 20)
    monkeypatch.setattr(chip_smoke, "PROFILE_CHUNKS", 2)


def _jax_hits_on_the_small_world(tmp_path):
    """The JAX package's hit count on that world (the role the TPU's 67 of
    benchmarks/phaseb_5kref.json plays at full size)."""
    from palace_tpu.config import KmerParams
    from palace_tpu.search.eref import count_reads_into_table, search_references
    from palace_tpu.search.index import build_index

    db, fq, n_planted = chip_smoke.make_eref_world(
        tmp_path, chip_smoke.EREF_REFS, chip_smoke.EREF_READS)
    assert n_planted == 1
    index = build_index(db, k=chip_smoke.EREF_K, save=False)
    params = KmerParams(k=chip_smoke.EREF_K)
    return len(search_references(count_reads_into_table([fq], index, params), index, params))


def test_make_eref_world_replays_the_generator(tmp_path):
    db, fq, n_planted = chip_smoke.make_eref_world(tmp_path, 100, 40, len_range=(500, 900))
    names = [l[1:].strip() for l in db.read_text().splitlines() if l.startswith(">")]
    assert names == [f"ref{i + 1}" for i in range(100)] and n_planted == 2
    rng = np.random.default_rng(chip_smoke.EREF_SEED)
    lengths = np.exp(rng.uniform(np.log(500), np.log(900), 100)).astype(np.int64)
    seqs = db.read_text().splitlines()[1::2]
    assert [len(s) for s in seqs] == lengths.tolist()
    reads = fq.read_text().splitlines()[1::4]
    assert len(reads) == 40 and all(len(r) == 150 for r in reads)
    # reads alternate over the planted refs in the order of their sorted names
    assert all(reads[i] in seqs[[0, 1][i % 2]] for i in range(40))


def test_phases_run_on_the_cpu_at_a_small_size(monkeypatch, tmp_path):
    """The script's phases at a small size on the CPU, where every wrapper
    takes its plain version: every check passes except the ones that each
    main path launched its kernels."""
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters, warmup=2: (fn(), 0.0)[1])
    for name, value in (("synchronize", None), ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0), ("empty_cache", None)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value: _v)
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    monkeypatch.setattr(chip_smoke, "N_CONTIGS", 8)
    monkeypatch.setattr(chip_smoke, "CONTIG_LEN", 2000)
    monkeypatch.setattr(chip_smoke, "LONG_CONTIG", 40_000)
    monkeypatch.setattr(chip_smoke, "ROUNDING_SHAPE", (2, 128, 300))
    monkeypatch.setattr(chip_smoke, "SAGE_ROUNDING_BATCH", 2)
    _small_eref_world(monkeypatch)
    monkeypatch.setattr(chip_smoke, "EREF_JAX_HITS", _jax_hits_on_the_small_world(tmp_path))
    assert chip_smoke.EREF_JAX_HITS == 1
    smoke = chip_smoke.Smoke("cpu")
    chip_smoke.run_phases(smoke)
    chip_smoke.run_eref_phases(smoke)
    assert smoke.failures[:3] == [f"main path launched {name} (0 times)"
                                  for name in chip_smoke.SCORING_KERNELS]
    assert len(smoke.failures) == 5
    assert smoke.failures[3].startswith("eref main path launched scan_chunk once a chunk (0 ")
    assert smoke.failures[4].startswith("per-reference path launched good_windows once a "
                                        "reference (0 ")
    assert {"transition_counts", "sage_rounds", "conv_head", "slice", "eref",
            "good_windows", "scan_chunk", "per_reference", "transition_counts_assembly",
            "slice_float32", "host_step", "transition_counts_low_complexity"} <= set(smoke.records)
    assert smoke.records["slice_err_float32"] <= chip_smoke.PROB_ATOL
    assert smoke.records["eref"]["n_hits"] == 1 and smoke.records["good_windows"]["chunks"] >= 2
    assert smoke.records["per_reference"]["n_hits"] == 1
    assert smoke.records["scan_chunk"]["max_abs_err"] == 0
    assert smoke.records["scan_chunk"]["all_chunks"] >= smoke.records["scan_chunk"]["chunks"] >= 2
    assert set(chip_smoke.KERNELS) == set(chip_smoke.SCORING_KERNELS) | {"good_windows",
                                                                          "scan_chunk"}


def test_graph_phases_run_on_the_cpu_at_a_small_size(monkeypatch):
    """The graph world and path at 60 contigs and 6,000 records: every
    check passes, with the native routes where g++ builds them."""
    monkeypatch.setattr(chip_smoke, "GRAPH_CONTIGS", 60)
    monkeypatch.setattr(chip_smoke, "GRAPH_RECORDS", 6000)
    smoke = chip_smoke.Smoke("cpu")
    assert smoke.native_build() == (shutil.which("g++") is not None)
    chip_smoke.run_graph_phases(smoke)
    assert smoke.failures == []
    rec = smoke.records["graph_path"]
    assert rec["route"] == "native" and rec["junctions"] > 10 and rec["paths"] > 10
    assert rec["solvers"]["exact"] > 0 and rec["solvers"]["handshake"] == 0
    assert smoke.records["graph_world"]["n_records"] == 6000


def test_make_graph_world_plants_what_the_graph_finds(tmp_path):
    world = chip_smoke.make_graph_world(tmp_path, n_contigs=40, n_records=3000, seed=2)
    assert world["n_records"] == 3000 and world["strong"] <= world["planted"]
    assert len(world["planted"]) == world["n_junctions"] > 20
    from palace_tpu_torch.io.bam import read_bam

    recs = read_bam(world["bam"]).records
    keys = [(r.tid if r.tid >= 0 else 1 << 30, r.pos) for r in recs]
    assert keys == sorted(keys) and sum("SA" in r.tags for r in recs) > 100
    heads = [l for l in world["fastg"].read_text().splitlines() if l.startswith(">")]
    assert len(heads) == 80
    assert sum(h[1:].split(":")[0].rstrip(";").endswith("'") for h in heads) == 40
    assert chip_smoke.canonical_junction("b", "+", "a", "-") == ("a", "+", "b", "-")


SMALL_GCN = dict(gcn_dim=16, cnn_dim=8, fc_dim=8)


def _small_pipeline_world(monkeypatch):
    """The pipeline world at a size the CPU runs in seconds: 3 phages, 50
    other contigs, 20 decoys, a small-config checkpoint (the scorer's
    widths but ``fnode_num``, which the encoder fixes, cut) and batches of
    16.  k = 20: at k = 16 this world's ~43,000 reads saturate 94 % of a
    2^16-slot table and every decoy reference is reported, at k = 20 only
    the planted ones are (``SMALL_K``, the small eref world's k)."""
    from palace_tpu_torch.models import gcn

    monkeypatch.setattr(gcn, "DEFAULT_CONFIG", gcn.GCNConfig(**SMALL_GCN))
    monkeypatch.setattr(chip_smoke, "PIPELINE_PHAGES", 3)
    monkeypatch.setattr(chip_smoke, "PIPELINE_OTHERS", 50)
    monkeypatch.setattr(chip_smoke, "PIPELINE_DECOYS", 20)
    monkeypatch.setattr(chip_smoke, "PIPELINE_KEYS",
                        {"kmer_k": chip_smoke.SMALL_K, "score_batch_size": 16})


def test_reference_state_dict_round_trips():
    from palace_tpu_torch.models import gcn

    cfg = gcn.GCNConfig(**SMALL_GCN)
    params = gcn.init_params(torch.Generator().manual_seed(1), cfg)
    state = chip_smoke.reference_state_dict(params, cfg)
    assert state["pnode_d.weight"].shape == (12288, 12288) and "lns.0.weight" in state
    back = gcn.params_from_numpy_state({k: v.numpy() for k, v in state.items()}, cfg)
    assert back.keys() == params.keys()
    assert all(torch.equal(back[k], params[k]) for k in params)


def test_reconstructed_finds_rotations_and_reverse_complements(tmp_path):
    from palace_tpu_torch.io.fasta import write_fasta

    rng = np.random.default_rng(5)
    g1, g2, g3 = ("".join(rng.choice(list("ACGT"), n)) for n in (60, 40, 30))
    genomes = [dict(name="c", genome=g1, circular=True),
               dict(name="l", genome=g2, circular=False),
               dict(name="x", genome=g3, circular=False)]
    rot = g1[17:] + g1[:17]
    write_fasta(tmp_path / "f.fasta", [("a", rot[:25] + "N" * 50 + rot[25:]),
                                       ("b", chip_smoke._rc(g2)), ("c", g3[1:]),
                                       ("d", g2[5:] + g2[:5]), ("e", "ACGT")])
    assert chip_smoke.reconstructed(tmp_path / "f.fasta", genomes) == (["c", "l"], 3)
    write_fasta(tmp_path / "g.fasta", [("a", chip_smoke._rc(rot)), ("b", g2), ("c", g3)])
    assert chip_smoke.reconstructed(tmp_path / "g.fasta", genomes) == (["c", "l", "x"], 0)


def test_make_pipeline_world_runs_through_both_drivers(monkeypatch, tmp_path):
    """The small pipeline world through the port's driver on the CPU (its
    default scorer reads the world's checkpoint) reconstructs every
    planted genome and reports exactly the planted references; the JAX
    driver on a copy, scoring with the same checkpoint, writes the same
    references and final FASTA, and scores within 1e-5."""
    from palace_tpu.config import PalaceConfig as JaxConfig
    from palace_tpu.models import gcn as jgcn
    from palace_tpu.models import scoring as jscoring
    from palace_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
    from palace_tpu_torch.config import PalaceConfig
    from palace_tpu_torch.models.scoring import read_scores
    from palace_tpu_torch.pipeline.driver import run_pipeline

    _small_pipeline_world(monkeypatch)
    world = chip_smoke.make_pipeline_world(
        tmp_path / "port", n_phages=3, n_others=50, n_decoys=20,
        config_keys=chip_smoke.PIPELINE_KEYS)
    assert world["n_contigs"] > 50 and sum(g["circular"] for g in world["genomes"]) == 2
    heads = [l for l in world["fasta"].read_text().splitlines() if l.startswith(">")]
    assert len(heads) == world["n_contigs"] and all("_length_" in h and "_cov_" in h
                                                   for h in heads)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    cfg_j = tmp_path / "jax" / "config.txt"
    cfg_j.write_text(cfg_j.read_text().replace(str(tmp_path / "port"), str(tmp_path / "jax")))

    final = run_pipeline(PalaceConfig.from_file(world["config"]), device="cpu")
    found, others = chip_smoke.reconstructed(final, world["genomes"])
    assert found == [g["name"] for g in world["genomes"]]
    out = world["out"] / "03-search"
    hits = [int(l.split("\t")[1]) for l in (out / "virome_ref_names.txt").read_text().splitlines()]
    assert sorted(world["ref_names"][i - 1] for i in hits) == ["phage1", "phage2", "phage3"]

    jcfg = jgcn.GCNConfig(**SMALL_GCN)
    params = jgcn.load_torch_state_dict(str(world["model"]), jcfg)

    def jax_scorer(fasta, out_path):
        return jscoring.score_fasta(params, fasta, out_path, jcfg, batch_size=16)

    final_j = jax_run_pipeline(JaxConfig.from_file(cfg_j), scorer=jax_scorer)
    assert final.read_bytes() == final_j.read_bytes()
    jout = tmp_path / "jax" / "output" / "03-search"
    assert (out / "virome_ref_names.txt").read_bytes() == \
        (jout / "virome_ref_names.txt").read_bytes()
    got, want = read_scores(out / "node_scores.out"), read_scores(jout / "node_scores.out")
    assert list(got) == list(want) and max(abs(got[k] - want[k]) for k in want) <= 1e-5


def test_pipeline_phases_run_on_the_cpu_at_a_small_size(monkeypatch):
    """Phases 14-15 at the small size on the CPU, where every wrapper takes
    its plain version: every check passes except that the pipeline
    launched the card's kernels."""
    _small_pipeline_world(monkeypatch)
    smoke = chip_smoke.Smoke("cpu")
    chip_smoke.run_pipeline_phases(smoke)
    rec = smoke.records["pipeline"]
    assert smoke.failures == [
        f"pipeline launched {name} {n} times (got 0)"
        for name, n in (("transition_counts", rec["n_batches"]),
                        ("sage_rounds", rec["n_batches"]),
                        ("conv_head", 3 * rec["n_batches"]), ("scan_chunk", rec["n_chunks"]))]
    assert rec["n_batches"] == 4 and rec["n_chunks"] > 1
    assert rec["found"] == ["phage1", "phage2", "phage3"] and rec["rescore_err"] == 0
    assert {f"step{i}" for i in range(1, 7)} == {k.split(".")[0] for k in rec["steps"]}
    assert smoke.records["pipeline_world"]["n_pairs"] > 10_000


SMALL_TRAIN = dict(fnode_num=8, gcn_dim=16, cnn_dim=8, fc_dim=10)


def _pooled(feats):
    """K1's (B, 3·64·64) features summed over 8 × 8 blocks of 3-mer codes:
    the (B, 3·8·8) width of the small config, GC share kept."""
    return feats.reshape(-1, 3, 8, 8, 8, 8).sum(dim=(3, 5)).reshape(-1, 3 * 64)


def test_train_phases_run_on_the_cpu_at_a_small_size(monkeypatch):
    """Phases 16-17 at a small size on the CPU (the small config, K1's plain
    features pooled to its width): every check passes except that the
    features and the scorer launched the card's kernels."""
    from palace_tpu_torch.models import gcn, scoring

    monkeypatch.setattr(chip_smoke, "train_cfg", lambda: gcn.GCNConfig(**SMALL_TRAIN))
    plain = chip_smoke.train_features
    monkeypatch.setattr(chip_smoke, "train_features", lambda seqs, dev: _pooled(plain(seqs, dev)))
    encode = scoring.features_from_bytes
    monkeypatch.setattr(scoring, "features_from_bytes", lambda *rows: _pooled(encode(*rows)))
    monkeypatch.setattr(chip_smoke, "cuda_times_ms",
                        lambda fn, iters, warmup=3: [(fn(), 1.0)[1] for _ in range(iters)])
    for name, value in (("TRAIN_CONTIGS", 96), ("TRAIN_HELD_OUT", 32), ("TRAIN_BATCH", 16),
                        ("CONTIG_LEN", 2000), ("TRAIN_TIMED_STEPS", 2), ("TRAIN_LR", 1e-3)):
        monkeypatch.setattr(chip_smoke, name, value)
    smoke = chip_smoke.Smoke("cpu")
    chip_smoke.run_train_phases(smoke)
    one = smoke.records["train_step_cpu"]
    assert smoke.failures == [
        "training features of 96 contigs through K1: launched transition_counts once (got 0)",
        # the CPU has no TF32: the control step is the guarded one
        f"TF32 without the guard falls outside: {one['grad_err_tf32']:.3g} > "
        f"{chip_smoke.GRAD_ERR_RATIO} x {one['grad_err_cpu']:.3g}",
        "scoring the held-out contigs launched transition_counts 2 times (got 0)",
        "scoring the held-out contigs launched sage_rounds 2 times (got 0)",
        "scoring the held-out contigs launched conv_head 6 times (got 0)"]
    rec = smoke.records["train"]
    assert rec["steps"] == 8 and rec["losses"][1] < rec["losses"][0]
    assert not any(rec["launches"].values()) and rec["resume_bit_equal"]
    assert rec["resume_rel"] == 0.0 and rec["ckpt_bytes"] > 0
    assert one["loss_rel"] == 0.0 and one["grad_err_pair"] == 0.0
    assert one["grad_err_card"] == one["grad_err_cpu"] == one["grad_err_tf32"] < 1e-4
    assert smoke.records["train_scored"]["err"] <= chip_smoke.PROB_ATOL
    assert smoke.records["train_step"]["busy_ms"] == 0  # no device time on the CPU



# -- phases 18-19: the GCN across devices, on the CPU under gloo ---------------------------

SMALL_MESH = dict(fnode_num=8, gcn_dim=16, cnn_dim=8, fc_dim=10)


def _small_mesh_rank():
    """Run first by each rank of phase 19 on the CPU: K1's plain features
    pooled to the small config's width, one thread."""
    from palace_tpu_torch.models import scoring

    encode, plain = scoring.features_from_bytes, chip_smoke.train_features
    scoring.features_from_bytes = lambda *rows: _pooled(encode(*rows))
    chip_smoke.train_features = lambda seqs, dev: _pooled(plain(seqs, dev))
    torch.set_num_threads(1)


def _wrong_shard_rank():
    """``_small_mesh_rank``, and each shard split over the model axis taken
    from the next model index's block."""
    from palace_tpu_torch.parallel import mesh as pmesh

    _small_mesh_rank()
    right = pmesh.local_shard

    def wrong(x, spec, mesh):
        if mesh is not None and mesh.mp > 1 and "model" in spec:
            i, j = mesh.coords
            mesh = pmesh.Mesh(mesh.grid, int(mesh.grid[i, (j + 1) % mesh.mp]), mesh.device)
        return right(x, spec, mesh)

    pmesh.local_shard = wrong


def _small_mesh_phases(monkeypatch, setup):
    """Phases 18-19 at the small config (K1's features pooled, as for the
    training phases), 8 contigs of 2 kb in batches of 4, two gloo ranks."""
    from palace_tpu_torch.models import gcn, scoring

    monkeypatch.setattr(chip_smoke, "mesh_cfg", lambda: gcn.GCNConfig(**SMALL_MESH))
    plain = chip_smoke.train_features
    monkeypatch.setattr(chip_smoke, "train_features", lambda seqs, dev: _pooled(plain(seqs, dev)))
    encode = scoring.features_from_bytes
    monkeypatch.setattr(scoring, "features_from_bytes", lambda *rows: _pooled(encode(*rows)))
    for name, value in (("N_CONTIGS", 8), ("CONTIG_LEN", 2000), ("BATCH", 4), ("TRAIN_BATCH", 4),
                        ("TRAIN_LR", 1e-3), ("MESH_SETUP", setup), ("MESH_TIMEOUT_S", 240)):
        monkeypatch.setattr(chip_smoke, name, value)
    smoke = chip_smoke.Smoke("cpu")
    chip_smoke.run_mesh_phases(smoke)
    return smoke


def test_mesh_phases_run_on_the_cpu_at_a_small_size(monkeypatch):
    """Every check passes except that the scorer launched the card's
    kernels: once a dtype on one rank, then on each rank of each layout."""
    smoke = _small_mesh_phases(monkeypatch, _small_mesh_rank)
    assert len(smoke.failures) == 2 + 2 * 2 * 2, smoke.failures
    assert all("launched K1, K2, K3 {'transition_counts': 2, 'sage_rounds': 2, 'conv_head': 6}"
               in f for f in smoke.failures)
    mesh = smoke.records["mesh"]
    assert list(mesh) == [(2, 1), (1, 2)]
    for (dp, mp), recs in mesh.items():
        assert [rec["coords"] for rec in recs] == [divmod(r, mp) for r in range(2)]
        for rec in recs:
            assert rec["float32"]["in_order"] and rec["float32"]["err"] <= 1e-6
            assert rec["bfloat16"]["err"] <= chip_smoke.PROB_ATOL_BF16
            assert rec["split"]["pnode_d.w"]["shape"] == (192, 192 // mp)
            assert rec["split"]["d1.w"]["shape"] == (344 // mp, 10)
            assert rec["specs"] == {"pnode_d.w": (None, "model"), "d1.w": ("model", None)}
            assert rec["collective_calls"] > 0 and rec["contigs_per_s"] > 0
            assert abs(rec["loss"] - rec["ref_loss"]) <= 1e-5 * rec["ref_loss"]
    assert mesh[(1, 2)][0]["checkpoint_equal"] and "checkpoint_equal" not in mesh[(2, 1)][0]


def test_mesh_phase_fails_on_a_wrong_shard(monkeypatch):
    """Ranks that take the next model index's block of every model-split
    parameter: the (1, 2) layout's scores and steps fail, (2, 1)'s pass."""
    smoke = _small_mesh_phases(monkeypatch, _wrong_shard_rank)
    wrong = [f for f in smoke.failures if "launched K1, K2, K3" not in f]
    assert wrong and all(f.startswith("(data, model) = (1, 2)") for f in wrong), wrong
    assert any("float32: every contig in input order, max |dp|" in f for f in wrong)
    assert any("train_step loss" in f for f in wrong)


def test_step_split_names_every_part_of_a_step():
    """``step_split`` on a CPU profile of one small training step, by CPU
    time: the four parts forward and backward, Adam, and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from palace_tpu_torch.models import gcn
    from palace_tpu_torch.models.train import init_train_state, train_step

    cfg = gcn.GCNConfig(**SMALL_TRAIN)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(gcn.init_params(gen, cfg), cfg, device="cpu")
    x_p, x_f = gcn.model_inputs_from_features(torch.rand(4, 3 * cfg.pnode_num, generator=gen),
                                              cfg)
    y = torch.tensor([0, 1, 0, 1])
    train_step(state, x_p, x_f, y, gen, cfg)  # Adam's state exists before the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, x_p, x_f, y, gen, cfg)
    split = chip_smoke.step_split(prof.events(), attr="self_cpu_time_total")
    parts = {f"{p} {d}" for p in chip_smoke.TRAIN_PARTS for d in ("fwd", "bwd")}
    assert parts | {"adam"} <= set(split) <= parts | {"adam", "other fwd", "other bwd"}
    assert all(v > 0 for v in split.values())
