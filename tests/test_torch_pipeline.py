"""The port's pipeline against the JAX package's, on the CPU.

* ``PalaceConfig`` parses the demo worlds' configs and a file with '.'
  keys, '#' lines, ``MIN_LEN`` and unknown keys to the same fields,
  output paths and validation messages; boolean keys differ on purpose
  (case ``bool_keys``).
* ``StageRunner`` skips, forces and accepts empty outputs as JAX's does,
  and each external tool's wrapper returns False when the tool is off
  ``PATH``.
* The demo worlds of ``scripts/make_demo.py`` (``build``,
  ``build_hostile``, ``build_random`` at seeds 101, 202 and 303) run
  through both drivers, the port's with ``device="cpu"``: the files of
  steps 3-6 are byte-identical and every planted genome is in the final
  FASTA.  ``make_demo`` draws from one module-level generator, so each
  world is built once and copied for the port, its config rewritten.
* With the scores and references left to the pipeline, one small-config
  scorer built from one set of JAX parameters goes into both drivers
  (``params_from_jax`` on the port's side) and eref runs inside each:
  the scores agree within 1e-5, ``ref_names.txt`` and the final FASTA
  are byte-identical; a second run skips the scorer and ``force`` re-runs
  it.
* ``python -m palace_tpu_torch --config`` runs the pipeline with
  ``--device cpu`` and, without a card, exits nonzero before any stage
  writes a file.
"""
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from palace_tpu import config as jconfig
from palace_tpu.filters import gene_matches as jgene_matches
from palace_tpu.models import gcn as jgcn
from palace_tpu.models import scoring as jscoring
from palace_tpu.pipeline import driver as jdriver
from palace_tpu.pipeline import external as jexternal
from palace_tpu.pipeline import stages as jstages
from palace_tpu.utils import timers as jtimers
from palace_tpu_torch import config as tconfig
from palace_tpu_torch.filters import gene_matches as tgene_matches
from palace_tpu_torch.io.fasta import iter_fasta
from palace_tpu_torch.models import gcn as tgcn
from palace_tpu_torch.models import scoring as tscoring
from palace_tpu_torch.pipeline import driver as tdriver
from palace_tpu_torch.pipeline import external as texternal
from palace_tpu_torch.pipeline import stages as tstages
from palace_tpu_torch.utils import timers as ttimers
from _torch_jax_native import jax_native_dir  # noqa: F401  (JAX's native build, private)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

WORLDS = ["demo", "hostile", "random101", "random202", "random303"]
COMPARED = ("03-search", "04-match", "05-furth", "final_result")
OWNED = ("score", "eref", "graph", "filter_graph", "matching", "filter_result")


def _rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _build(kind: str, root: Path):
    """A make_demo world in ``root``: its config and its planted genomes
    as ``[(sequence, circular), ...]``."""
    import make_demo

    if kind.startswith("random"):
        return make_demo.build_random(root, int(kind[len("random"):]))
    cfg = make_demo.build(root) if kind == "demo" else make_demo.build_hostile(root)
    db = dict(iter_fasta(root / "phagedb.fasta"))
    planted = ({"phageP": True, "phageQ": False} if kind == "demo"
               else {"phageA": True, "phageB": True})
    return cfg, [(db[name], circular) for name, circular in planted.items()]


def _twin(src: Path, dst: Path) -> Path:
    """Copy a world for the other package; its config names absolute paths."""
    shutil.copytree(src, dst)
    cfg = dst / "config.txt"
    cfg.write_text(cfg.read_text().replace(str(src), str(dst)))
    return cfg


def _files(out: Path) -> dict:
    return {p.relative_to(out).as_posix(): p.read_bytes()
            for sub in COMPARED for p in sorted((out / sub).rglob("*")) if p.is_file()}


def _assert_same_files(jax_out: Path, port_out: Path, floats=()) -> None:
    """Every file of steps 3-6 byte-identical, but those in ``floats``."""
    want, got = _files(jax_out), _files(port_out)
    assert sorted(got) == sorted(want)
    for name in set(want) - set(floats):
        assert got[name] == want[name], name


def _missing_genomes(final: Path, expected) -> list:
    bodies = [s.replace("N" * 50, "") for _, s in iter_fasta(final)]
    missing = []
    for i, (genome, circular) in enumerate(expected):
        if circular:
            ok = any(len(b) == len(genome) and (b in genome + genome or _rc(b) in genome + genome)
                     for b in bodies)
        else:
            ok = any(b == genome or _rc(b) == genome for b in bodies)
        if not ok:
            missing.append(i)
    return missing


# -- config -------------------------------------------------------------------

SPECIAL = """# a config as users write it
fastq1 = /data/r1.fastq
fastq2=/data/r2.fastq

#phagedb=/commented/out.fasta
kmer.k=20
kmer.window = 300
score.batch_size=64
score.dtype=bfloat16
score.allow_random_weights=1
graph.min_count=3
graph.enable_paired=true
mesh.model_parallel=2
MIN_LEN=5000.0
matching_exact=1
blast_ratio=0.8
threads=4
unknown_key=zzz
Score_fuse_k=2
a line without an equals sign
"""


@pytest.fixture(scope="module")
def config_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("configs")
    files = {kind: _build(kind, root / kind)[0] for kind in ("demo", "hostile", "random101")}
    files["special"] = root / "special.txt"
    files["special"].write_text(SPECIAL)
    files["bool_keys"] = root / "bool_keys.txt"
    files["bool_keys"].write_text(SPECIAL.replace("score.allow_random_weights=1",
                                                  "score_allow_random_weights=false")
                                  .replace("graph.enable_paired=true", "graph_enable_paired=0"))
    return files


@pytest.mark.parametrize("name", ["demo", "hostile", "random101", "special", "bool_keys"])
def test_config_parses_as_jax(config_files, name):
    want = jconfig.PalaceConfig.from_file(config_files[name])
    got = tconfig.PalaceConfig.from_file(config_files[name])
    w, g = dataclasses.asdict(want), dataclasses.asdict(got)
    if name == "bool_keys":
        # JAX converts a nested key with type(current)(value), and
        # bool("false") and bool("0") are True (palace_tpu/config.py:183);
        # the port parses 1/true/yes and 0/false/no (ROADMAP Queue 3)
        assert (w["score"]["allow_random_weights"], w["graph"]["enable_paired"]) == (True, True)
        assert (g["score"]["allow_random_weights"], g["graph"]["enable_paired"]) == (False, False)
        for d in (w, g):
            del d["score"]["allow_random_weights"], d["graph"]["enable_paired"]
    assert g == w
    assert got.output_files() == want.output_files()
    assert got.validate() == want.validate()
    assert got.validate(check_files=False) == want.validate(check_files=False)
    if name == "special":
        assert (got.kmer.k, got.kmer.window, got.min_len, got.score.dtype) == (20, 300, 5000,
                                                                              "bfloat16")
        assert got.extra == {"unknown_key": "zzz", "Score_fuse_k": "2"}
        assert got.validate(check_files=False) == [
            "Required variable 'phagedb' is not defined in config file",
            "Required variable 'protein_db' is not defined in config file",
            "Required variable 'gcn_model' is not defined in config file"]


@pytest.mark.parametrize("text,value", [("true", True), ("1", True), ("Yes", True),
                                        ("TRUE", True), ("false", False), ("0", False),
                                        ("no", False), ("False", False)])
def test_boolean_key_spellings(text, value):
    cfg = tconfig.PalaceConfig.from_dict({"score_allow_random_weights": text,
                                          "graph.enable_paired": text})
    assert cfg.score.allow_random_weights is value and cfg.graph.enable_paired is value


@pytest.mark.parametrize("text", ["maybe", "", "2", "on"])
def test_boolean_key_raises_on_anything_else(text):
    with pytest.raises(ValueError, match="not a boolean"):
        tconfig.PalaceConfig.from_dict({"score_allow_random_weights": text})


# -- stages and external tools ------------------------------------------------

def _run_stages(mod, timers, d: Path, force: bool):
    ran = []
    (d / "full.txt").write_text("x")
    (d / "empty.txt").write_text("")
    missing = d / "sub" / "made.txt"

    def make():
        ran.append("made")
        missing.write_text("y")

    stages = [mod.Stage("full", lambda: ran.append("full"), [d / "full.txt"]),
              mod.Stage("empty", lambda: ran.append("empty"), [d / "empty.txt"]),
              mod.Stage("empty_ok", lambda: ran.append("empty_ok"), [d / "empty.txt"],
                        allow_empty=True),
              mod.Stage("made", make, [missing]),
              mod.Stage("no_outputs", lambda: ran.append("no_outputs"), [])]
    runner = mod.StageRunner(metrics=timers.Metrics(), force=force)
    results = runner.run_all(stages)
    again = runner.run(stages[3])  # its output exists now
    return (ran, [(r.name, r.skipped) for r in results], again.skipped,
            sorted(runner.metrics.stages))


@pytest.mark.parametrize("force", [False, True])
def test_stage_runner_skips_and_forces_as_jax(tmp_path, force):
    out = {}
    for name, mod, timers in (("jax", jstages, jtimers), ("port", tstages, ttimers)):
        (tmp_path / name).mkdir()
        out[name] = _run_stages(mod, timers, tmp_path / name, force)
    assert out["port"] == out["jax"]
    ran = out["port"][0]
    if force:
        assert ran == ["full", "empty", "empty_ok", "made", "no_outputs", "made"]
    else:
        assert ran == ["empty", "made", "no_outputs"] and out["port"][2] is True


def test_stage_runner_raises_the_stage_error_as_jax(tmp_path):
    def boom():
        raise OSError("stage failed")

    for mod in (jstages, tstages):
        with pytest.raises(OSError, match="stage failed"):
            mod.StageRunner(force=True).run(mod.Stage("boom", boom, [tmp_path / "x"]))
    assert tstages.file_exists_with_content(tmp_path / "x") is False


def _tool_calls(mod, d: Path) -> dict:
    f = d / "in.fasta"
    return {
        "fastp": lambda: mod.run_fastp(f, f, d / "o1", d / "o2", 2, d / "j", d / "h"),
        "spades": lambda: mod.run_spades_meta(f, f, d / "asm", 2),
        "bwa_samtools": lambda: mod.run_bwa_samtools(f, f, f, d / "o.bam", 2),
        "makeblastdb": lambda: mod.run_makeblastdb(f, d / "db"),
        "blastn": lambda: mod.run_blastn(f, d / "db", d / "o.blast", 2),
        "ragtag": lambda: mod.run_ragtag(f, f, d / "rag"),
    }


@pytest.mark.parametrize("tool", ["fastp", "spades", "bwa_samtools", "makeblastdb", "blastn",
                                  "ragtag"])
def test_external_tool_off_path_returns_false(tmp_path, monkeypatch, tool):
    monkeypatch.setenv("PATH", str(tmp_path / "no_tools"))
    for mod in (jexternal, texternal):
        assert _tool_calls(mod, tmp_path)[tool]() is False
    assert sorted(p.name for p in tmp_path.iterdir()) == []


def test_gene_matches_without_blast_writes_empty_hits_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "no_tools"))
    (tmp_path / "prot").mkdir()
    (tmp_path / "prot" / "p.fasta").write_text(">p\nMAAK\n")
    (tmp_path / "a.fasta").write_text(">c\nACGT\n")
    for name, mod in (("jax", jgene_matches), ("port", tgene_matches)):
        out = tmp_path / name
        out.mkdir()
        mod.find_phage_gene_matches(tmp_path / "a.fasta", tmp_path / "prot", out, 2)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["hit_seqs.out"]
    assert (tmp_path / "port" / "hit_seqs.out").read_bytes() == \
        (tmp_path / "jax" / "hit_seqs.out").read_bytes() == b""


# -- the demo worlds through both drivers ---------------------------------------

@pytest.fixture(scope="module", params=WORLDS)
def world_run(request, tmp_path_factory):
    base = tmp_path_factory.mktemp(request.param)
    cfg, expected = _build(request.param, base / "jax")
    twin = _twin(base / "jax", base / "port")
    final_j = jdriver.run_pipeline(jconfig.PalaceConfig.from_file(cfg))
    final_p = tdriver.run_pipeline(tconfig.PalaceConfig.from_file(twin), device="cpu")
    return base, final_j, final_p, expected


def test_demo_world_files_byte_identical(world_run):
    base, final_j, final_p, _ = world_run
    assert final_p.read_bytes() == final_j.read_bytes()
    _assert_same_files(base / "jax" / "output", base / "port" / "output")


def test_demo_world_planted_genomes_reconstructed(world_run):
    _, _, final_p, expected = world_run
    assert _missing_genomes(final_p, expected) == []


# -- the scorer and eref inside both drivers ------------------------------------

SMALL = dict(gcn_dim=16, cnn_dim=8, fc_dim=8)


@pytest.fixture(scope="module")
def scored_run(tmp_path_factory):
    """The demo world without its pre-staged scores: both drivers score it
    with one small-config model and run eref (k = 16) themselves."""
    base = tmp_path_factory.mktemp("scored")
    cfg, expected = _build("demo", base / "jax")
    (base / "jax" / "output" / "03-search" / "node_scores.out").unlink()
    twin = _twin(base / "jax", base / "port")
    jcfg, tcfg = jgcn.GCNConfig(**SMALL), tgcn.GCNConfig(**SMALL)
    jp = jgcn.init_params(jax.random.PRNGKey(3), jcfg)
    jp["d1.w"], jp["d2.w"] = jp["d1.w"] * 3.0, jp["d2.w"] * 30.0  # spread the probabilities
    tp = tgcn.params_from_jax({k: np.asarray(v) for k, v in jp.items()})

    def jax_scorer(fasta, out):
        return jscoring.score_fasta(jp, fasta, out, jcfg, batch_size=8)

    def port_scorer(fasta, out):
        return tscoring.score_fasta(tp, fasta, out, tcfg, batch_size=8, device="cpu")

    final_j = jdriver.run_pipeline(jconfig.PalaceConfig.from_file(cfg), scorer=jax_scorer)
    final_p = tdriver.run_pipeline(tconfig.PalaceConfig.from_file(twin), scorer=port_scorer,
                                   device="cpu")
    return dict(base=base, final_j=final_j, final_p=final_p, cfg=cfg, twin=twin,
                scorer=port_scorer, jax_scorer=jax_scorer, expected=expected)


def test_card_stages_inside_the_driver_agree_with_jax(scored_run):
    base = scored_run["base"]
    search = "output/03-search"
    want = tscoring.read_scores(base / "jax" / search / "node_scores.out")
    got = tscoring.read_scores(base / "port" / search / "node_scores.out")
    assert list(got) == list(want) and len(got) == 6
    assert max(abs(got[k] - want[k]) for k in want) <= 1e-5
    assert np.ptp(list(got.values())) > 0.05
    names = (base / "port" / search / "demo_ref_names.txt").read_bytes()
    assert names == (base / "jax" / search / "demo_ref_names.txt").read_bytes()
    assert names.count(b"ref_index") == 2
    assert scored_run["final_p"].read_bytes() == scored_run["final_j"].read_bytes()
    _assert_same_files(base / "jax" / "output", base / "port" / "output",
                       floats=["03-search/node_scores.out"])
    assert _missing_genomes(scored_run["final_p"], scored_run["expected"]) == []


def _counting(scorer, calls):
    def run(fasta, out):
        calls.append(fasta)
        return scorer(fasta, out)

    return run


def test_resume_skips_the_scorer_and_owned_stages(scored_run):
    calls = []
    pipe = tdriver.PalacePipeline(tconfig.PalaceConfig.from_file(scored_run["twin"]),
                                  scorer=_counting(scored_run["scorer"], calls), device="cpu")
    before = scored_run["final_p"].read_bytes()
    pipe.run()
    assert calls == [], "the scorer must not re-run when its artifact exists"
    assert set(OWNED) <= {r.name for r in pipe.runner.results if r.skipped}
    assert scored_run["final_p"].read_bytes() == before


def test_force_reruns_the_scorer_and_owned_stages(scored_run):
    """``force`` re-runs every stage, the scorer too, in both packages.
    It also re-runs the protein search, which writes an empty
    ``hit_seqs.out`` without tblastn over the pre-staged hits, as JAX's
    driver does: the final FASTA is compared with JAX's forced run."""
    calls = []
    pipe = tdriver.PalacePipeline(tconfig.PalaceConfig.from_file(scored_run["twin"]), force=True,
                                  scorer=_counting(scored_run["scorer"], calls), device="cpu")
    pipe.run()
    assert len(calls) == 1, "force=True must re-run the scoring stage"
    assert set(OWNED) <= {r.name for r in pipe.runner.results if not r.skipped}
    assert not any(r.skipped for r in pipe.runner.results)
    jdriver.PalacePipeline(jconfig.PalaceConfig.from_file(scored_run["cfg"]), force=True,
                           scorer=scored_run["jax_scorer"]).run()
    assert scored_run["final_p"].read_bytes() == scored_run["final_j"].read_bytes()
    base = scored_run["base"]
    _assert_same_files(base / "jax" / "output", base / "port" / "output",
                       floats=["03-search/node_scores.out"])


def test_default_scorer_without_a_checkpoint_raises(tmp_path):
    cfg = tconfig.PalaceConfig(gcn_model=str(tmp_path / "absent.pt"))
    pipe = tdriver.PalacePipeline(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="gcn_model checkpoint not found"):
        pipe._default_scorer(str(tmp_path / "a.fasta"), str(tmp_path / "out"))


# -- the entry point --------------------------------------------------------------

def _main(args, env=None):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, env=env)


def test_entry_point_runs_the_pipeline_on_the_cpu(tmp_path):
    cfg, expected = _build("hostile", tmp_path / "jax")
    twin = _twin(tmp_path / "jax", tmp_path / "port")
    final_j = jdriver.run_pipeline(jconfig.PalaceConfig.from_file(cfg))
    r = _main(["palace_tpu_torch", "--config", str(twin), "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    final_p = tconfig.PalaceConfig.from_file(twin).output_files()["final_fasta"]
    assert final_p.read_bytes() == final_j.read_bytes()
    assert _missing_genomes(final_p, expected) == []


@pytest.mark.parametrize("module", ["palace_tpu_torch", "palace_tpu_torch.pipeline.driver"])
def test_entry_point_without_a_card_exits_before_any_stage(tmp_path, module):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg, _ = _build("demo", tmp_path)
    before = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*"))
    r = _main([module, "--config", str(cfg)])
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr and "--device cpu" in r.stderr
    assert sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")) == before
    with pytest.raises(RuntimeError, match="CUDA device"):
        tdriver.PalacePipeline(tconfig.PalaceConfig.from_file(cfg))
    assert sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")) == before


def test_stage_subcommands_still_route_to_the_cli():
    r = _main(["palace_tpu_torch", "--help"])
    assert r.returncode == 0 and "--config config.txt" in r.stdout and "makefa" in r.stdout
    r = _main(["palace_tpu_torch", "fastg2fa", "--help"])
    assert r.returncode == 0 and "fastg" in r.stdout
