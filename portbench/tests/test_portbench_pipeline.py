"""The cell ``palace_f32.pipeline_virome``: its files found by name, its
world's counts, its references by hand, its readers, and whole runs of a
tiny world on the CPU: sound runs read ``correct`` true, and a fault
planted where each checked output is produced, or the control in the
program's place, reads it false.

The tiny world keeps the pipeline's scorer at its published widths (the
pipeline scores with ``gcn.DEFAULT_CONFIG``) over a dozen contigs, in
batches of 8, and eref at k = 24."""
import copy
import json
import re
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from palace_tpu_torch.filters import cycle_filter
from palace_tpu_torch.models import scoring
from palace_tpu_torch.pipeline import driver as pipeline
from palace_tpu_torch.pipeline import external
from palace_tpu_torch.search import eref
from portbench import calibrate
from portbench.harness import cell, trace
from portbench.reference import assembly as asm_ref
from portbench.reference import depth as depth_ref

CELL = "palace_f32.pipeline_virome"
BENCH = cell.load_json(cell.ROOT / "BENCHMARK.json")
METRICS = ["pipeline.search_s", "pipeline.depth_write_s", "pipeline.depth_read_s",
           "pipeline.graph_s", "pipeline.matching_s", "pipeline.device_idle"]
CHECKS = {"prob_gap_max", "prob_gap_mean", "contigs_misnamed", "report_lines_wrong",
          "depth_lines_wrong", "junctions_wrong", "planted_missing", "final_records_wrong",
          "external_runs"}
#: two genomes, and ten other contigs of which three pass MIN_LEN
TINY = {"phages": 2, "phage_len_min": 11000, "phage_len_max": 14000, "others": 10,
        "other_median_len": 5000, "other_max_len": 30000, "decoys": 4,
        "decoy_len_min": 5000, "decoy_len_max": 8000}
SEED = 2**31 + 12345
CPU = torch.device("cpu")


def tiny_parts() -> dict:
    """The cell's parts at the tiny world's size, held to the cell's limits."""
    parts = copy.deepcopy(cell.find_cell(BENCH, CELL))
    parts["mix"].update(TINY)
    parts["config"]["score"]["batch_size"] = 8
    parts["config"]["kmer"]["k"] = 24
    return parts


def run(seed: int = SEED, trace_on: bool = False) -> dict:
    return cell.run_cell(BENCH, tiny_parts(), seed, 0.2, trace_on, CPU, time.perf_counter(),
                         say=lambda s: None)


def driver_module():
    return cell.load_file("drivers", "pipeline")


# -- the cell's files and entries ----------------------------------------------
def test_cell_files_found_by_name():
    parts = cell.find_cell(BENCH, CELL)
    assert parts["cell"]["chips"] == 1 and parts["cell"]["config"] == "palace_f32"
    assert parts["mix"]["driver"] == "pipeline" and callable(cell.load_driver("pipeline"))
    assert set(parts["limits"]["checks"]) == CHECKS
    assert all(spec["limit"] == 0 for name, spec in parts["limits"]["checks"].items()
               if not name.startswith("prob_gap"))
    assert set(parts["limits"]["control"]) == {"quant", "table_bits", "soft_clips"}
    for name in METRICS:
        assert callable(cell.load_reader(name))


def test_new_metrics_name_the_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["pipeline_sample_s"]["workloads"] == [CELL]
    assert 0.01 <= e2e["pipeline_sample_s"]["bound"] <= 0.25
    per = {m["name"]: m for m in BENCH["per_layer"]}
    for name in METRICS:
        assert per[name]["workloads"] == [CELL] and per[name]["moves"] == "pipeline_sample_s"
    moved = {m["name"] for m in BENCH["per_layer"] if m["moves"] == "pipeline_sample_s"}
    assert moved == set(METRICS)


# -- the world -------------------------------------------------------------------
def test_world_counts_are_the_mixs_whatever_the_seed():
    mod = driver_module()
    mix = dict(cell.find_cell(BENCH, CELL)["mix"], **TINY)
    a, b = mod.make_world(mix, 1), mod.make_world(mix, SEED)
    lengths = [len(s) for _, s in a["contigs"]]
    assert [n for n, _ in a["contigs"]] == [n for n, _ in b["contigs"]]
    assert lengths == [len(s) for _, s in b["contigs"]]
    assert a["contigs"] != b["contigs"]
    pieces = sum(len(g["members"]) for g in a["genomes"])
    assert len(a["contigs"]) == pieces + mix["others"]
    circular = sum(g["circular"] for g in a["genomes"])
    assert circular == 1 and len(a["junctions"]) == pieces - mix["phages"] + circular
    planted = {m for g in a["genomes"] for m in g["members"]}
    src = [len(g["seq"]) + (mix["fragment"] if g["circular"] else 0) for g in a["genomes"]]
    pairs = sum(n * mix["phage_depth"] // (2 * mix["read_len"]) for n in src) + sum(
        len(s) * mix["other_depth"] // (2 * mix["read_len"])
        for name, s in a["contigs"] if name not in planted)
    assert a["reads"].shape == b["reads"].shape == (pairs, 2, mix["read_len"])
    assert len(a["refs"]) == mix["phages"] + mix["decoys"]
    # a record a mate, sorted by (contig, position)
    for w in (a, b):
        bam = w["bam"]
        assert bam["tid"].size == 2 * pairs
        assert sorted(zip(bam["pair"].tolist(), bam["mate"].tolist())) == \
            [(i, m) for i in range(pairs) for m in (0, 1)]
        key = bam["tid"] * 10**9 + bam["pos"]
        assert (np.diff(key) >= 0).all()


def _oriented(read: np.ndarray, rev: bool, mod) -> str:
    """A mate's bases as the record aligns them (reverse-complemented where
    the record is on the reverse strand)."""
    return (mod.COMPLEMENT[read[::-1]] if rev else read).tobytes().decode()


@pytest.mark.parametrize("seed", [3, SEED])
def test_world_records_align_their_reads(seed):
    """Every record's aligned bases are its mate's, its mate fields are the
    other record's, an SA tag names the rest of the read, and pairs and
    split reads cross the planted junctions and nothing else."""
    mod = driver_module()
    mix = dict(cell.find_cell(BENCH, CELL)["mix"], **TINY)
    w = mod.make_world(mix, seed)
    seqs = [s for _, s in w["contigs"]]
    bam, rl = w["bam"], mix["read_len"]
    recs = mod.bam_records(bam, w["contigs"], rl)
    at = {(r.name, bool(r.flag & 0x80)): r for r in recs}
    tid_of = {n: i for i, (n, _) in enumerate(w["contigs"])}
    crossed = set()
    for r, pair, mate in zip(recs, bam["pair"].tolist(), bam["mate"].tolist()):
        bases = _oriented(w["reads"][pair, mate], bool(r.flag & 0x10), mod)
        read_at = 0
        for n, op in r.cigar:
            if op == "M":
                assert bases[read_at:read_at + n] == seqs[r.tid][r.pos:r.pos + n]
            read_at += n
        mate_rec = at[(r.name, not mate)]
        assert (r.mtid, r.mpos) == (mate_rec.tid, mate_rec.pos)
        assert bool(r.flag & 0x20) == bool(mate_rec.flag & 0x10)
        assert bool(r.flag & 0x2) == (r.tid == mate_rec.tid) and r.flag & 0x1
        if r.tid != mate_rec.tid:
            crossed.add(frozenset((r.tid, mate_rec.tid)))
        if "SA" in r.tags:
            name, pos1, strand, cigar, _, _ = r.tags["SA"].rstrip(";").split(",")
            clip = [(int(x), op) for x, op in
                    zip(re.findall(r"\d+", cigar), re.findall(r"[MS]", cigar))]
            assert min(n for n, _ in clip) >= mix["min_split"]
            assert strand == ("-" if r.flag & 0x10 else "+")
            read_at = 0
            for n, op in clip:
                if op == "M":
                    t = tid_of[name]
                    assert bases[read_at:read_at + n] == seqs[t][int(pos1) - 1:int(pos1) - 1 + n]
                read_at += n
            crossed.add(frozenset((r.tid, tid_of[name])))
    planted = {frozenset((tid_of[x], tid_of[y])) for x, y in w["junctions"]}
    assert crossed == planted


# -- the references by hand ---------------------------------------------------------
def test_new_references_load_nothing_of_the_program():
    from portbench.tests.test_portbench_imports import loaded_after

    names = loaded_after("import portbench.reference.depth, portbench.reference.assembly")
    assert not names & {"palace_tpu_torch", "palace_tpu", "jax", "jaxlib", "flax"}


def test_depth_by_hand():
    # contig 0 of 10 bases: a read of 4 M at 2, one of 3 M then 3 S at 7 (its
    # clip past the end); contig 1 of 5: 2 S then 2 M at 1, and 1 M 2 D 1 M at 0
    records = [(0, 2, [(4, "M")]), (0, 7, [(3, "M"), (3, "S")]),
               (1, 1, [(2, "S"), (2, "M")]), (1, 0, [(1, "M"), (2, "D"), (1, "M")])]
    d = depth_ref.depths([10, 5], records)
    assert d.tolist() == [0, 0, 1, 1, 1, 1, 0, 1, 1, 1] + [1, 1, 1, 1, 0]
    text = depth_ref.depth_text(["c0", "c1"], [10, 5], d)
    assert text.split(b"\n")[:3] == [b"c0\t3\t1", b"c0\t4\t1", b"c0\t5\t1"]
    assert text.endswith(b"c0\t10\t1\nc1\t1\t1\nc1\t2\t1\nc1\t3\t1\nc1\t4\t1\n")
    assert text.count(b"\n") == 11
    # the control counts the clips: the leading one covers 1-2 and moves the M
    soft = depth_ref.depths([10, 5], records, soft_clips=True)
    assert soft.tolist()[10:] == [1, 1, 1, 2, 1]
    assert soft.tolist()[:10] == d.tolist()[:10]   # a trailing clip past the end: nothing


def test_depth_text_widths():
    d = np.zeros(123456, np.int64)
    d[[0, 9, 99, 99999, 123455]] = [1, 10, 100, 5, 7]
    text = depth_ref.depth_text(["EDGE_1_length_123456_cov_5.0"], [123456], d)
    want = "".join(f"EDGE_1_length_123456_cov_5.0\t{p}\t{v}\n"
                   for p, v in [(1, 1), (10, 10), (100, 100), (100000, 5), (123456, 7)])
    assert text == want.encode()


def test_lines_wrong():
    a = b"x\t1\t2\nx\t2\t2\n"
    assert depth_ref.lines_wrong(a, a) == 0
    assert depth_ref.lines_wrong(b"x\t1\t2\nx\t2\t3\n", a) == 2
    assert depth_ref.lines_wrong(b"x\t1\t2\n", a) == 1
    assert depth_ref.lines_wrong(b"x\t2\t2\nx\t1\t2\n", a) == 1


def test_junction_keys():
    assert asm_ref.junction_key("b", "+", "a", "+") == ("a", "-", "b", "-")
    assert asm_ref.junction_key("a", "+", "b", "-") == ("a", "+", "b", "-")
    genomes = [{"members": ["x", "y", "z"], "circular": True},
               {"members": ["p", "q"], "circular": False}]
    assert asm_ref.planted_junctions(genomes) == {
        ("x", "+", "y", "+"), ("y", "+", "z", "+"), ("x", "-", "z", "-"), ("p", "+", "q", "+")}
    graph = "SEG\tx\t1\nJUNC\tx\t+\ty\t+\t6\t0\nJUNC\tp\t+\tq\t+\t6\t0\n"
    assert asm_ref.graph_junctions(graph) == {("x", "+", "y", "+"), ("p", "+", "q", "+")}


def test_genomes_missing():
    g = [{"name": "circ", "seq": "AACCGGTTA", "circular": True},
         {"name": "lin", "seq": "ACGTTT", "circular": False}]
    rotated_rc = asm_ref.reverse_complement("GGTTAAACC")
    assert asm_ref.genomes_missing(f">a\n{rotated_rc}\n>b\nAAA\nCGT\n", g) == []
    assert asm_ref.genomes_missing(">a\nGGTTAAACC\n>b\nAC" + "N" * 50 + "GTTT\n", g) == []
    assert asm_ref.genomes_missing(">a\nGGTTAAACC\n>b\nTTTACG\n", g) == ["lin"]
    assert asm_ref.genomes_missing(">a\nGGTTAAACCA\n", g) == ["circ", "lin"]


def test_records_wrong():
    g = [{"name": "circ", "seq": "AACCGGTTA", "circular": True, "members": ["c1", "c2"]}]
    contigs = [("c1", "AACC"), ("c2", "GGTTA"), ("big", "ACGTACG"), ("low", "TTTTTTT"),
               ("edge", "GGGGGGG"), ("short", "ACG"), ("six", "CATCAT")]
    p = {"c1": 0.1, "c2": 0.9, "big": 0.8, "low": 0.2, "edge": 0.7003, "short": 0.9,
         "six": 0.95}
    args = (g, contigs, p, 5, 0.7, 5e-4)
    rc_big = asm_ref.reverse_complement("ACGTACG")
    assert asm_ref.records_wrong(f">a\nGGTTAAACC\n>b\n{rc_big}\n>c\nCATCAT\n", *args)[0] == 0
    # the edge contig counts neither way
    assert asm_ref.records_wrong(">a\nGGTTAAACC\n>b\nACGTACG\n>c\nGGGGGGG\n>d\nCATCAT\n",
                                 *args)[0] == 0
    wrong, parts = asm_ref.records_wrong(">a\nGGTTAAACC\n>b\nTTTTTTT\n>c\nACG\n>d\nCATCAT\n",
                                         *args)
    assert wrong == 3 and parts["contigs_missing"] == 1 and parts["records_extra"] == 2
    wrong, parts = asm_ref.records_wrong(">a\nACGTACG\n>b\nACGTACG\n>c\nCATCAT\n", *args)
    assert wrong == 2 and parts["genomes_missing"] == 1 and parts["records_extra"] == 1
    # "low" at 0.9 is as long as "big": the two are one record, either of them
    p2 = dict(p, low=0.9)
    for body in ("ACGTACG", "TTTTTTT"):
        text = f">a\nGGTTAAACC\n>b\n{body}\n>c\nCATCAT\n"
        assert asm_ref.records_wrong(text, g, contigs, p2, 5, 0.7, 5e-4)[0] == 0
    both = ">a\nGGTTAAACC\n>b\nACGTACG\n>c\nTTTTTTT\n>d\nCATCAT\n"
    assert asm_ref.records_wrong(both, g, contigs, p2, 5, 0.7, 5e-4)[0] == 1
    # a lone contig as long as a genome's contig is the genome's record
    c2 = contigs + [("five", "TTTAA")]
    p3 = dict(p, five=0.9, short=0.1)
    text = ">a\nGGTTAAACC\n>b\nACGTACG\n>c\nCATCAT\n"
    assert asm_ref.records_wrong(text, g, c2, p3, 4, 0.7, 5e-4)[0] == 0
    assert asm_ref.records_wrong(text + ">e\nTTTAA\n", g, c2, p3, 4, 0.7, 5e-4)[0] == 1


# -- the readers ----------------------------------------------------------------------
@pytest.mark.parametrize("name,key", [("pipeline.search_s", "seconds:step3.search"),
                                      ("pipeline.depth_write_s", "seconds:stage:depth"),
                                      ("pipeline.graph_s", "seconds:stage:graph"),
                                      ("pipeline.matching_s", "seconds:stage:matching")])
def test_span_readers(name, key):
    read = cell.load_reader(name)
    assert read(SimpleNamespace(program={key: 6.0, "seconds:x": 1.0},
                                work={"samples": 3})) == pytest.approx(2.0)
    assert read(SimpleNamespace(program={"seconds:x": 1.0}, work={"samples": 3})) is None
    assert read(SimpleNamespace(program={key: 6.0}, work={})) is None


def test_depth_read_and_idle_readers():
    read = cell.load_reader("pipeline.depth_read_s")
    assert read(SimpleNamespace(work={"samples": 4, "depth_read_s": 10.0})) == 2.5
    assert read(SimpleNamespace(work={"samples": 4})) is None
    tr = trace.Trace(window_us=(0.0, 1e6), device=[("k", 0.0, 1e5)])
    idle = cell.load_reader("pipeline.device_idle")
    assert idle(SimpleNamespace(window_s=tr.window_s, trace=tr)) == pytest.approx(90.0)
    assert idle(SimpleNamespace(window_s=1.0, trace=trace.Trace())) is None


# -- whole runs on the CPU ---------------------------------------------------------------
@pytest.mark.parametrize("seed", [SEED, 7, 2**31 + 999])
def test_sound_run_is_correct(seed):
    """Every check within its limit on three seeds: ``planted_missing`` does
    not hang on how the random weights fall."""
    res = run(seed)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == CHECKS
    assert set(res["metrics"]) == {"pipeline_sample_s", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_traced_run_reads_the_layers():
    res = run(trace_on=True)
    assert res["correct"] is True
    # no card: the trace holds no device interval, so device_idle is left out
    assert set(res["metrics"]) == set(METRICS) - {"pipeline.device_idle"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_driver_counts_and_leaves_nothing_behind(tmp_path):
    """The counts a run reports, and a sample's directory removed by the next."""
    mod = driver_module()
    parts = tiny_parts()
    drv = mod.Driver(parts["config"], parts["mix"], SEED, CPU, tmp_path)
    try:
        drv.setup()
        inputs = {p: p.read_bytes() for p in drv.files.values() if p.suffix != ".pt"}
        (drv.run_dir / "output" / "stale.depth").write_text("x")
        drv.sample()
        assert not (drv.run_dir / "output" / "stale.depth").exists()
        assert all(p.read_bytes() == b for p, b in inputs.items())
        work = drv.work(1)
        w = drv.world
        assert work["contigs"] == len(w["contigs"]) and work["bam_records"] == w["bam"]["tid"].size
        assert work["read_pairs"] == w["reads"].shape[0] and work["refs"] == len(w["refs"])
        assert work["depth_read_s"] > 0 and work["stage_s"] > 0 and work["remove_s"] > 0
        assert len(drv.kept) == 1 and all(drv.kept[0].values())
        names = drv.launches.names
        assert names and all(n.startswith("palace_native") for n in names)
    finally:
        drv.close()


def _break(monkeypatch, module, name, wrap):
    real = getattr(module, name)
    monkeypatch.setattr(module, name, wrap(real))


def _drop_longest_record(path):
    records = Path(path).read_text().split(">")[1:]
    records.remove(max(records, key=len))
    Path(path).write_text("".join(">" + r for r in records))


def _alter_middle_line(path):
    lines = Path(path).read_bytes().split(b"\n")
    name, pos, depth = lines[len(lines) // 2].split(b"\t")
    lines[len(lines) // 2] = b"\t".join([name, pos, str(int(depth) + 1).encode()])
    Path(path).write_bytes(b"\n".join(lines))


def _drop_first_junction(path):
    lines = Path(path).read_text().splitlines(keepends=True)
    lines.remove(next(line for line in lines if line.startswith("JUNC")))
    Path(path).write_text("".join(lines))


def _add_junction(path):
    """A JUNC line between the first two contigs the graph's SEG lines name
    that no planted junction joins."""
    text = Path(path).read_text()
    segs = [line.split()[1] for line in text.splitlines() if line.startswith("SEG")]
    joined = {line.split()[1] for line in text.splitlines() if line.startswith("JUNC")}
    a, b = sorted(n for n in segs if n not in joined)[:2]
    Path(path).write_text(text + f"JUNC {a} + {b} + 6 0\n")


def _double_records(path):
    Path(path).write_text(Path(path).read_text() * 2)


def _every_score(real):
    return lambda path, min_score=0.7: real(path, -1.0)




def _score_altered(real):
    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        name, p = out[len(out) // 2]
        out[len(out) // 2] = (name, p + 0.01)
        return out
    return altered


def _half_the_batch(real):
    def half(seqs, device):
        n = len(seqs) // 2
        return real(list(seqs[:n]) + ["AAAA"] * (len(seqs) - n), device)
    return half


def _line_dropped(real):
    return lambda path, scores: real(path, list(scores)[:-1])


def _report_altered(real):
    def altered(*args, **kwargs):
        hit = real(*args, **kwargs)
        if hit is not None:
            hit.covered += 1
        return hit
    return altered


def _after(edit, arg):
    """The real function, then ``edit`` of the file its positional
    argument ``arg`` names."""
    def wrap(real):
        def broken(*args, **kwargs):
            real(*args, **kwargs)
            edit(args[arg])
        return broken
    return wrap


FAULTS = {
    "score_answer_altered": (scoring, "score_sequences", _score_altered, "prob_gap_max"),
    "score_half_the_batch": (scoring, "_host_batch", _half_the_batch, "prob_gap_max"),
    "node_scores_line_dropped": (scoring, "write_scores", _line_dropped, "contigs_misnamed"),
    "report_answer_altered": (eref, "hit_from_good", _report_altered, "report_lines_wrong"),
    # compute_depth_file(bam, out), build_graph(bam, fai, out, depth),
    # make_final_fa(txt, graph, fasta, out, prefix, ...)
    "depth_line_altered": (pipeline, "compute_depth_file", _after(_alter_middle_line, 1),
                           "depth_lines_wrong"),
    "junction_removed": (pipeline, "build_graph", _after(_drop_first_junction, 2),
                         "junctions_wrong"),
    "junction_added": (pipeline, "build_graph", _after(_add_junction, 2), "junctions_wrong"),
    "final_genome_removed": (pipeline, "make_final_fa", _after(_drop_longest_record, 3),
                             "planted_missing"),
    "final_records_doubled": (pipeline, "make_final_fa", _after(_double_records, 3),
                              "final_records_wrong"),
}


def test_length_gates_bypassed_reads_incorrect(monkeypatch):
    """Both of the last length gates (filter_cycle_gene_score's and
    corrected_dup's MIN_LEN) let short paths through."""
    gate, dedup = pipeline.filter_cycle_gene_score, pipeline.corrected_dup
    monkeypatch.setattr(pipeline, "filter_cycle_gene_score",
                        lambda path, ignore_len, *rest: gate(path, 1, *rest))
    monkeypatch.setattr(pipeline, "corrected_dup", lambda *a: dedup(*a[:-1], 0))
    res = run()
    assert res["correct"] is False
    assert res["checks"]["final_records_wrong"]["value"] > 0, res["checks"]


def test_score_gates_bypassed_reads_incorrect(monkeypatch):
    """The graph filter's score gate and the last one on a lone contig let
    every contig through: contigs of MIN_LEN bases that score under the
    gate reach the final FASTA."""
    real = pipeline.filter_graph
    monkeypatch.setattr(pipeline, "filter_graph", lambda *a: real(*a[:-1], -1.0))
    _break(monkeypatch, cycle_filter, "load_score_hits_min", _every_score)
    res = run()
    assert res["correct"] is False
    assert res["checks"]["final_records_wrong"]["value"] > 0, res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_incorrect(monkeypatch, fault):
    module, name, wrap, check = FAULTS[fault]
    _break(monkeypatch, module, name, wrap)
    res = run()
    assert res["correct"] is False
    assert res["checks"][check]["value"] > res["checks"][check]["limit"], res["checks"]


def test_external_tool_run_reads_incorrect(monkeypatch, tmp_path):
    """BLAST found and run (stand-ins that write empty output): the run is
    counted and fails the check."""
    stubs = tmp_path / "stubs"
    stubs.mkdir()
    (stubs / "makeblastdb").write_text("#!/bin/sh\nexit 0\n")
    (stubs / "blastn").write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                                  '  [ "$1" = "-out" ] && : > "$2"\n  shift\ndone\n')
    for f in stubs.iterdir():
        f.chmod(0o755)
    monkeypatch.setattr(external, "_have", lambda tool: tool in ("makeblastdb", "blastn"))
    real = external._run
    monkeypatch.setattr(external, "_run", lambda cmd, **kw: real([stubs / cmd[0], *cmd[1:]], **kw))
    res = run()
    assert res["correct"] is False and res["checks"]["external_runs"]["value"] >= 2


def test_control_fails_the_limits():
    """The control (the scorer's reference in TF32, eref's with a table one
    bit short, the depth counting soft clips) in the program's place."""
    parts = tiny_parts()
    control = dict(parts["limits"]["control"], table_bits=parts["config"]["kmer"]["k"] - 1)
    numbers, info = calibrate.readings(parts, SEED, CPU, control)
    limits = parts["limits"]["checks"]
    assert numbers["prob_gap_max"] > limits["prob_gap_max"]["limit"], numbers
    # a split read's clip at its contig's start, counted, moves its bases
    assert numbers["depth_lines_wrong"] > limits["depth_lines_wrong"]["limit"], numbers
    json.dumps(info)
