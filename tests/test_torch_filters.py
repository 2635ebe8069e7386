"""The port's filter stages against the JAX package's: every case of
tests/test_filters.py runs through both packages' functions on the same
inputs, each in its own directory; the files they write are
byte-identical and the values they return equal.  Then
``create_sub_graphs``, ``corrected_dup`` and ``make_final_fa`` run on
the intermediates of the hostile demo world (``make_demo.build_hostile``
through the JAX driver), in both packages."""
import importlib
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from _torch_jax_native import jax_native_dir  # noqa: F401  (JAX's native build, private)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

MODULES = {
    "path_fa": "assembly.path_fa", "blast_filter": "filters.blast_filter",
    "common_result": "filters.common_result", "cycle_filter": "filters.cycle_filter",
    "dedup": "filters.dedup", "final_fa": "filters.final_fa",
    "gene_matches": "filters.gene_matches", "result_filter": "filters.result_filter",
    "second_pass": "filters.second_pass", "subgraph": "filters.subgraph",
    "depth": "graph.depth", "gfilter": "graph.filter", "fasta": "io.fasta",
    "graph_io": "io.graph_io",
}
PACKAGES = ("palace_tpu", "palace_tpu_torch")


def _modules(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{v}")
                              for k, v in MODULES.items()})


def _edge(i, length, cov="5.0"):
    return f"EDGE_{i}_length_{length}_cov_{cov}"


E1, E2, E3, E4 = _edge(1, 3000), _edge(2, 5000), _edge(3, 8000), _edge(4, 12000)


def _files(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file()}


# -- the cases of tests/test_filters.py, written against a package ``m`` ------

def _assembly(m, d):
    rng = np.random.default_rng(0)
    seqs = {name: "".join(rng.choice(list("ACGT"), size=int(name.split("_")[3])))
            for name in (E1, E2, E3, E4)}
    fasta = d / "assembly_graph.fasta"
    m.fasta.write_fasta(fasta, list(seqs.items()))
    m.fasta.build_fai(fasta)
    fastg_fai = d / "assembly_graph.fastg.fai"
    fastg_fai.write_text(f"{E1}:{E2};\t3000\t0\t80\t81\n{E2};\t5000\t0\t80\t81\n")
    paths = d / "contigs.paths"
    paths.write_text("NODE_1_length_8000_cov_5\n1+,2+;\n")
    return fasta, fastg_fai, paths, seqs


def case_parse_blast_covered(m, d):
    blast = d / "x.blast"
    blast.write_text(f"{E1}\trefA\t90.0\t1500\t0\t0\t1\t1500\t1\t1500\t0\t100\n"
                     f"{E1}\trefA\t90.0\t1000\t0\t0\t1501\t2500\t1501\t2500\t0\t100\n"
                     f"{E2}\trefA\t90.0\t600\t0\t0\t1\t600\t1\t600\t0\t100\n")
    return sorted(m.gfilter.parse_blast_covered(blast, {E1: 3000, E2: 5000}, 0.7))


def case_filter_graph_seed_and_expand(m, d):
    fasta, fastg_fai, paths, _ = _assembly(m, d)
    graph_file = d / "graph.txt"
    graph_file.write_text(f"SEG {E1} 10.5 1\nSEG {E2} 8 1\nSEG {E3} 2 1\nSEG {E4} 2 1\n"
                          f"JUNC {E1} + {E2} + 9 0\nJUNC {E2} + {E3} + 7 0\n"
                          f"JUNC {E3} + {E4} + 7 0\n")
    (d / "hit_seqs.out").write_text("")
    (d / "node_scores.out").write_text(f"{E1}\t0.95\n{E2}\t0.10\n{E3}\t0.20\n{E4}\t0.10")
    (d / "a.blast").write_text("")
    m.gfilter.filter_graph(fastg_fai, graph_file, d / "filtered_pre.txt", d / "hit_seqs.out",
                           d / "node_scores.out", d / "a.blast", 0.7, str(fasta) + ".fai",
                           d / "all_hit_segs.txt", paths, 0.7)
    m.gfilter.uniq_file(d / "filtered_pre.txt", d / "filtered.txt")
    g = m.graph_io.parse_graph_file(d / "filtered.txt")
    return sorted(g.segs), len(g.juncs)


def case_make_fa_from_path(m, d):
    fasta, _, _, _ = _assembly(m, d)
    pathfile = d / "res.txt"
    pathfile.write_text(f"iter 1\n{E1}+\t{E2}-\n\n")
    return [m.path_fa.make_fa_from_path(fasta, pathfile, d / "out.fasta", 1),
            m.path_fa.make_fa_from_path(fasta, pathfile, d / "out0.fasta", 0)]


def _filter_result_inputs(d, result, gene, score):
    (d / "all_result.txt").write_text(result)
    (d / "f.blast").write_text("")
    (d / "hit_seqs.out").write_text(gene)
    (d / "node_scores.out").write_text(score)


def case_filter_result(m, d):
    fasta, _, _, _ = _assembly(m, d)
    _filter_result_inputs(d, f"{E3}+\t{E4}+\n{E2}+\n", f"{E3}\t7\n", f"{E1}\t0.95\n{E2}\t0.3\n")
    return m.result_filter.filter_result(fasta, d / "all_result.txt", d / "filtered.fasta",
                                         d / "f.blast", 0.75, d / "hit_seqs.out",
                                         d / "node_scores.out", d / "filtered_cycle.txt")


def case_filter_result_cycle_records(m, d):
    fasta, _, _, _ = _assembly(m, d)
    _filter_result_inputs(d, f"iter 1\n{E3}+\t{E4}+\n", f"{E3}\t7\n", f"{E4}\t0.95\n")
    return m.result_filter.filter_result(fasta, d / "all_result.txt", d / "filtered.fasta",
                                         d / "f.blast", 0.75, d / "hit_seqs.out",
                                         d / "node_scores.out", d / "filtered_cycle.txt")


def case_filter_cycle_gene_score(m, d):
    (d / "in.txt").write_text(f"cycle{E3}+{E4}+\n{E4}+\n{E3}+\n{E1}+\n")
    (d / "genes.txt").write_text(f"{E4}\t6\n")
    (d / "scores.txt").write_text(f"{E2}\t0.9\n")
    return m.cycle_filter.filter_cycle_gene_score(d / "in.txt", 0, d / "genes.txt",
                                                  d / "scores.txt", d / "out.txt")


def case_generate_second_with_blast(m, d):
    q = f"{E3}+{E4}+"
    (d / "filtered.blast").write_text(
        f"{q}\trefX\t95\t20000\t30000\t15000\t0\t0\t1\t15000\t1\t15000\t0\t100\n"
        f"{q}\trefY\t95\t20000\t30000\t500\t0\t0\t1\t500\t1\t500\t0\t100\n")
    return dict(m.second_pass.generate_second_with_blast(d / "filtered.blast",
                                                         d / "need_second.txt"))


def case_filter_ragtag(m, d):
    (d / "ragtag.scaffold.agp").write_text(
        "# header\n"
        f"ref1_RagTag\t1\t8000\t1\tW\t{E3}+\t1\t8000\t+\n"
        "ref1_RagTag\t8001\t8100\t2\tN\t100\tscaffold\tyes\talign_genus\n"
        f"ref1_RagTag\t8101\t20100\t3\tW\t{E4}-\t1\t12000\t-\n")
    m.second_pass.filter_ragtag(d / "ragtag.scaffold.agp", d / "part.txt", is_remain=False)
    m.second_pass.filter_ragtag(d / "ragtag.scaffold.agp", d / "remain.txt", is_remain=True)


def case_get_main_path(m, d):
    (d / "sub.second").write_text(f"SEG {E3} 5 1 0 0 1 2\nSEG {E4} 5 1 0 0 1 -2\n")
    (d / "result_cycle.txt").write_text(f"{E3}+\n{E4}+\n")
    m.second_pass.get_main_path(d / "sub.second", d / "result_cycle.txt", d / "main.txt")


def case_parse_remain(m, d):
    (d / "remain.second").write_text(f"SEG {E3} 5 1 1 0.95 1 -1\nSEG {E4} 5 1 0 0.1 1 -1\n")
    (d / "rag.txt").write_text(f"{E3}+\n{E4}+\n")
    (d / "genes.txt").write_text(f"{E3}\t9\n")
    return m.second_pass.parse_remain(d / "remain.second", d / "rag.txt", d / "res.txt", 0.6,
                                      5000, d / "before.txt", d / "genes.txt")


def case_create_sub_graphs(m, d):
    (d / "filtered_graph.txt").write_text(
        f"SEG {E3} 5 1 0 0.5 1\nSEG {E4} 6 2 1 0.9 0\nSEG {E1} 2 1 0 0 0\n"
        f"JUNC {E3} + {E4} + 9 0\nJUNC {E1} + {E3} + 6 0\n")
    (d / "need_second.txt").write_text(f"{E3}+{E4}+\trefX\n")
    (d / "pct.txt").write_text("refX\t0.95\n")
    (d / "a.blast").write_text(
        f"{E3}\trefX\t95\t8000\t0\t0\t1\t8000\t1\t8000\t0\t99\t8000\t30000\n"
        f"{E4}\trefX\t95\t12000\t0\t0\t1\t12000\t9000\t21000\t0\t99\t12000\t30000\n")
    store = m.depth.DepthStore()
    store.arrays[E3] = np.full(8000, 10, np.int32)
    store.arrays[E4] = np.full(12000, 20, np.int32)
    files = m.subgraph.create_sub_graphs(d / "filtered_graph.txt", d / "demo",
                                         d / "need_second.txt", store, d / "a.blast",
                                         d / "similar_ref.txt", d / "pct.txt")
    return [Path(f).name for f in files]


def case_reverse_string_and_common_result(m, d):
    rev = m.common_result._reverse_string(f"{E3}+{E4}-")
    (d / "r1_ragtag_scaffold_part.txt").write_text(f"{E3}+{E4}+\n")
    (d / "r2_ragtag_scaffold_part.txt").write_text(
        m.common_result._reverse_string(f"{E3}+{E4}+") + "\n")
    (d / "r3_ragtag_scaffold_part.txt").write_text(f"{E1}+\n")
    (d / "similar.txt").write_text("r1,r2,r3\n")
    (d / "final_tmp.txt").write_text("")
    return rev, m.common_result.find_most_common_result(d, d / "similar.txt",
                                                        d / "final_tmp.txt")


def case_dedup_primitives(m, d):
    fai = {"A": 5000, "B": 7000, "C": 100}
    return (m.dedup.reformat_cycle(["A+", "B+", "A+"]),
            m.dedup.find_consecutive_repeats(["A+", "A+", "B+"]),
            m.dedup.is_similar(["A+", "B+"], ["A-", "B-", "C+"], fai))


def case_smart_quota_dedup(m, d):
    e_a, e_b = "EDGE_7_length_100_cov_10.0", "EDGE_8_length_100_cov_30.0"
    return m.dedup.smart_quota_dedup(f"{e_a}+\t{e_b}+\t{e_a}+\t{e_a}+")


def case_is_circular_and_final_fa(m, d):
    rng = np.random.default_rng(1)
    seqs = {E3: "".join(rng.choice(list("ACGT"), 8000)),
            E4: "".join(rng.choice(list("ACGT"), 12000))}
    m.fasta.write_fasta(d / "edges.fasta", list(seqs.items()))
    (d / "graph.txt").write_text(f"SEG {E3} 5 1\nSEG {E4} 5 1\n"
                                 f"JUNC {E3} + {E4} + 9 0\nJUNC {E4} + {E3} + 9 0\n")
    (d / "final.txt").write_text(f"{E3}+\t{E4}+\n")
    return m.final_fa.make_final_fa(d / "final.txt", d / "graph.txt", d / "edges.fasta",
                                    d / "final.fasta", "demo")


def case_get_hits(m, d):
    (d / "prot_blast.out").write_text(
        f"gene1\t{E3}\t90\t80.0\t100\t8000\t1e-20\n"
        f"gene2\t{E3}\t50\t80.0\t100\t8000\t1e-20\n"
        f"gene3\t{E4}\t90\t70.0\t100\t8000\t1e-20\n")
    hits = {}
    m.gene_matches.get_hits(d / "prot_blast.out", hits, 0.75)
    return hits


def case_filter_remain_result(m, d):
    (d / "a.txt").write_text(f"{E3}+\t{E4}+\n{E1}+\n")
    (d / "b.txt").write_text(f"{E4}-\n")
    return m.cycle_filter.filter_remain_result(d / "a.txt", d / "b.txt", d / "out.txt")


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def test_every_case_of_the_jax_filter_tests_is_here():
    jax_tests = [l.split("(")[0][len("def test_"):]
                 for l in (Path(__file__).parent / "test_filters.py").read_text().splitlines()
                 if l.startswith("def test_")]
    assert sorted(jax_tests) == sorted(CASES) and len(CASES) == 17


@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_byte_identical(tmp_path, case):
    out = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        value = CASES[case](_modules(pkg), d)
        out[pkg] = (value, _files(d))
    (jv, jfiles), (tv, tfiles) = out["palace_tpu"], out["palace_tpu_torch"]
    assert tv == jv
    assert tfiles.keys() == jfiles.keys()
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name


# -- the hostile demo's intermediates ----------------------------------------

@pytest.fixture(scope="module")
def hostile(tmp_path_factory):
    """``make_demo.build_hostile`` run through the JAX driver: its output
    directory holds every intermediate of steps 4-6."""
    import make_demo

    from palace_tpu.config import PalaceConfig
    from palace_tpu.pipeline.driver import run_pipeline

    root = tmp_path_factory.mktemp("hostile")
    cfg = PalaceConfig.from_file(make_demo.build_hostile(root))
    run_pipeline(cfg)
    return root, cfg


def _stage_inputs(src: Path, d: Path, names) -> None:
    """Copy the world's intermediates ``names`` from ``src`` into ``d``."""
    for name in names:
        dst = d / name
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src / name, dst)


def hostile_corrected_dup(m, d, src, cfg):
    names = ["final_result/filtered_cycle_res_tmp.txt", "final_result/demo_filtered_final_tmp.txt",
             "final_result/demo_all_before_cut.txt", "02-assembly/assembly_graph.fasta.fai",
             "02-assembly/demo_reads_pe_primary.sort.bam.depth"]
    _stage_inputs(src, d, names)
    store = m.depth.DepthStore.read_text(d / names[4])
    return m.dedup.corrected_dup(d / names[0], d / names[1], d / "final.txt", d / names[3],
                                 store, d / names[2], cfg.min_len)


def hostile_make_final_fa(m, d, src, cfg):
    names = ["final_result/demo_final.txt", "04-match/demo_filtered_graph.txt",
             "02-assembly/assembly_graph.fasta"]
    _stage_inputs(src, d, names)
    return m.final_fa.make_final_fa(d / names[0], d / names[1], d / names[2],
                                    d / "final.fasta", "demo", trim_threshold=300,
                                    min_cycle_length=cfg.min_len)


def hostile_create_sub_graphs(m, d, src, cfg):
    names = ["04-match/demo_filtered_graph.txt", "05-furth/need_second_match.txt",
             "02-assembly/assembly_graph.fasta.blast", "03-search/demo_ref_percent.txt",
             "02-assembly/demo_reads_pe_primary.sort.bam.depth"]
    _stage_inputs(src, d, names)
    store = m.depth.DepthStore.read_text(d / names[4])
    (d / "sub").mkdir()
    files = m.subgraph.create_sub_graphs(d / names[0], d / "sub" / "demo", d / names[1], store,
                                         d / names[2], d / "similar_ref.txt", d / names[3])
    return [Path(f).name for f in files]


def hostile_create_sub_graphs_with_refs(m, d, src, cfg):
    """The same with blast hits of each planted contig on its reference
    (layout A, at the contig's offset in the genome) and every filtered
    cycle path sent to a second match against its reference, as blastn
    would find them: the reference subgraphs, not only ``remain``."""
    names = ["04-match/demo_filtered_graph.txt", "04-match/demo_cycle_nodup.txt",
             "03-search/demo_ref_percent.txt", "03-search/phage_refs.fasta",
             "02-assembly/assembly_graph.fasta",
             "02-assembly/demo_reads_pe_primary.sort.bam.depth"]
    _stage_inputs(src, d, names)
    refs = dict(m.fasta.iter_fasta(d / names[3]))
    contigs = dict(m.fasta.iter_fasta(d / names[4]))
    blast, need = [], []
    for ref, genome in refs.items():
        members = sorted((genome.find(s), c) for c, s in contigs.items() if s in genome)
        for start, c in members:
            L = len(contigs[c])
            blast.append(f"{c}\t{ref}\t100.0\t{L}\t0\t0\t1\t{L}\t{start + 1}\t{start + L}\t"
                         f"0.0\t{2 * L}\t{L}\t{len(genome)}\n")
        need.append("".join(f"{c}+" for _, c in members) + f"\t{ref}\n")
    (d / "a.blast").write_text("".join(blast))
    (d / "need_second.txt").write_text("".join(need))
    store = m.depth.DepthStore.read_text(d / names[5])
    (d / "sub").mkdir()
    files = m.subgraph.create_sub_graphs(d / names[0], d / "sub" / "demo", d / "need_second.txt",
                                         store, d / "a.blast", d / "similar_ref.txt",
                                         d / names[2])
    return [Path(f).name for f in files]


HOSTILE = {name[len("hostile_"):]: fn for name, fn in sorted(globals().items())
           if name.startswith("hostile_")}


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_filter_on_hostile_intermediates_byte_identical(hostile, tmp_path, case):
    root, cfg = hostile
    out = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        value = HOSTILE[case](_modules(pkg), d, root / "output", cfg)
        out[pkg] = (value, _files(d))
    (jv, jfiles), (tv, tfiles) = out["palace_tpu"], out["palace_tpu_torch"]
    assert tv == jv
    assert tfiles.keys() == jfiles.keys() and len(jfiles) > 3
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    if case == "create_sub_graphs_with_refs":
        assert {"demo_refphageAref.second", "demo_refphageBref.second"} <= set(tv)
