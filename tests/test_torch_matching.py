"""The port's matching solver against the JAX package's: on the cases and
fuzz seeds of tests/test_matching.py, with ``exact`` auto and False, the
linear and cycle files are byte-identical; so are they without networkx,
where both fall back to the handshake; ``SOLVERS`` counts the solver that
ran; and the CLI runs graph → depth → fastg2fa → matching → makefa on a
small world as the JAX CLI does."""
import random
import sys

import pytest

import chip_smoke
from palace_tpu import cli as jcli
from palace_tpu.io.paths_io import iter_path_lines as jiter_path_lines
from palace_tpu.io.paths_io import remove_duplicate_pairs as jremove_duplicate_pairs
from palace_tpu.matching import solver as jsolver
from palace_tpu_torch import cli
from palace_tpu_torch.graph import native
from palace_tpu_torch.io import paths_io
from palace_tpu_torch.matching import solver


def _seg(name, copy=1, extras=""):
    return f"SEG {name} 10 {copy}{extras}\n"


def _junc(left, lo, right, ro, support=10, span=0):
    return f"JUNC {left} {lo} {right} {ro} {support} {span}\n"


REPEAT = ("".join(_seg(n) for n in "ABCD") + _seg("R", 2) + _junc("A", "+", "R", "+", 20)
          + _junc("R", "+", "B", "+", 20) + _junc("C", "+", "R", "+", 15)
          + _junc("R", "+", "D", "+", 15))
TIE = "".join(_seg(n) for n in "ABX") + _junc("A", "+", "X", "+") + _junc("B", "+", "X", "+")
FOUR = "".join(_seg(n) for n in "ABCD") + "".join(
    _junc(a, "+", b, "+") for a, b in ("AB", "BC", "CD", "DA", "BA", "DC"))
E1, E2, E3 = (f"EDGE_{i}_length_100_cov_2.0" for i in (1, 2, 3))

# case → (graph text, [MatchingOptions kwargs]) — the graphs of tests/test_matching.py
CASES = {
    "linear_chain": ("".join(_seg(n) for n in "ABC") + _junc("A", "+", "B", "+")
                     + _junc("B", "+", "C", "+"), [{}]),
    "cycle": ("".join(_seg(n) for n in "ABC") + _junc("A", "+", "B", "+")
              + _junc("B", "+", "C", "+") + _junc("C", "+", "A", "+"), [{}]),
    "self_loop": (_seg("A") + _junc("A", "+", "A", "+"), [{}]),
    "copy_budget": (_seg("A") + _seg("R", 2) + _seg("B") + _junc("A", "+", "R", "+", 20)
                    + _junc("R", "+", "R", "+", 5) + _junc("R", "+", "B", "+", 20), [{}]),
    "end_slots": ("".join(_seg(n) for n in "ABC") + _junc("A", "+", "B", "+", 20)
                  + _junc("A", "+", "C", "+", 10), [{}]),
    "inverted_repeat_copy1": (_seg("A") + _junc("A", "+", "A", "-"), [{}]),
    "inverted_repeat_copy2": (_seg("A", 2) + _junc("A", "+", "A", "-"), [{}]),
    "ref_order": (_seg("A", 1, " 0 0 1 1") + _seg("B", 1, " 0 0 1 2") + _seg("X", 1, " 0 0 1 -1")
                  + _junc("A", "+", "B", "+", 3) + _junc("A", "+", "X", "+", 8),
                  [{}, {"subgraph": True}]),
    "hints": ("".join(_seg(n) for n in (E1, E2, E3)) + _junc(E1, "+", E2, "+", 7)
              + _junc(E1, "+", E3, "+", 5), [{"hints_path": "HINTS"}]),
    "cli_contract": ("SEG A 10 1\nSEG B 10 1\nSEG C 12 1\nSEG D 5 1\n"
                     "JUNC A + B + 9 0\nJUNC B + C + 9 0\nJUNC C + A + 9 0\nJUNC D + D + 6 0\n",
                     [{"single_graph": True}]),
    "repeat": (REPEAT, [{"iterations": i} for i in range(1, 7)]
               + [{"single_graph": True}, {"aggressive": True}]),
    "tie": (TIE, [{"single_graph": True}, {"aggressive": True}]),
    "four_cycle_tie": (FOUR, [{"aggressive": True}]),
    "tandem": (_seg("A", 2) + _junc("A", "+", "A", "+", 9), [{}]),
}


def _fuzz_graph(seed):
    """tests/test_matching.py::test_solver_structural_invariants_fuzz's graphs."""
    rnd = random.Random(seed)
    n = rnd.randint(3, 10)
    names = [f"EDGE_{i}_length_{rnd.randint(1000, 90000)}_cov_{rnd.randint(2, 40)}"
             for i in range(n)]
    text = "".join(_seg(nm, rnd.randint(1, 3)) for nm in names)
    seen = set()
    for _ in range(rnd.randint(2, 3 * n)):
        a, b = rnd.choice(names), rnd.choice(names)
        lo, ro = rnd.choice("+-"), rnd.choice("+-")
        if (a, lo, b, ro) not in seen:
            seen.add((a, lo, b, ro))
            text += _junc(a, lo, b, ro, rnd.randint(5, 60))
    return text


def _tiny_graph(seed):
    """tests/test_matching.py::_tiny_graph's graphs (the oracle seeds)."""
    rnd = random.Random(seed)
    n = rnd.randint(2, 4)
    names = [f"EDGE_{i}_length_{rnd.randint(1000, 9000)}_cov_5" for i in range(n)]
    copies = [rnd.randint(1, 2) for _ in names]
    while sum(copies) > 5:
        copies[rnd.randrange(n)] = 1
    text = "".join(_seg(nm, c) for nm, c in zip(names, copies))
    seen = set()
    for _ in range(rnd.randint(2, 2 * n + 2)):
        a, b = rnd.choice(names), rnd.choice(names)
        lo, ro = rnd.choice("+-"), rnd.choice("+-")
        if (a, lo, b, ro) not in seen:
            seen.add((a, lo, b, ro))
            text += _junc(a, lo, b, ro, rnd.randint(5, 60))
    return text


def _solve_both(tmp_path, text, kw, tag="g"):
    """Both packages' ``solve_graph_file`` on ``text``; asserts the files
    are byte-identical and returns the port's result."""
    g = tmp_path / f"{tag}.txt"
    g.write_text(text)
    kw = dict(kw)
    if kw.get("hints_path") == "HINTS":
        hints = tmp_path / "contigs.paths"
        hints.write_text("NODE_1_length_10_cov_2\n1+,3+;\n")
        kw["hints_path"] = str(hints)
    res = {}
    for name, mod in (("port", solver), ("jax", jsolver)):
        res[name] = mod.solve_graph_file(g, tmp_path / f"{tag}.{name}.lin",
                                         tmp_path / f"{tag}.{name}.cyc", mod.MatchingOptions(**kw))
    for ext in ("lin", "cyc"):
        assert (tmp_path / f"{tag}.port.{ext}").read_bytes() == \
            (tmp_path / f"{tag}.jax.{ext}").read_bytes(), (kw, ext)
    walks = {n: [(w.tokens(), w.closed) for w in r.linear + r.cycles] for n, r in res.items()}
    assert walks["port"] == walks["jax"]
    return res["port"]


@pytest.mark.parametrize("exact", [None, False])
@pytest.mark.parametrize("case", list(CASES))
def test_cases_byte_identical(tmp_path, case, exact):
    text, variants = CASES[case]
    for i, kw in enumerate(variants):
        _solve_both(tmp_path, text, dict(kw, exact=exact), tag=f"v{i}")


@pytest.mark.parametrize("exact", [None, False])
@pytest.mark.parametrize("seed", range(8))
def test_fuzz_byte_identical(tmp_path, seed, exact):
    _solve_both(tmp_path, _fuzz_graph(seed), {"exact": exact})


@pytest.mark.parametrize("seed", range(20))
def test_oracle_seeds_byte_identical(tmp_path, seed):
    text = _tiny_graph(seed)
    for exact in (None, False):
        _solve_both(tmp_path, text, {"exact": exact}, tag=f"e{exact}")


@pytest.mark.parametrize("limit", [2, 8, 16])
def test_component_split_byte_identical(tmp_path, monkeypatch, limit):
    """tests/test_matching.py::test_component_split_keeps_small_components_optimal:
    three disjoint tiny graphs solved a component at a time, with
    EXACT_END_LIMIT at 8 and 16 as there, and at 2, where every component
    of more than one segment instance takes the handshake."""
    text = ""
    for pi, seed in enumerate((3, 5, 9)):
        for line in _tiny_graph(seed).splitlines():
            f = line.split()
            f[1] = f"P{pi}_{f[1]}"
            if f[0] == "JUNC":
                f[3] = f"P{pi}_{f[3]}"
            text += " ".join(f) + "\n"
    monkeypatch.setattr(solver, "EXACT_END_LIMIT", limit)
    monkeypatch.setattr(jsolver, "EXACT_END_LIMIT", limit)
    before = dict(solver.SOLVERS)
    _solve_both(tmp_path, text, {})
    used = {k: solver.SOLVERS[k] - before[k] for k in before}
    assert sum(used.values()) >= 3
    assert (used["handshake"] > 0) == (limit == 2) and used["exact"] > 0


def test_solvers_counts_the_solver_that_ran(tmp_path):
    before = dict(solver.SOLVERS)
    _solve_both(tmp_path, REPEAT, {})
    _solve_both(tmp_path, REPEAT, {"exact": False}, tag="h")
    _solve_both(tmp_path, REPEAT, {"iterations": 3}, tag="i")
    assert solver.SOLVERS["exact"] == before["exact"] + 1
    assert solver.SOLVERS["handshake"] == before["handshake"] + 2


@pytest.mark.parametrize("case", ["repeat", "four_cycle_tie", "fuzz3"])
def test_without_networkx_both_fall_back_to_the_handshake(tmp_path, monkeypatch, case):
    monkeypatch.setitem(sys.modules, "networkx", None)
    text = _fuzz_graph(3) if case == "fuzz3" else CASES[case][0]
    before = dict(solver.SOLVERS)
    res = _solve_both(tmp_path, text, {})
    assert solver.SOLVERS["exact"] == before["exact"]
    assert solver.SOLVERS["handshake"] > before["handshake"]
    monkeypatch.undo()
    hs = solver.solve_matching(solver.parse_graph_file(tmp_path / "g.txt"),
                               solver.MatchingOptions(exact=False))
    assert [w.tokens() for w in hs.linear + hs.cycles] == \
        [w.tokens() for w in res.linear + res.cycles]


def test_paths_io_equals_jax(tmp_path):
    text, _ = CASES["cli_contract"]
    (tmp_path / "g.txt").write_text(text)
    cyc = tmp_path / "cyc.txt"
    assert cli.main(["matching", "-g", str(tmp_path / "g.txt"), "-r", str(tmp_path / "lin.txt"),
                     "-c", str(cyc), "-s", "-i", "10"]) == 0
    paths_io.remove_duplicate_pairs(cyc, tmp_path / "port.txt")
    jremove_duplicate_pairs(cyc, tmp_path / "jax.txt")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    got = [(p.tokens, p.marker) for p in paths_io.iter_path_lines(tmp_path / "port.txt")]
    assert got == [(p.tokens, p.marker) for p in jiter_path_lines(tmp_path / "jax.txt")]
    assert {m for _, m in got} == {"iter", "self"}
    toks = ["A+", "B-", "C+"]
    assert paths_io.reverse_flip(toks) == ["C-", "B+", "A-"]
    assert paths_io.path_signature(toks) == paths_io.path_signature(paths_io.reverse_flip(toks))
    assert paths_io.split_concatenated_path("A+B-C+") == toks == \
        paths_io.oriented_tokens("A+\tB- C+")


@pytest.mark.parametrize("single", [False, True])
def test_cli_path_end_to_end_on_a_small_world(tmp_path, single):
    """graph → depth → fastg2fa → matching → makefa through the port's CLI
    and the JAX package's, on chip_smoke's graph world at a small size:
    every file byte-identical."""
    world = chip_smoke.make_graph_world(tmp_path, n_contigs=60, n_records=6000, seed=5)
    outs = {}
    for pkg, name in ((cli, "port"), (jcli, "jax")):
        d = tmp_path / name
        d.mkdir()
        outs[name] = chip_smoke.run_graph_path(pkg.main, world, d, single=single)
    for f in ("depth.txt", "graph.txt", "nodes.fa", "linear.txt", "cycle.txt", "paths.fa"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert outs["port"]["avg_depth"] == outs["jax"]["avg_depth"] > 0
    graph = (tmp_path / "port" / "graph.txt").read_text()
    assert graph.count("SEG ") == 60 and graph.count("JUNC ") >= 10
    assert (tmp_path / "port" / "paths.fa").read_text().count(">") >= 10
    assert native.RUNS["graph.native"] > 0 and native.RUNS["depth.native"] > 0
