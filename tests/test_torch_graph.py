"""The port's graph stage against the JAX package's: on every case of
tests/test_graph_golden_cpp.py and tests/test_graph_builder.py the port's
native ``palace_native`` and its Python builder write graph and depth
files byte-identical to JAX's; its BAM writer and reader agree with JAX's
and raise on a truncated BAM; ``fastg2fa``, the graph filter and
``makefa`` write the same bytes; and the CLI runs the stages end to end."""
import gzip
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest

from palace_tpu.assembly.path_fa import make_fa_from_path as jmake_fa
from palace_tpu.config import GraphParams as JGraphParams
from palace_tpu.graph import builder as jbuilder
from palace_tpu.graph import depth as jdepth
from palace_tpu.graph import filter as jfilter
from palace_tpu.graph.native import ensure_native_binary as jensure_native_binary
from palace_tpu.io import bam as jbam
from palace_tpu.io import fastg as jfastg
from palace_tpu.io.fasta import build_fai as jbuild_fai
from palace_tpu.io.graph_io import write_graph_file as jwrite_graph_file
from palace_tpu_torch import cli
from palace_tpu_torch.assembly.path_fa import make_fa_from_path
from palace_tpu_torch.config import GraphParams
from palace_tpu_torch.graph import builder, depth, native
from palace_tpu_torch.graph import filter as gfilter
from palace_tpu_torch.io import bam, fastg
from palace_tpu_torch.io.fasta import build_fai
from palace_tpu_torch.io.graph_io import write_graph_file
from _torch_jax_native import jax_native_dir  # noqa: F401  (JAX's native build, private)

P, R, MR = jbam.FLAG_PAIRED, jbam.FLAG_REVERSE, jbam.FLAG_MREVERSE
REFS2 = [("ctgA", 1000), ("ctgB", 800)]
REFS3 = [("ctgA", 1000), ("ctgB", 800), ("ctgC", 2000)]
LINKED_FAI = "ctgA:ctgB;\t1000\t0\t80\t81\nctgB;\t800\t0\t80\t81\n"
SYNTH_FAI = "ctgA:ctgB;\t1000\t0\t80\t81\nctgB;\t800\t0\t80\t81\nctgC;\t2000\t0\t80\t81\n"


def _rec(name, flag, tid, pos1, cigar, mapq=60, mtid=-1, mpos1=0, tags=None):
    """A record as the JAX tests write it: positions 1-based for reading."""
    return dict(name=name, flag=flag, tid=tid, pos=pos1 - 1, mapq=mapq, cigar=cigar,
                mtid=mtid, mpos=mpos1 - 1, tlen=0,
                seq_len=sum(n for n, op in cigar if op in "MIS=X"), tags=dict(tags or {}))


def _split(name, tid, pos1, cigar, sa, flag=0, nm=0):
    return _rec(name, flag, tid, pos1, cigar, tags={"NM": nm, "SA": sa})


def _pair(name, posA, lenB=100):
    return [_rec(name, P | MR, 0, posA, [(100, "M")], mtid=1, mpos1=1, tags={"NM": 0}),
            _rec(name, P | R, 1, 1, [(lenB, "M")], mtid=0, mpos1=posA, tags={"NM": 0})]


def _layouts(n_ff=5, n_ft=5, n_tf=5, n_tt=5):
    out = []
    for i in range(max(n_ff, n_ft, n_tf, n_tt)):
        if i < n_ff:
            out.append(_split(f"ff{i}", 0, 801, [(100, "M"), (100, "S")], "ctgB,1,+,100S100M,60,0;"))
        if i < n_ft:
            out.append(_split(f"ft{i}", 0, 801, [(100, "M"), (100, "S")],
                              "ctgB,651,-,100M100S,60,0;"))
        if i < n_tf:
            out.append(_split(f"tf{i}", 0, 5, [(100, "S"), (100, "M")], "ctgB,1,+,100S100M,60,0;",
                              flag=R))
        if i < n_tt:
            out.append(_split(f"tt{i}", 0, 5, [(100, "S"), (100, "M")],
                              "ctgB,651,-,100M100S,60,0;", flag=R))
    return out


def _synthetic():
    """tests/test_graph_builder.py::_make_synthetic_bam."""
    recs = [_split(f"s{i}", 0, 901, [(50, "M"), (50, "S")], "ctgB,1,+,50S50M,60,0;")
            for i in range(6)]
    recs.append(_split("mid", 0, 500, [(50, "M"), (50, "S")], "ctgB,1,+,50S50M,60,0;"))
    recs.append(_split("badnm", 0, 901, [(50, "M"), (50, "S")], "ctgB,1,+,50S50M,60,0;", nm=9))
    for i in range(6):
        recs.append(_rec(f"p{i}", P | MR, 2, 1901, [(100, "M")], mtid=0, mpos1=6, tags={"NM": 0}))
        recs.append(_rec(f"p{i}", P | R, 0, 6, [(100, "M")], mtid=2, mpos1=1901, tags={"NM": 0}))
    recs += [_rec(f"c{i}", 0, 1, 301 + 10 * i, [(100, "M")], tags={"NM": 0}) for i in range(4)]
    return recs


def _pairs(n, posA, lenB=100, order="a"):
    pairs = [_pair(f"p{i}", posA, lenB) for i in range(n)]
    if order == "b":
        return [p[1] for p in pairs] + [p[0] for p in pairs]
    return [r for p in pairs for r in p] if order == "ab" else \
        [p[0] for p in pairs] + [p[1] for p in pairs]


# case → (refs, records, avg_depth, fastg fai text or None for linkless,
#         (max_span_frac, min_count) overrides or None)
CASES = {
    # tests/test_graph_golden_cpp.py
    "sa_stitch_gap_150": (REFS2, [_split(f"s{i}", 0, 801, [(100, "M"), (400, "S")],
                                         "ctgB,1,+,250S250M,60,0;") for i in range(5)],
                          0.5, None, None),
    "sa_stitch_gap_151": (REFS2, [_split(f"s{i}", 0, 801, [(100, "M"), (400, "S")],
                                         "ctgB,1,+,251S249M,60,0;") for i in range(5)],
                          0.5, None, None),
    "four_orientation_layouts": (REFS2, _layouts(), 1.0, None, None),
    "pair_span_frac_at_boundary": (REFS2, _pairs(5, 800, order="ab"), 1.0, None, (0.2, 5)),
    "pair_span_frac_above_boundary": (REFS2, _pairs(5, 799, order="ab"), 1.0, None, (0.2, 5)),
    "mate_credit_order_a": (REFS2, _pairs(5, 800, 60, order="a"), 0.5, None, None),
    "mate_credit_order_b": (REFS2, _pairs(5, 800, 60, order="b"), 0.5, None, None),
    "fastg_linked_pairs": (REFS2, _pairs(5, 800, order="ab"), 1.0, LINKED_FAI, None),
    "fastg_linkless_pairs": (REFS2, _pairs(5, 800, order="ab"), 1.0, None, None),
    "copy_number_half_up": (REFS3, [_rec(f"a{i}", 0, 0, 400, [(100, "M")]) for i in range(5)]
                            + [_rec(f"b{i}", 0, 1, 350, [(100, "M")]) for i in range(12)]
                            + [_rec(f"c{i}", 0, 2, 1000, [(100, "M")]) for i in range(5)],
                            1.0, None, None),
    "copy_number_zero_avg_depth": (REFS2, [_rec(f"a{i}", 0, 0, 400, [(100, "M")])
                                           for i in range(10)], 0.0, None, None),
    "min_count_five": (REFS2, _layouts(n_ft=0, n_tf=0, n_tt=0)
                       + [_split(f"y{i}", 0, 801, [(100, "M"), (100, "S")],
                                 "ctgB,651,-,100M100S,60,0;") for i in range(4)],
                       1.0, None, None),
    # tests/test_graph_builder.py
    "synthetic_avg1": (REFS3, _synthetic(), 1.0, SYNTH_FAI, None),
    "synthetic_avg2": (REFS3, _synthetic(), 2.0, SYNTH_FAI, None),
    "min_count_filter": (REFS3, [_split(f"s{i}", 0, 901, [(50, "M"), (50, "S")],
                                        "ctgB,1,+,50S50M,60,0;") for i in range(4)],
                         1.0, SYNTH_FAI, None),
    # a contig with a '+' junction to a greater name and a '-' one to a lesser
    "junction_order": (REFS3, [_split(f"x{i}", 0, 801, [(100, "M"), (100, "S")],
                                      "ctgC,1,+,100S100M,60,0;") for i in range(5)]
                       + [_split(f"y{i}", 0, 5, [(100, "S"), (100, "M")],
                                 "ctgB,1,+,100S100M,60,0;", flag=R) for i in range(5)],
                       1.0, None, None),
    "depth_store": ([("ctgA", 100)], [_rec("a", 0, 0, 1, [(50, "M")]),
                                      _rec("b", 0, 0, 26, [(50, "M")]),
                                      _rec("dup", 0x400, 0, 1, [(50, "M")])], 1.0, None, None),
}


def _bams(refs, records):
    """The same BAM in both packages' record types."""
    return (jbam.BamFile(list(refs), [jbam.BamRecord(**r) for r in records]),
            bam.BamFile(list(refs), [bam.BamRecord(**r) for r in records]))


def _fai(path: Path, refs, text):
    path.write_text(text if text is not None else
                    "".join(f"{n};\t{L}\t0\t80\t81\n" for n, L in refs))
    return path


def _native_binary():
    binary = native.ensure_native_binary()
    assert (binary is None) == (shutil.which("g++") is None)
    if binary is None:
        pytest.skip("no g++: the native arm cannot be built")
    return binary


@pytest.mark.parametrize("case", list(CASES))
def test_graph_files_byte_identical(tmp_path, case):
    """Every route writes JAX's native program's graph.  JAX's Python
    builder writes the same bytes except where a contig's JUNC lines go to
    two partners in both orientations: it sorts them by (left, orient,
    right, orient) where the reference's std::map and both native programs
    sort by (left, right, orient, orient); the port's Python builder sorts
    as the map does (``junction_order``)."""
    refs, records, avg, fai_text, over = CASES[case]
    fai = _fai(tmp_path / "g.fastg.fai", refs, fai_text)
    jb, tb = _bams(refs, records)
    jparams, params = JGraphParams(), GraphParams()
    extra = []
    if over is not None:
        jparams = JGraphParams(max_span_frac=over[0], min_count=over[1])
        params = GraphParams(max_span_frac=over[0], min_count=over[1])
        extra = [str(over[0]), str(over[1])]
    jwrite_graph_file(tmp_path / "jax.txt", jbuilder.build_graph_from_bam(jb, fai, avg, jparams))
    bam_path = tmp_path / "s.bam"
    bam.write_bam(bam_path, tb)
    subprocess.run([str(jensure_native_binary()), "graph", str(bam_path), str(fai),
                    str(tmp_path / "jcc.txt"), str(avg), *extra], check=True)
    want = (tmp_path / "jcc.txt").read_bytes()
    jax_py = (tmp_path / "jax.txt").read_bytes()
    assert (jax_py == want) == (case != "junction_order")
    assert sorted(jax_py.splitlines()) == sorted(want.splitlines())

    write_graph_file(tmp_path / "py.txt", builder.build_graph_from_bam(tb, fai, avg, params))
    assert (tmp_path / "py.txt").read_bytes() == want

    jbam.write_bam(tmp_path / "j.bam", jb)
    assert bam_path.read_bytes() == (tmp_path / "j.bam").read_bytes()
    # the streamed BAM through the Python builder, as the graph stage reads it
    write_graph_file(tmp_path / "py_stream.txt",
                     builder.build_graph_from_bam(bam_path, fai, avg, params))
    assert (tmp_path / "py_stream.txt").read_bytes() == want

    binary = _native_binary()
    subprocess.run([str(binary), "graph", str(bam_path), str(fai), str(tmp_path / "cc.txt"),
                    str(avg), *extra], check=True)
    assert (tmp_path / "cc.txt").read_bytes() == want
    if over is None:  # the stage's entry point, native and Python
        for prefer in (True, False):
            out = tmp_path / f"stage{prefer}.txt"
            native.build_graph(bam_path, fai, out, avg, prefer_native=prefer)
            assert out.read_bytes() == want


@pytest.mark.parametrize("case", ["four_orientation_layouts", "copy_number_half_up",
                                  "synthetic_avg1", "depth_store"])
def test_depth_files_byte_identical(tmp_path, case):
    refs, records, *_ = CASES[case]
    jb, tb = _bams(refs, records)
    jdepth.compute_depth(jb).write_text(tmp_path / "jax.depth")
    want = (tmp_path / "jax.depth").read_bytes()
    store = depth.compute_depth(tb)
    store.write_text(tmp_path / "py.depth")
    assert (tmp_path / "py.depth").read_bytes() == want
    bam_path = tmp_path / "s.bam"
    bam.write_bam(bam_path, tb)
    _native_binary()
    before = dict(native.RUNS)
    for prefer, route in ((True, "native"), (False, "python")):
        out = tmp_path / f"{route}.depth"
        native.compute_depth_file(bam_path, out, prefer_native=prefer)
        assert out.read_bytes() == want
        assert native.RUNS[f"depth.{route}"] == before[f"depth.{route}"] + 1
    back = depth.DepthStore.read_text(tmp_path / "py.depth")
    assert back.global_average() == jdepth.DepthStore.read_text(
        tmp_path / "jax.depth").global_average() == store.global_average()
    assert depth.average_depth_of_file(tmp_path / "py.depth") == \
        jdepth.average_depth_of_file(tmp_path / "jax.depth")
    for name in store.arrays:
        assert store.average_depth(name) == jdepth.compute_depth(jb).average_depth(name)


def test_graph_stage_counts_its_route(tmp_path):
    refs, records, avg, fai_text, _ = CASES["synthetic_avg2"]
    fai = _fai(tmp_path / "g.fai", refs, fai_text)
    bam_path = tmp_path / "s.bam"
    bam.write_bam(bam_path, _bams(refs, records)[1])
    _native_binary()
    before = dict(native.RUNS)
    native.build_graph(bam_path, fai, tmp_path / "n.txt", avg)
    native.build_graph(bam_path, fai, tmp_path / "p.txt", avg, prefer_native=False)
    assert native.RUNS["graph.native"] == before["graph.native"] + 1
    assert native.RUNS["graph.python"] == before["graph.python"] + 1
    assert (tmp_path / "n.txt").read_bytes() == (tmp_path / "p.txt").read_bytes()


def test_region_interval_and_stitch_equal_jax():
    for pos, L in ((1, 1000), (300, 1000), (301, 1000), (700, 1000), (701, 1000), (200, 400),
                   (201, 400)):
        assert builder.contig_region(pos, L, 300) == jbuilder.contig_region(pos, L, 300)
    for cigar, rev in (([(50, "M"), (50, "S")], False), ([(50, "S"), (50, "M")], False),
                       ([(50, "M"), (50, "S")], True), ([(10, "H"), (40, "M"), (5, "I")], True)):
        a = builder.parse_cigar_read_interval(cigar, rev, 100)
        b = jbuilder.parse_cigar_read_interval(cigar, rev, 100)
        assert (a.start, a.end) == (b.start, b.end)
    iv1 = builder.parse_cigar_read_interval([(50, "M"), (50, "S")], False, 100)
    iv2 = builder.parse_cigar_read_interval([(50, "S"), (50, "M")], False, 100)
    assert builder.can_stitch(iv1, iv2, 150, 150) is True
    assert builder.can_stitch(iv2, iv1, 150, 150) is False


def test_bam_reader_reads_what_jax_wrote(tmp_path):
    records = [_split(f"r{i}", i % 3, i * 7 + 1, [(40, "M"), (10, "S")],
                      "ctgB,1,+,50S50M,60,0;", nm=i % 3) for i in range(500)]
    records[3]["tags"]["XA"] = "Z"
    records[4]["tags"]["AS"] = 1.5
    jb, _ = _bams(REFS3, records)
    jbam.write_bam(tmp_path / "j.bam", jb, text="@HD\tVN:1.6\n")
    got = bam.read_bam(tmp_path / "j.bam")
    want = jbam.read_bam(tmp_path / "j.bam")
    assert got.references == want.references == REFS3
    assert [vars(r) for r in got.records] == [vars(r) for r in want.records]
    with bam.BamStream(tmp_path / "j.bam") as s:
        assert [vars(r) for r in s] == [vars(r) for r in want.records]
    assert got.name_to_tid() == want.name_to_tid()
    r = got.records[0]
    assert (r.cigar_string(), r.ref_len(), r.read_len(), r.match_len()) == ("40M10S", 40, 50, 40)


def _record_boundaries(payload: bytes):
    off = 8 + struct.unpack_from("<i", payload, 4)[0]
    (n_ref,) = struct.unpack_from("<i", payload, off)
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<i", payload, off)[0]
    out = [off]
    while off < len(payload):
        off += 4 + struct.unpack_from("<i", payload, off)[0]
        out.append(off)
    return out


@pytest.mark.parametrize("cut,raises", [(2, True), (10, True), (0, False)])
def test_truncated_bam(tmp_path, cut, raises):
    """tests/test_graph_builder.py::test_bam_stream_truncation_raises: 2
    stray bytes after the 5th record, or a record cut in its body, raise in
    both packages' readers; a cut on a record boundary reads 5 records."""
    records = [_rec(f"r{i}", 0, 0, i + 1, [(40, "M")], tags={"NM": 0}) for i in range(20)]
    path = tmp_path / "t.bam"
    bam.write_bam(path, _bams(REFS3, records)[1])
    payload = gzip.decompress(path.read_bytes())
    cut_at = _record_boundaries(payload)[5] + cut
    bad = tmp_path / "cut.bam"
    bad.write_bytes(gzip.compress(payload[:cut_at]))
    for pkg in (bam, jbam):
        if raises:
            with pytest.raises(ValueError, match="truncated"):
                with pkg.BamStream(bad) as s:
                    list(s)
        else:
            with pkg.BamStream(bad) as s:
                assert len(list(s)) == 5
    with pytest.raises(ValueError, match="not a BAM"):
        (tmp_path / "x.bam").write_bytes(gzip.compress(b"SAM\x01" + b"\0" * 8))
        bam.BamStream(tmp_path / "x.bam")


FASTG = """>EDGE_1_length_60_cov_5.5:EDGE_2_length_45_cov_3.0';
ACGTACGTTTGACCAGTAGGACCATTAGGACCAGATTTACCAGGACAGTTACGACAGTAC
>EDGE_1_length_60_cov_5.5':EDGE_3_length_50_cov_2.0;
GTACTGTCGTAACTGTCCTGGTAAATCTGGTCCTAATGGTCCTACTGGTCAAACGTACGT
>EDGE_2_length_45_cov_3.0:EDGE_1_length_60_cov_5.5',EDGE_3_length_50_cov_2.0;
ttgacgatcgatcagctagctacgatcgactagcatcgactagca
>EDGE_2_length_45_cov_3.0';
TGCTAGTCGATGCTAGTCGATCGTAGCTAGCTGATCGATCGTCAA
>EDGE_3_length_50_cov_2.0;
ACGGTACCAGTTGACACCATGGTTTGACCAGTGGATCACAGTTGACCAGT
>EDGE_3_length_50_cov_2.0':EDGE_1_length_60_cov_5.5;
ACTGGTCAACTGTGATCCACTGGTCAAACCATGGTGTCAACTGGTACCGT
"""


def test_fastg_to_node_fasta_and_pairs_equal_jax(tmp_path):
    fg = tmp_path / "g.fastg"
    fg.write_text(FASTG)
    assert fastg.fastg_to_node_fasta(fg, tmp_path / "port.fa") == \
        jfastg.fastg_to_node_fasta(fg, tmp_path / "jax.fa") == 3
    assert (tmp_path / "port.fa").read_bytes() == (tmp_path / "jax.fa").read_bytes()
    jbuild_fai(fg, tmp_path / "g.fastg.fai")
    fai = tmp_path / "g.fastg.fai"
    assert fastg.parse_fastg_pairs(fai) == jfastg.parse_fastg_pairs(fai)
    assert len(fastg.parse_fastg_pairs(fai)) > 0
    assert fastg.parse_fastg_neighbours(fai) == jfastg.parse_fastg_neighbours(fai)


PATHS = ("iter\nEDGE_1_length_60_cov_5.5+\tEDGE_2_length_45_cov_3.0-\n"
         "self\nEDGE_3_length_50_cov_2.0+\n\n"
         "EDGE_3_length_50_cov_2.0-\tEDGE_1_length_60_cov_5.5_x+\t \n"
         "EDGE_2_length_45_cov_3.0+\n")


@pytest.mark.parametrize("mode", [0, 1, "0", "1"])
def test_makefa_byte_identical(tmp_path, mode):
    fg = tmp_path / "g.fastg"
    fg.write_text(FASTG)
    fastg.fastg_to_node_fasta(fg, tmp_path / "nodes.fa")
    (tmp_path / "paths.txt").write_text(PATHS)
    n = make_fa_from_path(tmp_path / "nodes.fa", tmp_path / "paths.txt", tmp_path / "port.fa",
                          mode)
    (tmp_path / "nodes.fa.fai").unlink()
    m = jmake_fa(tmp_path / "nodes.fa", tmp_path / "paths.txt", tmp_path / "jax.fa", mode)
    assert n == m == 4
    assert (tmp_path / "port.fa").read_bytes() == (tmp_path / "jax.fa").read_bytes()
    (tmp_path / "bad.txt").write_text("EDGE_9_length_1_cov_1+\n")
    with pytest.raises(KeyError):
        make_fa_from_path(tmp_path / "nodes.fa", tmp_path / "bad.txt", tmp_path / "x.fa", mode)


def test_fasta_store_equals_jax(tmp_path):
    from palace_tpu.io.fasta import FastaStore as JFastaStore
    from palace_tpu_torch.io.fasta import FastaStore

    fa = tmp_path / "w.fa"
    fa.write_text(">a desc\nACGTN\nGG\n>b_1\nttga\n>c\n\n")
    build_fai(fa)
    s, j = FastaStore(fa), JFastaStore(fa)
    assert s.names() == j.names() == ["a", "b_1", "c"]
    for tok in ("a+", "a-", "a", "b_1_7-", " b_1 +", "c-", "-"):
        assert s.fetch_oriented(tok) == j.fetch_oriented(tok)
    assert [s.length(n) for n in s.names()] == [j.length(n) for n in j.names()] == [7, 4, 0]
    assert s.index.lengths() == j.index.lengths()
    s.close()
    j.close()


def _filter_world(tmp_path: Path):
    """A graph filter input: six SPAdes edges, a blast table, gene hits,
    scores (one in scientific notation) and contigs.paths."""
    names = [f"EDGE_{i}_length_{L}_cov_{c}" for i, (L, c) in
             enumerate([(3000, 5.0), (1500, 2.5), (800, 9.0), (2500, 1.0), (600, 3.0),
                        (4000, 7.0)], start=1)]
    fa = tmp_path / "nodes.fa"
    rng = np.random.default_rng(3)
    fa.write_text("".join(f">{n}\n{''.join(rng.choice(list('ACGT'), int(n.split('_')[3])))}\n"
                          for n in names))
    jbuild_fai(fa, tmp_path / "nodes.fa.fai")
    (tmp_path / "graph.txt").write_text(
        "".join(f"SEG {n} {1.5 + i} {1 + i % 2}\n" for i, n in enumerate(names))
        + f"SEG {names[0]}x 1e-07 1\n"
        + f"JUNC {names[0]} + {names[1]} + 9 0\nJUNC {names[1]} + {names[2]} - 6 1\n"
        + f"JUNC {names[3]} - {names[4]} + 5 0\nJUNC {names[4]} + {names[4]} + 7 0\n"
        + f"JUNC {names[2]} + {names[5]} + 5 2\n")
    (tmp_path / "blast.tsv").write_text(
        f"{names[0]}\tref1\t99.0\t2000\t0\t0\t1\t2000\t1\t2000\t0.0\t3000\n"
        f"{names[0]}\tref1\t98.0\t900\t0\t0\t2001\t2900\t2001\t2900\t0.0\t1500\n"
        f"{names[3]}\tref2\t60.0\t2400\t0\t0\t1\t2400\t1\t2400\t0.0\t800\n"
        f"{names[5]}\tref2\t95.0\t2100\t0\t0\t1\t2100\t1\t2100\t0.0\t3000\n")
    (tmp_path / "genes.out").write_text(f"{names[2]}\tgeneX\n\n")
    (tmp_path / "scores.out").write_text(f"{names[1]}\t0.93\n{names[3]}\t1.2e-05\n"
                                         f"{names[4]}\t0.71\n")
    (tmp_path / "contigs.paths").write_text("NODE_1_length_4000_cov_5\n1+,2+;\n4-\n"
                                            "NODE_2_length_600_cov_3\n5+,6+;\n")
    return tmp_path


@pytest.mark.parametrize("threshold", [0.7, 0.95])
def test_filter_graph_byte_identical(tmp_path, threshold):
    w = _filter_world(tmp_path)
    outs = {}
    for name, fn in (("port", gfilter.filter_graph), ("jax", jfilter.filter_graph)):
        fn(w / "g.fastg.fai", w / "graph.txt", w / f"{name}_f.txt", w / "genes.out",
           w / "scores.out", w / "blast.tsv", 0.7, w / "nodes.fa.fai", w / f"{name}_hits.txt",
           w / "contigs.paths", threshold)
        gfilter.uniq_file(w / f"{name}_f.txt", w / f"{name}_u.txt")
        outs[name] = [(w / f"{name}_{s}.txt").read_bytes() for s in ("f", "hits", "u")]
    assert outs["port"] == outs["jax"] and outs["port"][0]
    fai_len = {n: int(L) for n, L, *_ in (l.split("\t") for l in
                                           (w / "nodes.fa.fai").read_text().splitlines())}
    for ratio, both in ((0.7, False), (0.5, True)):
        assert gfilter.parse_blast_covered(w / "blast.tsv", fai_len, ratio, require_both=both) \
            == jfilter.parse_blast_covered(w / "blast.tsv", fai_len, ratio, require_both=both)


def test_blast_reader_equals_jax(tmp_path):
    from palace_tpu.io.blast import read_outfmt6 as jread
    from palace_tpu_torch.io.blast import read_outfmt6

    w = _filter_world(tmp_path)
    (w / "b.tsv").write_text("q\ts\t99.5\t300\t310\t400\t2\t1\t10\t309\t5\t305\t1e-50\t500.5\n"
                             "short\tline\n")
    for path, layout in ((w / "blast.tsv", "a"), (w / "b.tsv", "b")):
        got, want = list(read_outfmt6(path, layout)), list(jread(path, layout))
        assert [vars(h) for h in got] == [vars(h) for h in want] and got
        assert [(h.s_lo, h.s_hi, h.q_lo, h.q_hi, h.plus_strand) for h in got] == \
            [(h.s_lo, h.s_hi, h.q_lo, h.q_hi, h.plus_strand) for h in want]


def test_cli_graph_depth_fastg2fa(tmp_path, capsys):
    from palace_tpu import cli as jcli

    refs, records, avg, fai_text, _ = CASES["synthetic_avg2"]
    fai = _fai(tmp_path / "g.fai", refs, fai_text)
    bam_path = tmp_path / "s.bam"
    bam.write_bam(bam_path, _bams(refs, records)[1])
    fg = tmp_path / "g.fastg"
    fg.write_text(FASTG)
    for pkg, name in ((cli, "port"), (jcli, "jax")):
        assert pkg.main(["graph", str(bam_path), str(fai), str(tmp_path / f"{name}.graph"),
                         "--avg-depth", str(avg)]) == 0
        assert pkg.main(["depth", str(bam_path), str(tmp_path / f"{name}.depth")]) == 0
        assert pkg.main(["fastg2fa", str(fg), str(tmp_path / f"{name}.fa")]) == 0
        assert capsys.readouterr().err.endswith("3 nodes\n")
    for ext in ("graph", "depth", "fa"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    assert "JUNC ctgA + ctgB + 6 0" in (tmp_path / "port.graph").read_text()
