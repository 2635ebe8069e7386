"""The yardstick's arithmetic against hand counts at small shapes: the
metric files' operation and byte counts, the trace reader, and the plain
references' features, hashes and verdicts."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import cell, trace
from portbench.reference import eref as eref_ref
from portbench.reference import gcn as gcn_ref
from portbench.tests import _tiny

DEFAULT_GCN = {"hidden_dim": 3, "fnode_num": 64, "gcn_dim": 128, "cnn_dim": 64, "fc_dim": 100,
               "num_layers": 2, "drop_rate": 0.2, "conv_kernel": 8}
PEAKS = cell.load_json(cell.BENCH / "peaks.json")


def module(name):
    return cell.load_reader(name).__globals__


def test_k3_flops_by_hand():
    # (1, 128, 22): conv1 → 15 positions × 64 × 128 × 8, conv2 → 8 × 64 × 64 × 8,
    # conv3 → 1 × 64 × 64 × 8, two FLOPs a multiply-add
    k3 = module("score.k3_roofline")
    assert k3["flops"](1, 128, 22, 64, 8) == 2 * (15 * 64 * 128 * 8 + 8 * 64 * 64 * 8
                                                 + 1 * 64 * 64 * 8) == 2_555_904
    # bytes: input 128 × 22, weights 64·128·8 + 2·64·64·8 + 3·64, output 64 × 1, float32
    assert k3["nbytes"](1, 128, 22, 64, 8, 4) == 4 * (2816 + 65536 + 65536 + 192 + 64)


def test_k3_least_time_at_the_cells_batch():
    k3 = module("score.k3_roofline")
    # 512 × 1,070,530,560 FLOPs at 495 TFLOP/s (float32) and 989 (bfloat16)
    assert k3["least_s"](DEFAULT_GCN, 512, "float32", PEAKS) == pytest.approx(
        512 * 1_070_530_560 / 495e12)
    assert k3["least_s"](DEFAULT_GCN, 512, "bfloat16", PEAKS) == pytest.approx(
        512 * 1_070_530_560 / 989e12)


def test_k2_counts_by_hand():
    k2 = module("score.k2_roofline")
    # f = 2 (4 p-nodes), d3 = 1, gd = 2: round 0 lifts 2·2·1·2 + roots 2·4·1·2,
    # f-side 2·2·2·2 + 2·2·1·2, round 1 lifts 2·2·2·2 + roots 2·4·2·2
    assert k2["flops"](1, 2, 1, 2) == 8 + 16 + 16 + 8 + 16 + 32
    # in (4 + 2) × 1, weights 1·2·3 + 2·2·3 + 5·2, out 4 × 2; two bytes each
    assert k2["nbytes"](1, 2, 1, 2, 2) == 2 * (6 + 6 + 12 + 10 + 8)
    # at the cell's shape K2 is bound by its bytes: 1.10 GB of float32 ≈ 0.328 ms
    assert k2["least_s"](DEFAULT_GCN, 512, "float32", PEAKS) == pytest.approx(
        k2["nbytes"](512, 64, 3, 128, 4) / 3.35e12)
    assert k2["least_s"](DEFAULT_GCN, 512, "float32", PEAKS) == pytest.approx(3.28e-4, rel=0.01)


def test_model_flops_by_hand():
    mfu = module("score.mfu")
    lifts = 2 * 12288 ** 2 + 2 * 64 * 192
    sage = 2 * 64 * 3 * 128 * 2 + 2 * 4096 * 3 * 128 + 2 * 64 * 128 * 128 * 2 \
        + 2 * 4096 * 128 * 128
    convs = 2 * 64 * 8 * (4089 * 128 + 4082 * 64 + 4075 * 64)
    dense = 2 * 4075 * 64 * 100 + 2 * 100 * 2
    assert mfu["flops_per_contig"](DEFAULT_GCN) == lifts + sage + convs + dense == 1_566_361_488


def test_mfu_reading():
    read = cell.load_reader("score.mfu")
    ctx = SimpleNamespace(work={"contigs": 36_000}, window_s=1.0, peaks=PEAKS,
                          config={"gcn": DEFAULT_GCN, "score": {"dtype": "float32"}})
    assert read(ctx) == pytest.approx(100 * 36_000 * 1_566_361_488 / 495e12)
    assert read(SimpleNamespace(work={}, window_s=1.0)) is None


def test_k4_bytes_by_hand():
    k4 = module("eref.k4_roofline")
    # 800 positions: 300 B of codes and bits, 100 B of flags; 2 refs, 48 B of
    # offsets; 100 k-mers, 300 table bytes
    assert k4["nbytes"](800, 2, 100) == 748


def test_device_idle_and_gaps():
    tr = trace.Trace(window_us=(0.0, 1e6),
                     device=[("k1", 0.0, 2e5), ("k2", 1e5, 3e5), ("k1", 5e5, 6e5),
                             ("late", 9.5e5, 1.2e6)],
                     host=[("outer", 2.5e5, 9e5), ("inner", 3.5e5, 4.5e5)])
    assert tr.busy_s == pytest.approx(0.45)   # 0-0.3, 0.5-0.6, 0.95-1.0 (clipped)
    assert tr.kernel_s(["k1"]) == pytest.approx(0.3)
    assert tr.kernel_s(["nothing"]) is None
    ctx = SimpleNamespace(window_s=tr.window_s, trace=tr)
    assert cell.load_reader("score.device_idle")(ctx) == pytest.approx(55.0)
    gaps = dict(tr.idle_gaps())   # 0.3-0.5 (middle 0.4: inner), 0.6-0.95 (0.775: outer)
    assert gaps == pytest.approx({"host: inner": 0.2, "host: outer": 0.35})
    assert tr.device_ops()[0] == ["k1", pytest.approx(0.3)]


def test_gaps_named_by_another_thread_while_the_call_waits():
    call = trace.CALL_SPAN
    tr = trace.Trace(window_us=(0.0, 1e6), device=[("k", 4e5, 6e5)],
                     host=[(call, 0.0, 1e6), ("aten::mm", 7e5, 9e5)],
                     other={"bg": [("byte_batch", 1e5, 3e5)]})
    # 0-0.4 (middle 0.2: the call waits, the other thread packs), 0.6-1.0
    # (middle 0.8: the main thread's own operation)
    assert dict(tr.idle_gaps()) == pytest.approx({"host: other thread: byte_batch": 0.4,
                                                  "host: aten::mm": 0.4})


def test_parse_chrome_trace():
    events = [{"ph": "X", "name": trace.WINDOW, "cat": "user_annotation", "ts": 10, "dur": 100,
               "pid": 1, "tid": 7},
              {"ph": "X", "name": "aten::mm", "cat": "cpu_op", "ts": 20, "dur": 5, "pid": 1,
               "tid": 7},
              {"ph": "X", "name": "other thread", "cat": "cpu_op", "ts": 20, "dur": 5, "pid": 1,
               "tid": 8},
              {"ph": "X", "name": "gemm", "cat": "kernel", "ts": 30, "dur": 10, "pid": 0,
               "tid": 3},
              {"ph": "i", "name": "marker", "ts": 40}]
    tr = trace.parse(events)
    assert tr.window_us == (10.0, 110.0)
    assert tr.device == [("gemm", 30.0, 40.0)]
    assert [h[0] for h in tr.host] == [trace.WINDOW, "aten::mm"]
    assert tr.other == {(1, 8): [("other thread", 20.0, 25.0)]}


def test_features_by_hand():
    # seven A: 5 three-mers of code 0; gap 0 pairs i < 2, gap 1 i < 1, gap 2 none
    f = gcn_ref.features(["AAAAAAA", "AANAAAAA", "ac"], torch.device("cpu"))
    want = np.zeros((3, 12288), np.float32)
    want[0, 0], want[0, 4096] = 2 * 100 / 7, 100 / 7
    want[1, 0], want[1, 4096] = 2 * 100 / 8, 100 / 8   # the N dropped, the length kept
    np.testing.assert_allclose(f.numpy(), want, rtol=1e-6)


def test_round_tf32():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -3.0000001])
    assert gcn_ref.round_tf32(x).tolist() == [1.0, 1.0, 1 + 2 ** -9, -3.0]


def _scalar_hash(seq: str, perm: np.ndarray, k: int, j: int, i: int) -> int:
    """The canonical hash of slot i at position j, one base at a time."""
    bit = {"A": (1, 1, 1), "C": (0, 1, 0), "G": (0, 0, 1), "T": (1, 0, 0)}
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    fwd = sum(bit[seq[j + z]][perm[z][i]] << (k - 1 - z) for z in range(k))
    rc = sum(bit[comp[seq[j + k - 1 - z]]][perm[z][i]] << (k - 1 - z) for z in range(k))
    return min(fwd, rc)


def test_hashes_against_a_scalar_loop():
    rng = np.random.default_rng(3)
    k = 7
    seq = "".join(rng.choice(list("ACGTN"), p=[0.24, 0.24, 0.24, 0.24, 0.04], size=60))
    perm = eref_ref.coder_perm(k, 1)
    codes = torch.from_numpy(eref_ref.BASE_CODES[np.frombuffer(seq.encode(), np.uint8)])
    h, valid = eref_ref.hashes(codes, perm, k)
    for j in range(len(seq) - k + 1):
        assert bool(valid[j]) == ("N" not in seq[j:j + k])
        if valid[j]:
            assert h[j].tolist() == [_scalar_hash(seq, perm, k, j, i) for i in range(3)]


def test_count_table_saturates():
    params = {"k": 4, "least_depth": 3, "coder_seed": 1}
    reads = np.array([list(b"ACGTAC")] * 5, np.uint8)
    table = eref_ref.count_table(torch.from_numpy(eref_ref.BASE_CODES[reads]), params)
    assert table.numel() == 16 and int(table.max()) == 3
    # 3 k-mers a read, 3 hashes each, each seen 5 times: every slot hit reads 3
    assert set(table[table > 0].tolist()) == {3}


def test_verdicts_by_hand():
    params = {"window": 500, "k": 32, "min_cover_ratio": 0.75}
    L = 2500
    good = torch.zeros(L, dtype=torch.bool)
    good[1000:1200] = True
    rel = torch.arange(L)
    ref_of = torch.zeros(L, dtype=torch.long)
    # one run entered at 1000, left at 1200: [max(0, 1), min(2200, 2500)], 2199 of 2500
    assert eref_ref._verdicts(good, rel, ref_of, 0, np.array([L]), params) == [
        "ref_index\t1\t1\t2199\t2500\t0.8796"]
    good[2300:2400] = True   # starts 1300 after 2200 ends: merged; open runs close at L
    good[2450:] = True
    assert eref_ref._verdicts(good, rel, ref_of, 4, np.array([L]), params) == [
        "ref_index\t5\t1\t2499\t2500\t0.9996"]
    good[:] = False
    good[100:110] = True     # [1, 1110]: 1109 of 2500, not reported
    assert eref_ref._verdicts(good, rel, ref_of, 0, np.array([L]), params) == []


def test_window_sums_restart_at_each_reference():
    flag = torch.ones(6, dtype=torch.bool)
    start = torch.tensor([0, 0, 0, 3, 3, 3])
    assert eref_ref._window_sums(flag, start, 2).tolist() == [1, 2, 2, 1, 2, 2]


def _eref_driver():
    return cell.load_file("drivers", "eref")


def test_eref_community_is_the_mixs_whatever_the_seed():
    mod = _eref_driver()
    mix = dict(_tiny.EREF_MIX)
    c = mod.community(mix)
    assert c["reads_in"].sum() + c["reads_out"].sum() == mix["reads"]
    assert c["reads_out"].sum() == round(mix["reads"] * mix["outside_share"])
    assert c["present"].size == mix["present"] and c["out_len"].size == mix["outside_genomes"]
    a, b = mod.sample_world(mix, 1), mod.sample_world(mix, 2**31 + 5)
    assert a["reads"].shape == b["reads"].shape == (mix["reads"], mix["read_len"])
    np.testing.assert_array_equal(a["lengths"], b["lengths"])
    assert not np.array_equal(a["bases"], b["bases"])


def test_eref_reads_come_from_their_genomes():
    mod = _eref_driver()
    # no errors and nothing from outside: every read lies in a present
    # reference, on one strand or the other
    mix = dict(_tiny.EREF_MIX, outside_share=0.0, substitution_rate=0.0, reads=300)
    world = mod.sample_world(mix, 11)
    c = mod.community(mix)
    first = np.concatenate([[0], np.cumsum(world["lengths"])[:-1]])
    refs = [world["bases"][first[r]:first[r] + world["lengths"][r]].tobytes()
            for r in c["present"]]
    rc = 0
    for read in world["reads"]:
        fwd = read.tobytes()
        back = mod.COMPLEMENT[read[::-1]].tobytes()
        assert any(fwd in r or back in r for r in refs)
        rc += not any(fwd in r for r in refs)
    assert 100 < rc < 200   # about half reverse-complemented
    # substitutions: the same world with errors differs in about rate × bases
    noisy = mod.sample_world(dict(mix, substitution_rate=0.01), 11)
    changed = int((noisy["reads"] != world["reads"]).sum())
    assert 0.8 * 450 <= changed <= 450


def test_apportion_keeps_the_total():
    mod = _eref_driver()
    out = mod._apportion(10, np.array([1.0, 1.0, 1.0]))
    assert out.sum() == 10 and sorted(out.tolist()) == [3, 3, 4]


def test_driver_reports_only_its_unit():
    mod = cell.load_file("drivers", "score")
    drv = mod.Driver({}, {}, 0, _tiny.CPU, None)
    drv.contigs = [("a", "ACGT")] * 4
    got = drv.end_to_end([{"name": "contigs_per_s.x", "unit": "contigs/s"},
                          {"name": "other", "unit": "s"}], 3, 2.0)
    assert got == {"contigs_per_s.x": 6.0}
