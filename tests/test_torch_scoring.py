"""The whole slice at the published width: the same FASTA through
palace_tpu's ``score_fasta`` and the port's ``score_fasta(device="cpu")``.

``init_params`` weights put every probability at about 0.507 ± 1e-3,
which would make a 2e-4 comparison close to vacuous; the d1 and d2
weights are scaled (×3, ×30) so the probabilities spread over a visible
range, and the tests assert that spread.  Float32 probabilities are held
at 2e-4 (tests/test_gcn_torch_e2e.py holds JAX to the torch oracle
there); bfloat16 at 2e-2 (inputs and weights rounded to 8 bits)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palace_tpu.models import gcn as jgcn
from palace_tpu.models import scoring as jscoring
from palace_tpu_torch import cli
from palace_tpu_torch.io.fasta import iter_fasta, write_fasta
from palace_tpu_torch.models import gcn as tgcn
from palace_tpu_torch.models import scoring as tscoring


def _contigs():
    rng = np.random.default_rng(0)

    def contig(n, probs):
        return "".join(rng.choice(list("ACGT"), size=n, p=probs))

    return [("gc_rich", contig(3000, [.1, .4, .4, .1])),
            ("at_rich", contig(2500, [.4, .1, .1, .4])),
            ("uniform", contig(4000, [.25] * 4)),
            ("repeat", "GATTACA" * 300),
            ("short", contig(150, [.25] * 4)),
            ("junk", contig(400, [.3, .2, .2, .3]) + "NNNNnnnn" + contig(400, [.25] * 4).lower()),
            ("tiny", "ACG")]


@pytest.fixture(scope="module")
def params():
    jp = jgcn.init_params(jax.random.PRNGKey(0))
    jp["d1.w"] = jp["d1.w"] * 3.0
    jp["d2.w"] = jp["d2.w"] * 30.0
    return jp, tgcn.params_from_jax({k: np.asarray(v) for k, v in jp.items()})


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("slice") / "contigs.fasta"
    write_fasta(path, _contigs(), width=60)
    return path


def test_score_fasta_equals_jax_full_width(params, fasta, tmp_path):
    jp, tp = params
    out_j, out_t = tmp_path / "jax.out", tmp_path / "port.out"
    n_j = jscoring.score_fasta(jp, fasta, out_j, batch_size=4)
    n_t = tscoring.score_fasta(tp, fasta, out_t, batch_size=4, device="cpu")
    assert n_j == n_t == len(_contigs())
    want, got = tscoring.read_scores(out_j), tscoring.read_scores(out_t)
    assert list(got) == list(want) == [name for name, _ in _contigs()]
    w, g = np.array(list(want.values())), np.array(list(got.values()))
    assert np.ptp(w) > 0.3, w  # the probabilities spread: the comparison shows something
    np.testing.assert_allclose(g, w, rtol=0, atol=2e-4)


def test_bfloat16_slice_close_to_jax(params):
    jp, tp = params
    seqs = _contigs()[:4]
    want = jscoring.score_sequences(jp, seqs, batch_size=4, dtype=jnp.bfloat16)
    got = tscoring.score_sequences(tp, seqs, batch_size=4, dtype=torch.bfloat16, device="cpu")
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], rtol=0, atol=2e-2)


def test_batching_and_fuse_k_do_not_change_scores(params):
    _, tp = params
    seqs = _contigs()
    base = tscoring.score_sequences(tp, seqs, batch_size=4, device="cpu")
    other = tscoring.score_sequences(tp, iter(seqs), batch_size=3, fuse_k=2, device="cpu")
    assert [n for n, _ in base] == [n for n, _ in other] == [n for n, _ in seqs]
    np.testing.assert_allclose([p for _, p in other], [p for _, p in base], rtol=0, atol=1e-6)
    one = tscoring.score_codes(tp, [s for _, s in seqs[:3]], device="cpu")
    np.testing.assert_allclose(one.numpy(), [p for _, p in base[:3]], rtol=0, atol=1e-6)
    assert tscoring.score_sequences(tp, [], device="cpu") == []
    with pytest.raises(ValueError):
        tscoring.score_sequences(tp, seqs, fuse_k=0, device="cpu")


def test_entry_points_refuse_to_run_without_a_card(params, fasta, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    _, tp = params
    seqs = _contigs()[:2]
    for call in (lambda: tscoring.score_sequences(tp, seqs),
                 lambda: tscoring.score_codes(tp, [s for _, s in seqs]),
                 lambda: tscoring.score_fasta(tp, fasta, tmp_path / "x.out"),
                 lambda: cli.main(["score", str(fasta), str(tmp_path / "y.out"),
                                   "--allow-random-weights"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "x.out").exists() and not (tmp_path / "y.out").exists()


def test_cli_score_on_cpu_writes_node_scores(fasta, tmp_path):
    out = tmp_path / "node_scores.out"
    assert cli.main(["score", str(fasta), str(out), "--device", "cpu",
                     "--allow-random-weights", "--batch", "4"]) == 0
    text = out.read_text()
    assert not text.endswith("\n")
    lines = text.split("\n")
    assert [ln.split("\t")[0] for ln in lines] == [n for n, _ in iter_fasta(fasta)]
    for ln in lines:
        name, p = ln.split("\t")
        assert p == f"{np.float32(float(p))}" and 0.0 <= float(p) <= 1.0
    assert cli.main(["score", str(fasta), str(out), "--device", "cpu"]) == 2


def test_write_scores_format_equals_jax(tmp_path):
    scores = [("a", 0.5), ("b", 1e-8), ("c", 0.1234567890123), ("d", 1.0)]
    jscoring.write_scores(tmp_path / "j", scores)
    tscoring.write_scores(tmp_path / "t", scores)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_resolve_dtype():
    assert tscoring.resolve_dtype(None) is None and tscoring.resolve_dtype("float32") is None
    assert tscoring.resolve_dtype("bf16") is torch.bfloat16
    assert tscoring.resolve_dtype("float16") is torch.float16
    with pytest.raises(ValueError):
        tscoring.resolve_dtype("int8")
