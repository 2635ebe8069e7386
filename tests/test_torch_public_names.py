"""The public names of palace_tpu that the port gained last, each against
JAX on the same seeded inputs, on the CPU (every kernel wrapper takes its
plain version there): the encoder's entries from strings, 3-mer codes,
base codes and packed codes (exact, JAX's XLA route), the windows of the
eref scan (exact), ``phage_probabilities`` at reduced widths (rtol 2e-4,
atol 2e-5, as tests/test_torch_gcn.py), and the host names (equal)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palace_tpu import io as jio
from palace_tpu import ops as jops
from palace_tpu import pipeline as jpipeline
from palace_tpu.models import gcn as jgcn
from palace_tpu.models import scoring as jscoring
from palace_tpu.ops import encoder as jenc
from palace_tpu.ops import kmer as jkmer
from palace_tpu.ops import window as jwin
from palace_tpu.search import index as jindex
from palace_tpu_torch import io as tio
from palace_tpu_torch import ops as tops
from palace_tpu_torch import pipeline as tpipeline
from palace_tpu_torch.models import gcn as tgcn
from palace_tpu_torch.models import phage_probabilities
from palace_tpu_torch.models import scoring as tscoring
from palace_tpu_torch.ops import encoder as tenc
from palace_tpu_torch.ops import kmer as tkmer
from palace_tpu_torch.ops import window as twin
from palace_tpu_torch.search import index as tindex
from test_torch_gcn import _state_dict

CPU = "cpu"


def _seqs(n, seed, lo=0, hi=400, alphabet="ACGTNacgtn"):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(alphabet), size=int(m))) for m in rng.integers(lo, hi, n)]


@pytest.mark.parametrize("seq", ["", "A", "AC", "ACG", "ACGT", "NNNN", "AcGtNNacgTTA",
                                 "ANCNGNT", "acgt" * 50, "RYACGTKMNÅCGT", _seqs(1, 3)[0]])
def test_seq_to_kmer_locs_equals_jax(seq):
    got, got_len = tops.seq_to_kmer_locs(seq)
    want, want_len = jops.seq_to_kmer_locs(seq)
    assert got.dtype == want.dtype == np.int32 and got_len == want_len
    np.testing.assert_array_equal(got, want)


def _code_batch(case):
    """(locs, n_locs, seq_lens): random codes (not 3-mer chains) with n_locs
    of 0 and L and seq_lens of 0; or codes outside [0, 64)."""
    rng = np.random.default_rng(11)
    B, L = 6, 300
    locs = rng.integers(0, 64, (B, L), dtype=np.int32)
    n_locs = np.array([0, L, 5, 6, 123, L - 1], np.int32)
    lens = np.array([0, L + 2, 9, 1, 400, L], np.int32)
    if case == "out_of_range":
        locs[0, 3], locs[1, ::17], locs[2, 1], locs[4, 40:50] = 64, -1, 70, 1 << 20
    return locs, n_locs, lens


@pytest.mark.parametrize("case", ["arbitrary", "out_of_range"])
def test_transition_features_equals_jax(case):
    locs, n_locs, lens = _code_batch(case)
    got = tops.transition_features(locs, n_locs, lens, device=CPU)
    want = np.asarray(jops.transition_features(locs, n_locs, lens))
    assert got.dtype == torch.float32 and got.shape == (6, 12288)
    np.testing.assert_array_equal(got.numpy(), want)
    # tensors run where they lie
    again = tops.transition_features(*(torch.from_numpy(a) for a in (locs, n_locs, lens)))
    assert torch.equal(again, got)


@pytest.mark.parametrize("entry", ["codes", "packed"])
def test_features_from_codes_and_packed_equal_jax(entry):
    seqs = _seqs(20, 4) + ["", "A", "ACGTAC", "N" * 30]
    if entry == "codes":
        inputs = jenc.seqs_to_code_batch(seqs)
        got = tenc.features_from_codes(*inputs, device=CPU)
        want = jenc.features_from_codes(*(jnp.asarray(a) for a in inputs))
    else:
        inputs = jenc.pack_contigs(seqs)
        got = tenc.features_from_packed(*(torch.from_numpy(a) for a in inputs))
        want = jenc.features_from_packed(*(jnp.asarray(a) for a in inputs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


@pytest.mark.parametrize("n", [0, 1, 130])
def test_encode_batch_and_sequences_equal_jax(n):
    seqs = _seqs(n, 5, hi=300)
    got = tops.encode_sequences(seqs, device=CPU)
    want = jops.encode_sequences(seqs)
    assert got.dtype == np.float32 and got.shape == want.shape == (n, 12288)
    np.testing.assert_array_equal(got, want)
    if n:
        batch = tops.encode_batch(seqs[:64], device=CPU)
        np.testing.assert_array_equal(batch.numpy(), np.asarray(jops.encode_batch(seqs[:64])))
        np.testing.assert_array_equal(batch.numpy(), got[:64])


def test_reference_matrix_encoding_equals_jax():
    for s in ["A", "ACGTTGCA", "acgtNNNacgtacgt"] + _seqs(3, 6, 50, 200):
        np.testing.assert_array_equal(tenc.reference_matrix_encoding(s),
                                      jenc.reference_matrix_encoding(s))


def _window_inputs(NB, L, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(2, 5, (NB, L, 3)).astype(np.uint8)
    hashes = rng.integers(0, 1 << 32, (NB, L, 3), dtype=np.uint64).astype(np.uint32)
    hashes[:, ::5] = 0
    hashes[:, 1::5] |= np.uint32(1 << 31)
    return counts, hashes


@pytest.mark.parametrize("NB,L,window", [(3, 1001, 50), (2, 37, 500), (1, 8, 8), (4, 64, 1)])
def test_good_windows_equal_jax(NB, L, window):
    """L not a multiple of 8, windows beyond L, hash 0 and uint32 hashes at
    and above 2^31."""
    counts, hashes = _window_inputs(NB, L, NB * L + window)
    span = min(window, L)
    one_min, three_min = max(1, int(span * 0.4)), int(span * 0.02)
    got = twin.good_windows_batch(counts, hashes, window, one_min, three_min, device=CPU)
    want = np.asarray(jwin.good_windows_batch(jnp.asarray(counts), jnp.asarray(hashes), window,
                                              one_min, three_min))
    assert got.dtype == torch.bool and got.shape == (NB, L)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1
    one = twin.good_windows(torch.from_numpy(counts[0]), torch.from_numpy(hashes[0]), window,
                            one_min, three_min)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jwin.good_windows(jnp.asarray(counts[0]), jnp.asarray(hashes[0]),
                                                  window, one_min, three_min)))


def test_phage_probabilities_equals_jax():
    jcfg, tcfg = jgcn.GCNConfig(fnode_num=8), tgcn.GCNConfig(fnode_num=8)
    rng = np.random.default_rng(8)
    sd = _state_dict(jcfg, rng)
    sd["d2.weight"] *= 1e-3  # logits near 1, so that the probabilities spread
    sd["d2.bias"] *= 1e-3
    jparams = jgcn.params_from_numpy_state(sd, jcfg)
    tparams = tgcn.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})
    feats = rng.normal(0, 1, (5, jcfg.hidden_dim * jcfg.pnode_num)).astype(np.float32)
    got = phage_probabilities(tparams, torch.from_numpy(feats), tcfg)
    want = np.asarray(jgcn.phage_probabilities(jparams, jnp.asarray(feats), jcfg))
    assert got.shape == (5,) and np.ptp(want) > 0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_pack_batch_equals_jax():
    seqs = _seqs(7, 9) + ["", "ACGT"]
    for got, want in zip(tscoring.pack_batch(seqs), jscoring.pack_batch(seqs)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [5, 12])
def test_kmer_hashes_np_and_compute_hashes_for_seq_equal_jax(k):
    """With code 4 (N) inside some windows."""
    seq = "ACGTTGCANNACGTAGGCTAGCTTAGCNAGGATCCA" * 3
    perm = tkmer.make_choose_coder(k, seed=3)
    codes = tkmer.seq_to_codes(seq)
    assert (codes == 4).any()
    for got, want in zip(tkmer.kmer_hashes_np(codes, perm, k), jkmer.kmer_hashes_np(codes, perm, k)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = tindex.compute_hashes_for_seq(seq, perm, k, device=CPU)
    want = jindex.compute_hashes_for_seq(seq, perm, k)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_read_fasta_dict_and_stage_skipped_equal_jax(tmp_path):
    fa = tmp_path / "r.fa"
    fa.write_text(">a one\nACGT\nNN\n>b\n\n>c_2\nttga\n")
    assert tio.read_fasta_dict(fa) == jio.read_fasta_dict(fa) == {"a": "ACGTNN", "b": "",
                                                                  "c_2": "ttga"}
    assert issubclass(tpipeline.StageSkipped, Exception)
    assert tpipeline.StageSkipped.__doc__ == jpipeline.StageSkipped.__doc__
    with pytest.raises(tpipeline.StageSkipped):
        raise tpipeline.StageSkipped("stage")


_LOCS = np.zeros((2, 8), np.int32), np.full(2, 8, np.int32), np.full(2, 10, np.int32)
_CODES = jenc.seqs_to_code_batch(["ACGTACGT", "GATTACA"])
_WINDOWS = _window_inputs(2, 16, 0)
HOST_INPUT_ENTRIES = {
    "encode_batch": lambda: tops.encode_batch(["ACGT"]),
    "encode_sequences": lambda: tops.encode_sequences(["ACGT"]),
    "transition_features": lambda: tops.transition_features(*_LOCS),
    "features_from_codes": lambda: tenc.features_from_codes(*_CODES),
    "features_from_packed": lambda: tenc.features_from_packed(*jenc.pack_contigs(["ACGTAC"])),
    "good_windows_batch": lambda: twin.good_windows_batch(*_WINDOWS, 4, 1, 0),
    "good_windows": lambda: twin.good_windows(_WINDOWS[0][0], _WINDOWS[1][0], 4, 1, 0),
    "compute_hashes_for_seq": lambda: tindex.compute_hashes_for_seq(
        "ACGTACGTACGT", tkmer.make_choose_coder(5), 5),
}


@pytest.mark.parametrize("entry", sorted(HOST_INPUT_ENTRIES))
def test_host_input_entries_run_on_the_card_by_default(entry):
    """Given strings or numpy and no device, each entry asks for the card,
    and raises without one: it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HOST_INPUT_ENTRIES[entry]()
