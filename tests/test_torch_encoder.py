"""Port encoder and the plain version of the transition-count kernel (K1)
against the JAX encoder, the Pallas kernel in interpret mode, and the
reference's per-sequence loop.  Counts are integers and the scale one
IEEE division: the port's byte path and JAX ``features_from_packed(
*pack_contigs(seqs))`` must be equal bit for bit; the float64 reference
loop scales in another order, so it is held at rtol 1e-5 as
tests/test_gcn.py holds JAX to it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palace_tpu.ops import encoder as jenc
from palace_tpu.ops.pallas_kernels import transition_counts_pallas
from palace_tpu_torch.ops import encoder as tenc
from palace_tpu_torch.ops import kernels

RNG = np.random.default_rng(0)


def _random_seq(n, with_junk=False):
    alphabet = "ACGT" if not with_junk else "ACGTNacgtn"
    return "".join(RNG.choice(list(alphabet), size=n))


CASES = {
    "mixed": [_random_seq(200), _random_seq(500, with_junk=True), "ACGT", "AC",
              _random_seq(64)],
    "packed": [_random_seq(300, with_junk=True), _random_seq(77), "AC",
               _random_seq(513)],  # 513 crosses the 512 pad boundary
    "edge": ["", "A", "ACG", "ACGTA", "NNNNNNNN", _random_seq(510, with_junk=True)],
}


def _port_features(seqs):
    return tenc.features_from_bytes(*tenc.byte_batch(seqs)).numpy()


def _jax_features(seqs):
    return np.asarray(jenc.features_from_packed(*(jnp.asarray(a)
                                                  for a in jenc.pack_contigs(seqs))))


def _with_runs(n, runs):
    """``n`` random bases with ``N`` runs written over them: (start, length)."""
    s = list(_random_seq(n))
    for start, length in runs:
        s[start:start + length] = "N" * length
    return "".join(s[:n])


T = kernels.TILE_BYTES
BYTE_CASES = {
    "lower": [_random_seq(300).lower(), "acgtACGTacgt" * 20, "gattaca"],
    "iupac": ["ACGTRYSWKMBDHVN" * 30, "".join(RNG.choice(list("ACGTRYKMN"), size=700)),
              "RYRYRYACGTACGT"],
    "non_ascii": ["ACGTé" * 50, "ÅCGTTGCA→ACGT" * 20, "日本ACGTACGTACGT", "ACGT\x00ACGT"],
    "short": ["", "A", "AC", "ACG", "ACGT", "ACGTA", "ACGTAC", "ACGTACG", ""],
    "all_n": ["N" * 9, "n" * 300, "", "NNNN"],
    "n_runs_on_tile_edges": [
        _with_runs(T + 1, [(T - 3, 7)]), _with_runs(2 * T + 50, [(T - 100, 100), (2 * T, 5)]),
        _with_runs(T, [(0, 4), (T - 6, 6)]), _with_runs(3 * T, [(T - 2, T + 4)])],
    # gaps longer than the kernel's 8 KiB chunk: at a row's start, from a tile edge
    "long_gaps": ["N" * 9000 + _random_seq(5000), _with_runs(40_000, [(T, 9000)]),
                  _random_seq(T) + "n" * 9000 + _random_seq(5000),
                  "".join(RNG.choice(list("RYSWKMBDHVN"), size=9000)) + _random_seq(5000)],
    "lengths_10_to_200000": [_random_seq(int(n), with_junk=True)
                             for n in (10, 200_000, 999, 16_384, 50_000, 37)],
}


@pytest.mark.parametrize("case", sorted(BYTE_CASES))
def test_byte_path_equals_jax_packed_path(case):
    seqs = BYTE_CASES[case]
    data, offsets, lens = tenc.byte_batch(seqs)
    assert (data.dtype, offsets.dtype, lens.dtype) == (torch.uint8, torch.int64, torch.int32)
    assert bytes(data.numpy()) == "".join(seqs).encode() and offsets[-1] == data.numel()
    np.testing.assert_array_equal(lens, [len(s) for s in seqs])
    got = kernels.transition_features_bytes_plain(data, offsets, lens)
    assert got.dtype == torch.float32 and got.shape == (len(seqs), tenc.FEATURE_DIM)
    np.testing.assert_array_equal(got.numpy(), _jax_features(seqs))


def test_byte_batch_counts_characters_not_bytes():
    data, offsets, lens = tenc.byte_batch(["ACGTé", "", "日本"])
    np.testing.assert_array_equal(offsets, [0, 6, 6, 12])
    np.testing.assert_array_equal(lens, [5, 0, 2])
    empty = tenc.byte_batch([])
    assert empty[0].numel() == 0 and empty[1].tolist() == [0] and empty[2].numel() == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_packing_equals_jax(case):
    seqs = CASES[case]
    for got, want in zip(tenc.seqs_to_code_batch(seqs), jenc.seqs_to_code_batch(seqs)):
        np.testing.assert_array_equal(got, want)
    codes, _, _ = jenc.seqs_to_code_batch(seqs)
    np.testing.assert_array_equal(tenc.pack_codes(codes), jenc.pack_codes(codes))
    np.testing.assert_array_equal(tenc.pack_contigs(seqs)[0], tenc.pack_codes(codes))


@pytest.mark.parametrize("case", sorted(CASES))
def test_features_equal_jax_and_reference_loop(case):
    seqs = CASES[case]
    got = _port_features(seqs)
    np.testing.assert_array_equal(got, _jax_features(seqs))
    for i, s in enumerate(seqs):
        if len(s):
            np.testing.assert_allclose(got[i], jenc.reference_matrix_encoding(s),
                                       rtol=1e-5, atol=1e-6)
        else:
            assert not got[i].any()


def test_unpack_and_locs_equal_jax():
    seqs = CASES["packed"]
    codes, n_codes, _ = jenc.seqs_to_code_batch(seqs)
    packed = jenc.pack_codes(codes)
    got = tenc.unpack_codes(torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jenc.unpack_codes(jnp.asarray(packed))))
    locs, n_locs = tenc.locs_from_codes(got, torch.from_numpy(n_codes))
    jl, jn = jenc.locs_from_codes(jnp.asarray(codes), jnp.asarray(n_codes))
    np.testing.assert_array_equal(locs.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(n_locs.numpy(), np.asarray(jn))


@pytest.mark.parametrize("B,L,tile", [(2, 1000, 256), (3, 5000, 2048), (1, 100, 2048),
                                      (1, 600, 256)])
def test_plain_counts_equal_pallas_and_xla(B, L, tile):
    """(1, 600, 256) with n = L puts pairs across the Pallas tile edges."""
    locs = RNG.integers(0, 64, (B, L), dtype=np.int32)
    n_locs = (np.full(B, L, np.int32) if L == 600
              else RNG.integers(max(1, L // 2), L + 1, (B,), dtype=np.int32))
    got = kernels.transition_counts_plain(torch.from_numpy(locs), torch.from_numpy(n_locs))
    want_xla = np.asarray(jenc._transition_counts(jnp.asarray(locs), jnp.asarray(n_locs)))
    want_pallas = np.asarray(transition_counts_pallas(jnp.asarray(locs), jnp.asarray(n_locs),
                                                      tile=tile))
    np.testing.assert_array_equal(got.numpy(), want_xla)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    assert got.sum() > 0


def test_plain_counts_of_out_of_range_codes_equal_xla():
    """A pair with a code outside [0, 64) counts nothing, as JAX's one-hot
    gives such a code no bin (204 pairs here, where a wrong bin or row
    would count 216)."""
    locs = RNG.integers(0, 64, (2, 40), dtype=np.int32)
    locs[0, 5], locs[1, 7] = 70, -1
    n_locs = np.array([40, 40], np.int32)
    got = kernels.transition_counts_plain(torch.from_numpy(locs), torch.from_numpy(n_locs))
    want = np.asarray(jenc._transition_counts(jnp.asarray(locs), jnp.asarray(n_locs)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == want.sum() == 3 * 2 * 40 - 2 * (3 + 4 + 5) - 2 * 3 * 2

