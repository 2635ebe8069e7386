"""Port encoder and the plain version of the transition-count kernel (K1)
against the JAX encoder, the Pallas kernel in interpret mode, and the
reference's per-sequence loop.  Counts are integers: port and JAX must
be equal; the float64 reference loop scales in another order, so it is
held at rtol 1e-5 as tests/test_gcn.py holds JAX to it."""
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
    packed, n_codes, lens = tenc.pack_contigs(seqs)
    return tenc.features_from_packed(torch.from_numpy(packed), torch.from_numpy(n_codes),
                                     torch.from_numpy(lens)).numpy()


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
    codes, n_codes, lens = jenc.seqs_to_code_batch(seqs)
    want = np.asarray(jenc.features_from_packed(
        jnp.asarray(jenc.pack_codes(codes)), jnp.asarray(n_codes), jnp.asarray(lens)))
    np.testing.assert_array_equal(got, want)
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

