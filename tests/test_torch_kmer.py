"""The port's k-mer hashing against the JAX package's, exactly: the
coder permutation, the canonical 3-coder hashes and their validity (also
against the scalar oracle ``kmer_hashes_np``), and the 2-bit packing."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palace_tpu.ops import kmer as jkmer
from palace_tpu_torch.ops import kmer


@pytest.mark.parametrize("k,seed", [(12, 1), (16, 3), (32, 1), (32, 7)])
def test_choose_coder_and_lut_equal_jax(k, seed):
    np.testing.assert_array_equal(kmer.make_choose_coder(k, seed),
                                  jkmer.make_choose_coder(k, seed))
    np.testing.assert_array_equal(kmer.BASE_LUT, jkmer.BASE_LUT)
    np.testing.assert_array_equal(kmer.CODER_BITS, jkmer.CODER_BITS)
    assert kmer.perm_to_key(kmer.make_choose_coder(k, seed)) == \
        jkmer.perm_to_key(jkmer.make_choose_coder(k, seed))


def _seqs(rng):
    """Random reads with N bases, lowercase, IUPAC junk and a short one."""
    return ["".join(rng.choice(list(alphabet), size=n)) for alphabet, n in
            (("ACGT", 90), ("ACGTN", 90), ("acgtACGT", 90), ("ACGTRYn", 90), ("ACGT", 40))]


@pytest.mark.parametrize("k", [12, 16, 32])
def test_kmer_hashes_equal_jax_and_scalar_oracle(k):
    rng = np.random.default_rng(k)
    perm = kmer.make_choose_coder(k, seed=2)
    seqs = _seqs(rng)
    L = max(map(len, seqs))
    codes = np.full((len(seqs), L), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = kmer.seq_to_codes(s)
    got_h, got_v = kmer.kmer_hashes(torch.from_numpy(codes), perm, k)
    want_h, want_v = jkmer.kmer_hashes(jnp.asarray(codes), perm, k)
    assert got_h.dtype == torch.int64 and got_h.shape == (len(seqs), L - k + 1, 3)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h).astype(np.int64))
    assert got_v.any() and not got_v.all()
    for i, s in enumerate(seqs[:3]):
        oh, ov = jkmer.kmer_hashes_np(kmer.seq_to_codes(s), perm, k)
        M = len(s) - k + 1
        np.testing.assert_array_equal(got_v[i, :M].numpy(), ov)
        np.testing.assert_array_equal(got_h[i, :M].numpy()[ov], oh[ov].astype(np.int64))
    masked = kmer.kmer_hashes_masked(torch.from_numpy(codes), perm, k)
    assert (masked[~got_v] == 0).all() and torch.equal(masked[got_v], got_h[got_v])


def test_kmer_hashes_rows_shorter_than_k():
    h, v = kmer.kmer_hashes(torch.zeros(3, 7, dtype=torch.uint8), kmer.make_choose_coder(8), 8)
    assert h.shape == (3, 0, 3) and v.shape == (3, 0)


def test_pack_and_unpack_codes_mask_equal_jax():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 5, size=(7, 64)).astype(np.uint8)
    packed, mask = kmer.pack_codes_mask(codes)
    jpacked, jmask = jkmer.pack_codes_mask(codes)
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(mask, jmask)
    got = kmer.unpack_codes_mask(torch.from_numpy(packed), torch.from_numpy(mask))
    want = np.asarray(jkmer.unpack_codes_mask(jnp.asarray(packed), jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codes)
