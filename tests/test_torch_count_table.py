"""The port's flat count table against the JAX package's ``CountTable``:
after the same batches the tables are equal byte for byte, slot 0
included; saturation, a k-mer seen more than 255 times in a batch,
slot 0 on lookup, and ``add_packed`` against ``add_kmers``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palace_tpu.ops.count_table import CountTable as JCountTable
from palace_tpu.ops.kmer import kmer_hashes as jkmer_hashes
from palace_tpu_torch.ops.count_table import CountTable
from palace_tpu_torch.ops.kmer import kmer_hashes, make_choose_coder, pack_codes_mask


def _flat(jtable):
    return np.asarray(jtable.table).reshape(-1)


@pytest.mark.parametrize("k", [16, 18])
def test_table_equals_jax_after_the_same_batches(k):
    rng = np.random.default_rng(k)
    perm = make_choose_coder(k, seed=2)
    jt = JCountTable.create(k, 3)
    t = CountTable.create(k, 3, device="cpu")
    for b in range(4):
        codes = rng.integers(0, 5 if b % 2 else 4, size=(32, 48)).astype(np.uint8)
        codes[: 8 * b, :] = codes[0]  # repeated rows: multiplicities above the cap
        h, v = jkmer_hashes(jnp.asarray(codes), perm, k)
        jt = jt.add_kmers(h, v)
        assert t.add_kmers(*kmer_hashes(torch.from_numpy(codes), perm, k)) is t
        np.testing.assert_array_equal(t.table.numpy(), _flat(jt))
    assert t.table.shape == (1 << k,) and t.table.dtype == torch.uint8
    assert t.table[0] == 3 and (t.table == 1).any() and (t.table == 3).sum() > 1


def test_saturation_and_lookup():
    t = CountTable.create(12, 3, device="cpu")
    t.add_kmers(torch.tensor([[5, 5, 9], [5, 7, 9]]))
    assert t.lookup(torch.tensor([5, 7, 9, 11, 0])).tolist() == [3, 1, 2, 0, 0]
    t.add_kmers(torch.tensor([[5, 7, 7, 7, 7]]))
    assert t.lookup(torch.tensor([5, 7])).tolist() == [3, 3]
    jt = JCountTable.create(12, 3).add_kmers(jnp.asarray(np.array([[5, 5, 9], [5, 7, 9]],
                                                                  np.uint32)))
    jt = jt.add_kmers(jnp.asarray(np.array([[5, 7, 7, 7, 7]], np.uint32)))
    np.testing.assert_array_equal(t.table.numpy(), _flat(jt))


def test_hot_kmer_seen_600_times_stays_saturated():
    t = CountTable.create(12, 3, device="cpu")
    hot = torch.full((1, 600), 123, dtype=torch.int64)
    for _ in range(2):
        t.add_kmers(hot)
        assert int(t.lookup(torch.tensor([123]))[0]) == 3
    jt = JCountTable.create(12, 3).add_kmers(jnp.asarray(np.full((1, 600), 123, np.uint32)))
    np.testing.assert_array_equal(t.table.numpy(), _flat(jt.add_kmers(
        jnp.asarray(np.full((1, 600), 123, np.uint32)))))


def test_slot_zero_counts_but_always_misses():
    t = CountTable.create(12, 3, device="cpu")
    t.add_kmers(torch.zeros((1, 50), dtype=torch.int64))
    assert int(t.table[0]) == 3
    assert int(t.lookup(torch.tensor([0]))[0]) == 0
    jt = JCountTable.create(12, 3).add_kmers(jnp.asarray(np.zeros((1, 50), np.uint32)))
    np.testing.assert_array_equal(t.table.numpy(), _flat(jt))


@pytest.mark.parametrize("k", [8, 16])
def test_add_packed_equals_add_kmers(k):
    rng = np.random.default_rng(3)
    perm = make_choose_coder(k, seed=3)
    codes = rng.integers(0, 5, size=(16, 40)).astype(np.uint8)
    ref = CountTable.create(18, device="cpu").add_kmers(
        *kmer_hashes(torch.from_numpy(codes), perm, k))
    packed, mask = pack_codes_mask(codes)
    fused = CountTable.create(18, device="cpu").add_packed(packed, mask, perm, k)
    assert torch.equal(ref.table, fused.table)
    jt = JCountTable.create(18).add_packed(packed, mask, perm, k)
    np.testing.assert_array_equal(fused.table.numpy(), _flat(jt))
