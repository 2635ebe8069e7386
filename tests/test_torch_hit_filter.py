"""``scan_hits``' hit filter on the CPU: ``hit_filter`` (its plain version
here) against a numpy bitmap, including folded ones; a numpy emulation of
the kernel's filtered probe (a filter word read for every in-range hash
that is not 0, the shard read only where the hash's bit is set) equal to
``scan_hits_plain`` on real chunks, shards and filters that fold many
slots onto a bit; and the wrapper's checks of the filter it is given."""
import numpy as np
import pytest
import torch

from palace_tpu_torch.ops import kernels
from test_torch_scan import _buffers, _chunks, _world


def _numpy_filter(shard: np.ndarray, least_depth: int, max_bits: int) -> np.ndarray:
    """``shard``'s folded bitmap when ``kernels.HIT_FILTER_BITS`` is ``max_bits``."""
    fbits = max(5, min(max_bits, (shard.size - 1).bit_length()))
    bits = np.zeros(1 << fbits, bool)
    bits[np.nonzero(shard == least_depth)[0] & ((1 << fbits) - 1)] = True
    return bits


def _filter_bits(filt: kernels.HitFilter) -> np.ndarray:
    return np.unpackbits(filt.words.numpy().view(np.uint8), bitorder="little").astype(bool)


@pytest.mark.parametrize("size", [1, 31, 1000, (1 << 16) + 5])
@pytest.mark.parametrize("max_bits", [5, 8, kernels.HIT_FILTER_BITS])
@pytest.mark.parametrize("least_depth", [0, 3])
def test_hit_filter_is_the_folded_bitmap(monkeypatch, size, max_bits, least_depth):
    monkeypatch.setattr(kernels, "HIT_FILTER_BITS", max_bits)
    rng = np.random.default_rng(size + max_bits)
    shard = rng.choice(np.arange(4, dtype=np.uint8), size=size, p=[0.7, 0.1, 0.1, 0.1])
    filt = kernels.hit_filter(torch.from_numpy(shard), least_depth)
    want = _numpy_filter(shard, least_depth, max_bits)
    assert filt.fbits == int(np.log2(want.size)) and filt.words.dtype == torch.int32
    np.testing.assert_array_equal(_filter_bits(filt), want)
    assert filt.least_depth == least_depth and filt.shard[1] == size


def _filtered_probe(hashes: np.ndarray, shard: np.ndarray, lo: int, bits: np.ndarray,
                    least_depth: int) -> np.ndarray:
    """The kernel's probe of (rows, target, 3) hashes → (rows, 3, target/8)
    planes: an in-range hash that is not 0 reads its filter bit, and only a
    set bit reads the shard."""
    mine = (hashes != 0) & (hashes >= lo) & (hashes < lo + shard.size)
    off = np.where(mine, hashes - lo, 0)
    maybe = mine & bits[off & (bits.size - 1)]
    cnt = np.where(maybe, shard[np.where(maybe, off, 0)].astype(np.int64), 0x100)
    hit = cnt == least_depth
    return np.packbits(hit.transpose(0, 2, 1), axis=2, bitorder="little")


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("max_bits", [5, 9, kernels.HIT_FILTER_BITS])
def test_filtered_probe_equals_scan_hits_plain(monkeypatch, tmp_path, world, max_bits):
    """A sparse table (3 in 2 % of the slots) split as ShardedCountTable
    splits it; filters of 32 and 512 bits fold 4-512 slots onto a bit, and
    one of 2^HIT_FILTER_BITS bits holds a bit a slot."""
    monkeypatch.setattr(kernels, "HIT_FILTER_BITS", max_bits)
    k, rng = 12, np.random.default_rng(world * 100 + max_bits)
    idx, _ = _world(tmp_path, k, rng)
    table = rng.choice(np.arange(4, dtype=np.uint8), size=1 << k, p=[0.9, 0.05, 0.03, 0.02])
    size = -(-(1 << k) // world)
    packed, mask = (torch.from_numpy(a) for a in _buffers(idx))
    probed = 0
    for target, offs in _chunks(idx):
        offs = torch.from_numpy(offs)
        hashes = kernels.scan_hashes_plain(packed, mask, offs, idx.perm, k, target).numpy()
        for r in range(world):
            shard = table[r * size:(r + 1) * size]
            filt = kernels.hit_filter(torch.from_numpy(shard), 3)
            bits = _filter_bits(filt)
            got = _filtered_probe(hashes, shard, r * size, bits, 3)
            want = kernels.scan_hits_plain(packed, mask, offs, torch.from_numpy(shard), r * size,
                                           idx.perm, k, target, 3)
            np.testing.assert_array_equal(got, want.numpy())
            probed += int(((hashes != 0) & (hashes >= r * size)
                           & (hashes < r * size + shard.size)).sum())
    assert probed > 10_000


def test_scan_hits_checks_its_filter(tmp_path):
    k, rng = 12, np.random.default_rng(5)
    idx, _ = _world(tmp_path, k, rng)
    table = torch.from_numpy(rng.integers(0, 4, 1 << k).astype(np.uint8))
    packed, mask = (torch.from_numpy(a) for a in _buffers(idx))
    target, offs = _chunks(idx)[0]
    offs = torch.from_numpy(offs)
    args = (packed, mask, offs, table, 0, idx.perm, k, target, 3)
    want = kernels.scan_hits_plain(*args)
    assert torch.equal(kernels.scan_hits(*args, kernels.hit_filter(table, 3)), want)
    assert torch.equal(kernels.scan_hits(*args, None), want)  # the CPU reads the shard
    other = table.clone()
    for bad in (kernels.hit_filter(other, 3), kernels.hit_filter(table, 2),
                kernels.hit_filter(table[: 1 << 11], 3)):
        with pytest.raises(ValueError):
            kernels.scan_hits(*args, bad)
    for bad in (table.int(), table.reshape(64, 64), table[:0]):
        with pytest.raises(ValueError):
            kernels.hit_filter(bad, 3)
    for depth in (-1, 256):
        with pytest.raises(ValueError):
            kernels.hit_filter(table, depth)
