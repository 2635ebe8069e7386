"""The port's window scan against the JAX package's, exactly: K4's plain
version (through the wrapper, which takes it for CPU tensors) against
``good_windows_pallas`` in interpret mode, ``good_windows`` and
``good_windows_batch``; thresholds, buckets, the interval machine, the
hit line and ``scan_reference``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palace_tpu.ops import window as jwindow
from palace_tpu.ops.pallas_kernels import good_windows_pallas
from palace_tpu_torch.ops import kernels, window


def _unpack(bits, L):
    return np.unpackbits(bits.numpy(), axis=1, bitorder="little")[:, :L].astype(bool)


def _case(name, rng):
    """(counts (NB, L, 3) uint8, hashes (NB, L, 3) uint32, window, one_min,
    three_min, pallas tile)."""
    if name == "ragged_tile":      # L not a multiple of the Pallas tile
        NB, L, window_, tile = 2, 3000, 50, 512
        counts = rng.integers(0, 4, (NB, L, 3)).astype(np.uint8)
        hashes = rng.integers(0, 50, (NB, L, 3)).astype(np.uint32)
        return counts, hashes, window_, *jwindow.window_thresholds(window_, 0.5, 0.2), tile
    if name == "window_beyond_L":  # every position is in the growing prefix
        NB, L, window_, tile = 2, 400, 500, 256
        counts = rng.integers(2, 4, (NB, L, 3)).astype(np.uint8)
        hashes = rng.integers(0, 3, (NB, L, 3)).astype(np.uint32)
        return counts, hashes, window_, 150, 40, tile
    if name == "threshold_boundary":  # all hit: sums = min(j+1, window)
        NB, L, window_, tile = 1, 696, 100, 256
        counts = np.full((NB, L, 3), 3, np.uint8)
        hashes = np.ones((NB, L, 3), np.uint32)
        return counts, hashes, window_, window_, window_, tile
    if name == "all_padding":      # rows of hash 0: every coder misses
        NB, L, window_, tile = 3, 512, 64, 256
        counts = np.full((NB, L, 3), 3, np.uint8)
        hashes = np.zeros((NB, L, 3), np.uint32)
        return counts, hashes, window_, 0, 0, tile
    raise KeyError(name)


@pytest.mark.parametrize("name", ["ragged_tile", "window_beyond_L", "threshold_boundary",
                                  "all_padding"])
def test_good_windows_plain_equals_jax(name):
    rng = np.random.default_rng(len(name))
    counts, hashes, w, one_min, three_min, tile = _case(name, rng)
    NB, L, _ = counts.shape
    got_bits = kernels.good_windows(torch.from_numpy(counts),
                                    torch.from_numpy(hashes.astype(np.int64)),
                                    w, one_min, three_min)
    assert got_bits.dtype == torch.uint8 and got_bits.shape == (NB, L // 8)
    assert torch.equal(got_bits, kernels.good_windows_plain(
        torch.from_numpy(counts), torch.from_numpy(hashes.astype(np.int64)),
        w, one_min, three_min))
    got = _unpack(got_bits, L)
    batch = np.asarray(jwindow.good_windows_batch(jnp.asarray(counts), jnp.asarray(hashes),
                                                  w, one_min, three_min))
    np.testing.assert_array_equal(got, batch)
    for r in range(NB):
        c, h = jnp.asarray(counts[r]), jnp.asarray(hashes[r])
        np.testing.assert_array_equal(
            got[r], np.asarray(jwindow.good_windows(c, h, w, one_min, three_min)))
        np.testing.assert_array_equal(
            got[r], np.asarray(good_windows_pallas(c, h, w, one_min, three_min, tile=tile)))
    if name == "threshold_boundary":
        assert got[0].tolist() == [j >= w - 1 for j in range(L)]
        over = kernels.good_windows(torch.from_numpy(counts),
                                    torch.from_numpy(hashes.astype(np.int64)), w, w + 1, 0)
        assert not _unpack(over, L).any()
    if name == "all_padding":
        assert got.all()
        one = kernels.good_windows(torch.from_numpy(counts), torch.zeros(NB, L, 3, dtype=torch.int64),
                                   w, 1, 0)
        assert not _unpack(one, L).any()


def test_pack_bits_plain_is_little_endian_packbits():
    flags = np.random.default_rng(1).random((3, 40)) < 0.4
    np.testing.assert_array_equal(kernels.pack_bits_plain(torch.from_numpy(flags)).numpy(),
                                  np.packbits(flags, axis=1, bitorder="little"))
    np.testing.assert_array_equal(window.unpack_good(np.packbits(flags[1], bitorder="little"), 37),
                                  flags[1, :37])


@pytest.mark.parametrize("w,r1,r2", [(500, 0.9, 0.85), (10, 0.7, 0.7), (333, 0.51, 0.29)])
def test_window_thresholds_equal_jax(w, r1, r2):
    assert window.window_thresholds(w, r1, r2) == jwindow.window_thresholds(w, r1, r2)


def test_bucket_len_equals_jax():
    for n in [1, 100, 4096, 4097, 6000, 6144, 6145, 8192, 10000, 299_301, 1 << 20]:
        assert window.bucket_len(n) == jwindow.bucket_len(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intervals_and_hit_line_equal_jax(seed):
    rng = np.random.default_rng(seed)
    L, w = 2000, 50
    good = np.zeros(L, bool)
    pos = 0
    while pos < L:
        run = int(rng.integers(20, 400))
        good[pos:pos + run] = rng.random() < 0.5
        pos += run
    iv = window.intervals_from_good(good, L, w)
    assert iv == jwindow.intervals_from_good(good, L, w)
    el = sum(e - s for s, e in iv)
    ratio = float(np.float32(el) / np.float32(L))
    assert window.RefHit(seed + 1, len(iv), el, L, ratio).line() == \
        jwindow.RefHit(seed + 1, len(iv), el, L, ratio).line()


@pytest.mark.parametrize("hit_ratio,perfect,min_cover,n", [
    (0.5, 0.25, 0.0, 3000), (0.3, 0.02, 0.0, 3000), (0.3, 0.02, 0.5, 2900), (0.3, 0.02, 0.999, 3000)])
def test_scan_reference_equals_jax(hit_ratio, perfect, min_cover, n):
    """tests/test_kmer_search.py::test_scan_reference_full_oracle's inputs
    (a span shorter than ref_len is zero-padded to it)."""
    rng = np.random.default_rng(7)
    L = 3000
    counts = rng.integers(0, 4, (L, 3)).astype(np.uint8)[:n]
    hashes = rng.integers(0, 100, (L, 3)).astype(np.uint32)[:n]
    kw = dict(ref_index=1, ref_len=L, window=50, hit_ratio=hit_ratio,
              perfect_hit_ratio=perfect, min_cover_ratio=min_cover)
    want = jwindow.scan_reference(counts, hashes, **kw)
    got = window.scan_reference(counts, hashes, **kw, device="cpu")
    assert (got is None) == (want is None)
    assert got is None or got.line() == want.line()
    assert (got is None) == (hit_ratio == 0.5 or min_cover == 0.999)
