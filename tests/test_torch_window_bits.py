"""``window_hits``' bit-parallel window stage (``csrc/good_windows.cu``
``window_hits_kernel``), emulated in numpy step for step, against
``window_hits_plain`` and, on one case, JAX's ``good_windows_pallas`` in
interpret mode.

The kernel cannot run on a CPU.  The emulation does what its blocks do: a
tile of 32-bit output words of a row and the ``ceil(window / 32) + 1``
halo words before it; single = p0 | p1 | p2 and trio = p0 & p1 & p2 a
word (0 before the row and past it, and a row whose plane bytes are not a
multiple of 4 read a byte at a time at its tail); an exclusive prefix of
the words' popcounts; for output word o, x = 32 o - window, P(x) = the
prefix of x's word plus the popcount of its bits below x, the sum ending
at 32 o - 1 = P[o] - P(x), then bit b of word o added and bit b of the 32
bits from x (a funnel shift of two words) taken away, 32 flags a word.
Tiles of 4 and 16 words split a window over several tiles."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palace_tpu.ops.pallas_kernels import good_windows_pallas
from palace_tpu_torch.ops import kernels

KERNEL_TILE_WORDS = 256  # csrc/good_windows.cu kWinWords
WINDOWS = [1, 31, 32, 33, 500, 8193, kernels.GOOD_WINDOWS_MAX_WINDOW]
TARGETS = [4096, 6144, 12288, 24576]


def plane_words(planes: np.ndarray) -> np.ndarray:
    """(rows, 3, nbytes) uint8 → (rows, 3, ceil(nbytes / 4)) uint32, word w
    = bytes 4w..4w+3 little-endian, the missing bytes of a tail word 0 (the
    kernel's byte loads)."""
    rows, _, nbytes = planes.shape
    pad = -nbytes % 4
    padded = np.pad(planes, ((0, 0), (0, 0), (0, pad))).astype(np.uint32)
    b = padded.reshape(rows, 3, -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def popc(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x.astype(np.uint32)).astype(np.int64)


def window_hits_bits(planes: np.ndarray, window: int, one_min: int, three_min: int,
                     tile_words: int = KERNEL_TILE_WORDS) -> np.ndarray:
    """The bit-parallel window stage as the kernel's blocks run it, every
    (row, tile) at once → (rows, nbytes) uint8 flags."""
    rows, _, nbytes = planes.shape
    words = plane_words(planes)
    nwords = words.shape[2]
    single = words[:, 0] | words[:, 1] | words[:, 2]
    trio = words[:, 0] & words[:, 1] & words[:, 2]
    halo = (window + 31) // 32 + 1
    n_tiles = -(-nwords // tile_words)
    w0 = np.arange(n_tiles) * tile_words                     # a tile's first output word
    ext = w0[:, None] - halo + np.arange(halo + tile_words)  # (tiles, entries): the word
    inside = (ext >= 0) & (ext < nwords)
    at = np.clip(ext, 0, nwords - 1)
    sw = np.where(inside, single[:, at], 0).astype(np.uint32)  # (rows, tiles, entries)
    tw = np.where(inside, trio[:, at], 0).astype(np.uint32)
    sp = np.cumsum(popc(sw), axis=2) - popc(sw)                # exclusive prefixes
    tp = np.cumsum(popc(tw), axis=2) - popc(tw)
    i = halo + np.arange(tile_words)                           # entry of output word o
    rel = 32 * i - window                                      # x - 32 e0
    assert rel.min() >= 32
    xi, xs = rel >> 5, (rel & 31).astype(np.uint32)
    below = ((np.uint64(1) << xs.astype(np.uint64)) - np.uint64(1)).astype(np.uint32)

    def funnel(w_):  # bits [x, x + 32): word xi >> xs | word xi+1 << (32 - xs)
        lo = w_[:, :, xi].astype(np.uint64)
        hi = w_[:, :, xi + 1].astype(np.uint64)
        return (((hi << np.uint64(32)) | lo) >> xs.astype(np.uint64)).astype(np.uint32)

    s_win = sp[:, :, i] - sp[:, :, xi] - popc(sw[:, :, xi] & below)
    t_win = tp[:, :, i] - tp[:, :, xi] - popc(tw[:, :, xi] & below)
    s_in, t_in, s_out, t_out = sw[:, :, i], tw[:, :, i], funnel(sw), funnel(tw)
    out = np.zeros(s_win.shape, np.uint32)
    for b in range(32):
        bit = np.uint32(b)
        s_win = s_win + ((s_in >> bit) & 1) - ((s_out >> bit) & 1)
        t_win = t_win + ((t_in >> bit) & 1) - ((t_out >> bit) & 1)
        out |= ((s_win >= one_min) & (t_win >= three_min)).astype(np.uint32) << bit
    flags = out.reshape(rows, -1)[:, :nwords]
    as_bytes = np.stack([(flags >> np.uint32(8 * b)) & 0xFF for b in range(4)], axis=2)
    return as_bytes.reshape(rows, -1)[:, :nbytes].astype(np.uint8)


def random_planes(rng, rows: int, target: int) -> np.ndarray:
    """(rows, 3, target / 8) hit planes whose hit rate runs from 0.6 to 1 in
    stretches of 700 positions, so that windows both pass and fail."""
    rate = rng.uniform(0.6, 1.0, (rows, 1, -(-target // 700)))
    rate = np.repeat(rate, 700, axis=2)[:, :, :target]
    bits = rng.random((rows, 3, target)) < rate
    return np.packbits(bits, axis=2, bitorder="little")


def thresholds(window: int, target: int) -> tuple:
    span = min(window, target)
    return (1, 1) if span == 1 else (int(0.9 * span), int(0.5 * span))


def _plain(planes, window, one_min, three_min):
    return kernels.window_hits_plain(torch.from_numpy(planes), window, one_min,
                                     three_min).numpy()


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("window", WINDOWS)
def test_bit_parallel_window_equals_plain(window, target):
    rng = np.random.default_rng(window * 7 + target)
    planes = random_planes(rng, 3, target)
    one_min, three_min = thresholds(window, target)
    want = _plain(planes, window, one_min, three_min)
    for tile_words in (KERNEL_TILE_WORDS, 16, 4):  # 4 words split every window above 96
        got = window_hits_bits(planes, window, one_min, three_min, tile_words)
        np.testing.assert_array_equal(got, want, err_msg=f"tile of {tile_words} words")
    flags = np.unpackbits(want, axis=1, bitorder="little")
    assert 0 < flags.mean() < 1


@pytest.mark.parametrize("target", [8, 6152, 24584])
def test_bit_parallel_window_byte_tail(target):
    """Targets that are a multiple of 8 but not of 32: the last word of a
    row is read a byte at a time and stored a byte at a time."""
    rng = np.random.default_rng(target)
    planes = random_planes(rng, 2, target)
    for window in (1, 33, 500):
        one_min, three_min = thresholds(window, target)
        want = _plain(planes, window, one_min, three_min)
        got = window_hits_bits(planes, window, one_min, three_min, 16)
        assert got.shape == (2, target // 8)
        np.testing.assert_array_equal(got, want)


def test_bit_parallel_window_edge_rows():
    """All hits, no hits, and hits only in the last word: the growing
    prefix, sums of 0, and a window that reaches back past position 0."""
    target, window = 4096, 500
    planes = np.zeros((3, 3, target // 8), np.uint8)
    planes[0] = 0xFF
    planes[2, :, -4:] = 0xFF
    for one_min, three_min in ((window, window), (0, 0), (1, 1), (32, 32)):
        want = _plain(planes, window, one_min, three_min)
        np.testing.assert_array_equal(window_hits_bits(planes, window, one_min, three_min, 4),
                                      want)
    flags = np.unpackbits(_plain(planes, window, window, window), axis=1, bitorder="little")
    assert flags[0].tolist() == [j >= window - 1 for j in range(target)]
    assert not flags[1:].any()


def test_bit_parallel_window_equals_pallas():
    """One row against JAX's Pallas kernel in interpret mode: counts =
    least_depth and hash = 1 where a plane's bit is set, 0 elsewhere."""
    target, window, least_depth = 6144, 500, 3
    rng = np.random.default_rng(15)
    planes = random_planes(rng, 1, target)
    one_min, three_min = thresholds(window, target)
    got = window_hits_bits(planes, window, one_min, three_min)
    bits = np.unpackbits(planes[0], axis=1, bitorder="little").T.astype(bool)  # (L, 3)
    counts = np.where(bits, least_depth, 0).astype(np.uint8)
    hashes = bits.astype(np.uint32)
    want = np.asarray(good_windows_pallas(jnp.asarray(counts), jnp.asarray(hashes), window,
                                          one_min, three_min, least_depth, tile=4096))
    np.testing.assert_array_equal(np.unpackbits(got[0], bitorder="little").astype(bool), want)
    assert 0 < want.mean() < 1
