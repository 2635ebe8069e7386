"""On a CUDA card: each kernel of ``palace_tpu_torch.ops.kernels`` against
its plain version on the same inputs, and the scorer's forward through
the kernels against the forward through the plain versions.

The file imports neither JAX nor palace_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are ``palace_tpu_torch.ops.compare.TOLERANCES``: float32 1e-4;
bfloat16 2e-3 and float16 1e-3, with rare rounding steps of one ulp of an
intermediate; the conv head at large outputs is held to its float64 sums
within ``CONV_LARGE_OUTPUTS``, the SAGE rounds where their intermediates
reach 4..8 to their plain version within ``SAGE_LARGE_INTERMEDIATES``.
Transition counts are integers and must be equal.  Without
a card every test skips."""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from _tf32 import conv_tf32
from palace_tpu_torch.models import gcn as tgcn
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.compare import (CONV_LARGE_OUTPUTS, SAGE_LARGE_INTERMEDIATES,
                                          TOLERANCES, compare)
from palace_tpu_torch.ops.encoder import byte_batch

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run "
                    "pytest --noconftest -m cuda tests/test_torch_cuda.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, dtype):
    res = compare(got, want, TOLERANCES[dtype])
    assert res["ok"], res


def _bytes_on(seqs, device):
    return [t.to(device) for t in byte_batch(seqs)]


def _random_bases(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=int(n)))


def _n_runs_on_tile_edges(rng, tile):
    """Rows of 1-4 tiles with N runs (1-120 long) across each tile edge."""
    rows = []
    for n_tiles in (1, 2, 3, 4):
        s = list(_random_bases(rng, n_tiles * tile + int(rng.integers(0, 97))))
        for edge in range(tile, len(s), tile):
            run = int(rng.integers(1, 121))
            start = edge - int(rng.integers(0, run + 1))
            s[max(start, 0):start + run] = "N" * len(s[max(start, 0):start + run])
        rows.append("".join(s))
    return rows + ["", "ACGTNNNNNNNNACG", _random_bases(rng, 300, "ACGTNn")]


def _long_gaps(rng):
    """Gaps longer than the kernel's 8 KiB chunk, at the start of a row and
    from a tile edge (``kernels.TILE_BYTES``), of N, n and IUPAC codes: a
    chunk of a tile with no base in it."""
    T, rows = kernels.TILE_BYTES, []
    for gap in ("N" * 9000, "n" * 9000, _random_bases(rng, 9000, "RYSWKMBDHVN")):
        rows += [gap + _random_bases(rng, 5000),
                 _random_bases(rng, T) + gap + _random_bases(rng, 40_000 - T - 9000)]
    return rows


def _byte_cases(tile):
    rng = np.random.default_rng(2)
    short = [_random_bases(rng, n, "ACGTNacgtn") for n in rng.integers(0, 3000, 40)]
    return {
        "long_gaps": _long_gaps(rng),
        "n_runs_on_tile_edges": _n_runs_on_tile_edges(rng, tile),
        "one_tile_and_one_tile_plus_one": [_random_bases(rng, tile), _random_bases(rng, tile + 1),
                                           "AC", _random_bases(rng, tile - 1)],
        "one_mbp_among_short": short[:20] + [_random_bases(rng, 1_000_000, "ACGTN")] + short[20:],
        "low_complexity": ["A" * 50_000, "AT" * 25_000, "CAG" * 16_667, _random_bases(rng, 900)],
        "non_ascii": ["ACGTé" * 4000, "日本ACGTACGT" * 10, "ÅCGTTGCA→ACGT" * 300],
        "empty_rows": ["", "", ""],
    }


@pytest.mark.cuda
def test_card_transition_features_equal_plain(cuda):
    """Ragged random rows with N runs, and short and empty rows."""
    rng = np.random.default_rng(2)
    seqs = [_random_bases(rng, n, "ACGTN") for n in rng.integers(0, 3000, 64)] + [
        "", "AC", "ACG", "ACGTAC", "N" * 9]
    batch = _bytes_on(seqs, cuda)
    before = kernels.LAUNCHES["transition_counts"]
    got = kernels.transition_features_bytes(*batch)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["transition_counts"] == before + 1
    assert torch.equal(got, kernels.transition_features_bytes_plain(*batch))
    assert got.sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [kernels.TILE_BYTES, 1000])
@pytest.mark.parametrize("case", ["n_runs_on_tile_edges", "one_tile_and_one_tile_plus_one",
                                  "one_mbp_among_short", "low_complexity", "non_ascii",
                                  "empty_rows", "long_gaps"])
def test_card_transition_features_bytes_cases_equal_plain(cuda, case, tile, monkeypatch):
    """Each case at the main path's tile and at 1000 bytes, where every
    row of more than 1000 bytes spreads over several blocks."""
    seqs = _byte_cases(tile)[case]
    batch = _bytes_on(seqs, cuda)
    monkeypatch.setattr(kernels, "TILE_BYTES", tile)
    before = kernels.LAUNCHES["transition_counts"]
    got = kernels.transition_features_bytes(*batch)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["transition_counts"] == before + 1
    assert got.shape == (len(seqs), 12288)
    assert torch.equal(got, kernels.transition_features_bytes_plain(*batch))


@pytest.mark.cuda
def test_card_transition_features_hold_bad_offsets_inside_the_data(cuda):
    """Offsets that run backwards or past the data read nothing outside it:
    row 1 (backwards) counts nothing, row 2 stops at the data's end."""
    seqs = ["ACGTACGTAC", "GGCATTACGT"]
    data, offsets, lens = _bytes_on(seqs, cuda)
    bad = torch.tensor([0, 10, 5, 1 << 40], dtype=torch.int64, device=cuda)
    got = kernels.transition_features_bytes(data, bad, torch.cat([lens, lens[:1]]))
    torch.cuda.synchronize()
    want = kernels.transition_features_bytes_plain(data, offsets, lens)
    assert torch.equal(got[0], want[0]) and not got[1].any()
    row2 = kernels.transition_features_bytes_plain(
        data[5:], torch.tensor([0, 15], device=cuda), lens[:1])
    assert torch.equal(got[2], row2[0])


@pytest.mark.cuda
def test_card_host_batch_is_pinned_and_equal_to_byte_batch(cuda):
    from palace_tpu_torch.models.scoring import _host_batch

    seqs = ["ACGTé", "", "NNNNACGT" * 100]
    host = _host_batch(seqs, cuda)
    assert all(t.is_pinned() for t in host)
    for got, want in zip(host, byte_batch(seqs)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_card_transition_features_of_no_rows_launch_nothing(cuda):
    batch = _bytes_on([], cuda)
    before = kernels.LAUNCHES["transition_counts"]
    assert kernels.transition_features_bytes(*batch).shape == (0, 12288)
    assert kernels.LAUNCHES["transition_counts"] == before


def _code_cases(tile):
    """(B, L) int32 codes and (B,) n_locs: random codes (not 3-mer chains),
    ragged n_locs with 0, L and more than L; rows of several tiles with
    n_locs at the tile edges; codes outside [0, 64)."""
    rng = np.random.default_rng(5)
    L = 3 * tile + 37
    ragged = rng.integers(0, 64, (9, 700), dtype=np.int32)
    edges = rng.integers(0, 64, (8, L), dtype=np.int32)
    bad = rng.integers(0, 64, (4, L), dtype=np.int32)
    bad[rng.random(bad.shape) < 0.05] = -1
    bad[0, ::97], bad[1, tile - 3:tile + 3], bad[2, -5:] = 64, 1 << 30, -(1 << 31)
    bad[3, ::5] = 70
    return {
        "ragged": (ragged, np.array([0, 1, 3, 4, 5, 6, 350, 700, 9000], np.int32)),
        "tile_edges": (edges, np.array([tile - 6, tile - 5, tile, tile + 5, 2 * tile + 1,
                                        3 * tile, L, L + 1], np.int32)),
        "out_of_range": (bad, np.array([L, L - 1, L, tile + 4], np.int32)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [kernels.TILE_CODES, 1000])
@pytest.mark.parametrize("case", ["ragged", "tile_edges", "out_of_range"])
def test_card_transition_counts_codes_equal_plain(cuda, case, tile, monkeypatch):
    """K1's padded-codes entry at the main path's tile and at 1000 codes,
    where rows of more than 1000 spread over several blocks: equal to its
    plain version, one launch counted under ``transition_counts_codes``."""
    locs, n_locs = (torch.from_numpy(a).to(cuda) for a in _code_cases(tile)[case])
    monkeypatch.setattr(kernels, "TILE_CODES", tile)
    before = dict(kernels.LAUNCHES)
    got = kernels.transition_counts(locs, n_locs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["transition_counts_codes"] == before["transition_counts_codes"] + 1
    assert kernels.LAUNCHES["transition_counts"] == before["transition_counts"]
    assert got.shape == (locs.shape[0], 3, 64, 64) and got.dtype == torch.float32
    assert torch.equal(got, kernels.transition_counts_plain(locs, n_locs))
    assert got.sum() > 0


@pytest.mark.cuda
def test_card_transition_features_of_codes_equal_the_byte_entry(cuda):
    """``transition_features`` on a batch's ``seq_to_kmer_locs``, padded,
    and ``features_from_codes``/``features_from_packed``: each one launch
    of the codes entry, bit-equal to the byte entry on the same contigs."""
    from palace_tpu_torch.ops import encoder

    rng = np.random.default_rng(6)
    seqs = [_random_bases(rng, n, "ACGTNacgt") for n in rng.integers(0, 3000, 40)] + ["", "AC"]
    want = encoder.features_from_bytes(*_bytes_on(seqs, cuda))
    locs = [encoder.seq_to_kmer_locs(s)[0] for s in seqs]
    padded = np.zeros((len(seqs), max(map(len, locs)) + 3), np.int32)
    for i, row in enumerate(locs):
        padded[i, :len(row)] = row
    lens = np.array([len(s) for s in seqs], np.int32)
    n_locs = np.array([len(row) for row in locs], np.int32)
    codes, n_codes, orig = encoder.seqs_to_code_batch(seqs)
    runs = {"transition_features": lambda: encoder.transition_features(padded, n_locs, lens),
            "features_from_codes": lambda: encoder.features_from_codes(codes, n_codes, orig),
            "features_from_packed": lambda: encoder.features_from_packed(
                *encoder.pack_contigs(seqs))}
    for name, run in runs.items():
        kernels.reset_launches()
        got = run()
        torch.cuda.synchronize()
        assert got.device.type == "cuda", name
        assert kernels.LAUNCHES["transition_counts_codes"] == 1, name
        assert torch.equal(got, want), name


@pytest.mark.cuda
def test_card_transition_counts_raises_instead_of_falling_back(cuda):
    locs = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    n_locs = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    for bad in ((locs.long(), n_locs), (locs[0], n_locs), (locs, n_locs.long()),
                (locs, n_locs[:1]), (locs, n_locs.cpu())):
        with pytest.raises(ValueError):
            kernels.transition_counts(*bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 4, 133])
def test_card_sage_rounds_close_to_plain(cuda, dtype, B):
    """One row; four; and 133, one row past a full wave of 132 blocks, so
    the ragged last wave and two blocks an SM (16-bit) both run.
    float32 is the 3×TF32 route, held to 1e-4 with no steps; the plain
    version's products run in full float32, with
    ``torch.backends.cuda.matmul.allow_tf32`` False."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(3)
    p = tgcn.init_params(g)
    p["ln.scale"] = 1 + 0.2 * torch.randn(128, generator=g)
    p["ln.bias"] = 0.2 * torch.randn(128, generator=g)
    xp = torch.randn(B, 4096, 3, generator=g).to(cuda, dtype)
    xf = torch.randn(B, 64, 3, generator=g).to(cuda, dtype)
    w = tgcn.sage_weight_stack(p, dtype).to(cuda)
    before = kernels.LAUNCHES["sage_rounds"]
    got = kernels.sage_rounds(xp, xf, w)
    want = kernels.sage_rounds_plain(xp, xf, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sage_rounds"] == before + 1
    assert got.dtype == dtype and got.shape == (B, 4096, 128)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_sage_rounds_where_intermediates_reach_4_to_8(cuda, dtype):
    """The previous test's inputs at a batch of 512: round 1's activations
    and their LayerNorm reach 4..8, where a rounding step is one ulp of
    that magnitude, 2^-8 in float16 (``SAGE_LARGE_INTERMEDIATES``).
    float32 is held to the default 1e-4 with no steps, against a plain
    version whose products run with ``torch.backends.cuda.matmul.allow_tf32``
    False."""
    torch.backends.cuda.matmul.allow_tf32 = False
    xp, xf, w = chip_smoke.large_sage_inputs(chip_smoke.SAGE_ROUNDING_BATCH, dtype, cuda)
    assert 4 <= chip_smoke.sage_peak(xp, xf, w) < 8
    res = compare(kernels.sage_rounds(xp, xf, w), kernels.sage_rounds_plain(xp, xf, w),
                  SAGE_LARGE_INTERMEDIATES[dtype])
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,C0,L", [(3, 128, 4096), *chip_smoke.RAGGED_CONV_SHAPES])
def test_card_conv_head_close_to_plain(cuda, dtype, B, C0, L):
    """The main shape; a ragged one (L_out not a multiple of the 128- or
    256-position tile, rows not 16-byte aligned); the smallest (L_out = 1);
    and a first layer of 64 channels (``chip_smoke.py`` runs the same).

    Weights and biases are drawn at the scale ``init_params`` gives them,
    U(±1/sqrt(C·8)), so the layers' outputs stay of order 1, the magnitude
    ``TOLERANCES`` is stated for.  Larger outputs are the next test's."""
    x, ws, bs = chip_smoke.init_scale_conv_inputs((B, C0, L), dtype, cuda)
    before = kernels.LAUNCHES["conv_head"]
    got = kernels.conv_head(x, ws, bs)
    want = kernels.conv_head_plain(x, ws, bs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_head"] == before + 3  # one launch a layer
    assert got.shape == (B, 64, L - 21) and got.is_contiguous()
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_conv_head_large_outputs_within_budget_of_float64(cuda, dtype):
    """N(0, 1) activations and N(0, 0.1) weights put the outputs near 40,
    where one ulp of bf16 is 2^-2 and float32 sums taken in different
    orders round some outputs apart, cuDNN's included.  The kernel and the
    plain version are held to the float64 sums within
    ``CONV_LARGE_OUTPUTS``; one mma chain a tile, rounding toward zero,
    falls outside it: in 16 bits the chain of 16-deep products, in float32
    the 3×TF32 chain (``tests/_tf32.py``)."""
    x, ws, bs = chip_smoke.large_conv_inputs((3, 128, 4096), dtype, cuda)
    exact, tol = chip_smoke.conv_sums(x, ws, bs, torch.float64), CONV_LARGE_OUTPUTS[dtype]
    assert float(exact.float().abs().max()) > 30
    got = compare(kernels.conv_head(x, ws, bs), exact, tol)
    assert got["ok"], got
    plain = compare(kernels.conv_head_plain(x, ws, bs), exact, tol)
    assert plain["ok"], plain
    one_chain = (conv_tf32(x, ws, bs, chain_per_slice=False) if dtype == torch.float32
                 else chip_smoke.one_mma_chain(x, ws, bs))
    control = compare(one_chain, exact, tol)
    assert not control["ok"], control


@pytest.mark.cuda
def test_card_conv_head_raises_on_widths_the_16bit_kernel_does_not_take(cuda):
    x = torch.zeros(1, 96, 64, device=cuda, dtype=torch.bfloat16)
    ws = [torch.zeros(64, c, 8, device=cuda, dtype=torch.bfloat16) for c in (96, 64, 64)]
    bs = [torch.zeros(64, device=cuda, dtype=torch.bfloat16) for _ in range(3)]
    before = kernels.LAUNCHES["conv_head"]
    with pytest.raises(ValueError):
        kernels.conv_head(x, ws, bs)
    with pytest.raises(ValueError):  # 128 channels only in a channel-major first layer
        kernels.conv_layer(torch.zeros(1, 64, 128, device=cuda, dtype=torch.bfloat16),
                           torch.zeros(64, 128, 8, device=cuda, dtype=torch.bfloat16), bs[0],
                           in_channel_major=False, out_channel_major=False)
    with pytest.raises(ValueError):  # the 16-bit kernel takes the three-layer head
        kernels.conv_head(torch.zeros(1, 64, 64, device=cuda, dtype=torch.bfloat16),
                          ws[1:], bs[1:])
    assert kernels.LAUNCHES["conv_head"] == before


@pytest.mark.cuda
def test_card_forward_through_kernels_close_to_plain(cuda):
    """Full width, float32, with d1/d2 scaled so the logits spread."""
    g = torch.Generator(device=cuda).manual_seed(5)
    p = tgcn.init_params(g)
    p["d1.w"] *= 3.0
    p["d2.w"] *= 30.0
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGT"), size=3000, p=q))
            for q in ([.1, .4, .4, .1], [.4, .1, .1, .4], [.25] * 4, [.3, .2, .2, .3])]
    x_p, x_f = tgcn.model_inputs_from_features(
        kernels.transition_features_bytes(*_bytes_on(seqs, cuda)))
    got = tgcn.forward(p, x_p, x_f, return_logits=True)
    want = tgcn.forward(p, x_p, x_f, return_logits=True, plain=True)
    torch.cuda.synchronize()
    assert float((want[:, 1] - want[:, 0]).max() - (want[:, 1] - want[:, 0]).min()) > 0.05
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_card_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros(1, 128, 64, device=cuda, dtype=torch.float64)
    ws = [torch.zeros(64, c, 8, device=cuda, dtype=torch.float64) for c in (128, 64, 64)]
    bs = [torch.zeros(64, device=cuda, dtype=torch.float64) for _ in range(3)]
    with pytest.raises(ValueError):
        kernels.conv_head(x, ws, bs)
    with pytest.raises(ValueError):
        kernels.sage_rounds(torch.zeros(1, 8, 3, device=cuda), torch.zeros(1, 2, 3, device=cuda),
                            torch.zeros(kernels.sage_stack_rows(3, 4), 4, device=cuda))
    data, offsets, lens = _bytes_on(["ACGT", "AC"], cuda)
    for bad in ((data.int(), offsets, lens), (data.reshape(2, 3), offsets, lens),
                (data, offsets.int(), lens), (data, offsets[1:], lens),
                (data, offsets, lens.long()), (data, offsets, lens[None])):
        with pytest.raises(ValueError):
            kernels.transition_features_bytes(*bad)
    with pytest.raises(ValueError):
        kernels.transition_features_bytes(data, offsets.cpu(), lens)


@pytest.mark.cuda
@pytest.mark.parametrize("NB,L,window", [(1, 4096, 500), (5, 6144 + 8, 500), (3, 2040, 5000),
                                         (2, 10_000, 20_000), (4, 8, 2)])
def test_card_good_windows_equal_plain(cuda, NB, L, window):
    """Ragged L (not a multiple of the 2048-position tile, nor of 32),
    several rows, windows below, above and beyond L, and rows of misses."""
    rng = np.random.default_rng(NB * L + window)
    counts = torch.from_numpy(rng.integers(1, 4, (NB, L, 3)).astype(np.uint8)).to(cuda)
    hashes = torch.from_numpy(rng.integers(0, 1 << 32, (NB, L, 3), dtype=np.int64)).to(cuda)
    hashes[:, ::7] = 0
    counts[-1, : L // 2] = 0  # half a row of misses
    span = min(window, L)  # windows beyond L: the growing prefix decides
    one_min, three_min = int(span * 0.55), int(span * 0.03)
    before = kernels.LAUNCHES["good_windows"]
    got = kernels.good_windows(counts, hashes, window, one_min, three_min)
    want = kernels.good_windows_plain(counts, hashes, window, one_min, three_min)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["good_windows"] == before + 1
    assert got.shape == (NB, L // 8) and got.dtype == torch.uint8
    assert torch.equal(got, want)
    flags = np.unpackbits(got.cpu().numpy(), axis=1, bitorder="little")
    assert 0 < flags.mean() < 1


@pytest.mark.cuda
def test_card_good_windows_raises_instead_of_falling_back(cuda):
    counts = torch.zeros(1, 12, 3, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):  # L % 8 != 0
        kernels.good_windows(counts, torch.zeros(1, 12, 3, dtype=torch.int64, device=cuda),
                             10, 1, 1)
    with pytest.raises(ValueError):  # int32 hashes
        kernels.good_windows(counts[:, :8], torch.zeros(1, 8, 3, dtype=torch.int32, device=cuda),
                             10, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("NB,L,window", [(3, 1001, 50), (2, 37, 500), (65536, 8, 3)])
def test_card_good_windows_batch_equal_its_cpu_route(cuda, NB, L, window):
    """``window.good_windows_batch`` on the card against its CPU route: L
    not a multiple of 8, a window beyond L, uint32 hashes at and above
    2^31 and hash 0, and more rows than one launch takes (two launches)."""
    from palace_tpu_torch.ops import window as twin

    rng = np.random.default_rng(NB + L)
    counts = rng.integers(2, 5, (NB, L, 3)).astype(np.uint8)
    hashes = rng.integers(0, 1 << 32, (NB, L, 3), dtype=np.uint64).astype(np.uint32)
    hashes[:, ::5] = 0
    hashes[:, 1::5] |= np.uint32(1 << 31)
    span = min(window, L)
    one_min, three_min = int(span * 0.4), int(span * 0.02)
    kernels.reset_launches()
    got = twin.good_windows_batch(counts, hashes, window, one_min, three_min)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["good_windows"] == -(-NB // 65535)
    want = twin.good_windows_batch(counts, hashes, window, one_min, three_min, device="cpu")
    assert got.device.type == "cuda" and got.shape == (NB, L) and got.dtype == torch.bool
    assert torch.equal(got.cpu(), want)
    assert 0 < want.float().mean() < 1
    one = twin.good_windows(counts[0], hashes[0], window, one_min, three_min)
    assert torch.equal(one.cpu(), want[0])
    with pytest.raises(ValueError):
        twin.good_windows_batch(counts, hashes, kernels.GOOD_WINDOWS_MAX_WINDOW + 1, 1, 1)


@pytest.mark.cuda
def test_card_count_table_and_scan_reference_equal_cpu(cuda):
    """Phase A's update (torch.unique, gather, clamp, scatter) on the card
    gives the CPU's table, slot 0 included; scan_reference through K4 on
    the card gives the CPU's hit."""
    from palace_tpu_torch.ops.count_table import CountTable
    from palace_tpu_torch.ops.kmer import make_choose_coder, pack_codes_mask
    from palace_tpu_torch.ops.window import scan_reference

    rng = np.random.default_rng(6)
    perm = make_choose_coder(20, seed=1)
    tables = {dev: CountTable.create(20, device=dev) for dev in ("cpu", "cuda")}
    for _ in range(3):
        codes = rng.integers(0, 5, size=(512, 64)).astype(np.uint8)
        codes[:300] = codes[0]  # a k-mer seen 300 times a batch
        packed, mask = pack_codes_mask(codes)
        for t in tables.values():
            t.add_packed(packed, mask, perm, 20)
    assert torch.equal(tables["cuda"].table.cpu(), tables["cpu"].table)
    assert int(tables["cpu"].table[0]) == 3

    counts = rng.integers(0, 4, (3000, 3)).astype(np.uint8)
    hashes = rng.integers(0, 100, (3000, 3)).astype(np.uint32)
    kw = dict(ref_index=1, ref_len=3000, window=50, hit_ratio=0.3, perfect_hit_ratio=0.02,
              min_cover_ratio=0.0)
    before = kernels.LAUNCHES["good_windows"]
    got = scan_reference(counts, hashes, **kw)
    assert kernels.LAUNCHES["good_windows"] == before + 1
    want = scan_reference(counts, hashes, **kw, device="cpu")
    assert got is not None and got.line() == want.line()


def _random_table(k, seed):
    """A 2^k-byte count table on the card (4 GiB at k = 32): counts 0-3,
    3 in 13 of 16 slots, filled 2^28 bytes at a time."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.empty(1 << k, dtype=torch.uint8, device="cuda")
    for part in table.split(1 << 28):
        part.random_(0, 16, generator=g)
    return table.clamp_(max=3)


@pytest.fixture(scope="module")
def scan_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run "
                    "pytest --noconftest -m cuda tests/test_torch_cuda.py on the card")
    tables = {k: _random_table(k, k) for k in (32, 20)}
    yield tables
    del tables
    torch.cuda.empty_cache()


def _scan_world(tmp_path, k, target):
    """A packed phagedb whose references all fit a ``target`` bucket, and
    its chunk: refs of target and target - 1 positions, one across the
    second tile's edge, N runs, lower case and IUPAC, refs of k - 1, k and
    k + 5 positions, then two pad rows."""
    from palace_tpu_torch.io.fasta import write_fasta
    from palace_tpu_torch.search import index

    rng = np.random.default_rng(target + k)
    lens = [target, target - 1, kernels.SCAN_TILE + 1, 9000, k - 1, k, k + 5, 3000, 5000]
    seqs = [_random_bases(rng, n) for n in lens]
    seqs[3] = seqs[3][:2000] + "N" * 300 + seqs[3][2300:]
    seqs[7] = seqs[7].lower()
    seqs[8] = _random_bases(rng, 5000, "ACGTACGTACGTRYN")
    db = tmp_path / "db.fa"
    write_fasta(db, [(f"r{i}", s) for i, s in enumerate(seqs)])
    idx = index.build_index(db, k=k, save=False)
    offs = np.zeros((len(seqs) + 2, 3), np.int64)
    offs[:len(seqs)] = np.stack([idx.code_offsets[:-1], idx.mask_offsets[:-1], idx.lengths],
                                axis=1)
    packed = torch.from_numpy(np.pad(idx.packed, (0, target // 4))).to("cuda")
    mask = torch.from_numpy(np.pad(idx.maskbits, (0, target // 8))).to("cuda")
    return idx, packed, mask, torch.from_numpy(offs).to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 20])
@pytest.mark.parametrize("window", [1, 500, kernels.SCAN_TILE + 1])
def test_card_scan_chunk_equal_plain(cuda, scan_tables, tmp_path, k, window):
    """The fused scan against its plain version on the card: a real 4 GiB
    table at k = 32, windows of 1, 500 and one above the block's tile, pad
    rows and edge rows; one launch a call."""
    target = 12288  # one and a half tiles
    idx, packed, mask, offs = _scan_world(tmp_path, k, target)
    one_min, three_min = (1, 1) if window == 1 else (int(0.9 * window), int(0.5 * window))
    args = (idx.perm, k, target, window, one_min, three_min, 3)
    before = kernels.LAUNCHES["scan_chunk"]
    got = kernels.scan_chunk(packed, mask, offs, scan_tables[k], *args)
    want = kernels.scan_chunk_plain(packed, mask, offs, scan_tables[k], *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scan_chunk"] == before + 1
    assert got.shape == (offs.shape[0], target // 8) and got.dtype == torch.uint8
    assert torch.equal(got, want)
    flags = np.unpackbits(got.cpu().numpy(), axis=1, bitorder="little")
    assert 0 < flags[:4].mean() < 1 and not flags[-2:].any()


@pytest.mark.cuda
def test_card_scan_chunk_raises_instead_of_falling_back(cuda, scan_tables, tmp_path):
    target = 12288
    idx, packed, mask, offs = _scan_world(tmp_path, 20, target)
    table = scan_tables[20]
    args = (idx.perm, 20, target, 500, 450, 250)
    before = kernels.LAUNCHES["scan_chunk"]
    past = offs.clone()
    past[0, 0] = packed.numel() - target // 4 + 1
    for bad in ((packed, mask, offs, table.cpu()), (packed, mask, offs.cpu(), table),
                (packed, mask, past, table)):
        with pytest.raises(ValueError):
            kernels.scan_chunk(*bad, *args)
    with pytest.raises(ValueError):  # k > 32
        kernels.scan_chunk(packed, mask, offs, table, idx.perm, 33, target, 500, 450, 250)
    assert kernels.LAUNCHES["scan_chunk"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 20])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("window", [1, 31, 32, 33, 500, kernels.SCAN_TILE + 1,
                                    kernels.GOOD_WINDOWS_MAX_WINDOW])
@pytest.mark.parametrize("target", [12288, 4096, 6144])
def test_card_scan_hits_and_window_hits_equal_plain(cuda, scan_tables, tmp_path, k, world,
                                                    window, target):
    """The sharded Phase B on the card: each rank's hit bit-planes against
    its shard of a real table (4 GiB at k = 32, split as
    ``ShardedCountTable`` splits it) equal to ``scan_hits_plain``, one
    launch a call; ``window_hits`` of their sum equal to its plain version
    and to ``scan_chunk`` on the whole table, with pad rows and edge rows;
    at 12,288 positions one and a half of ``scan_hits``' tiles, at 4,096
    half of ``window_hits``' 8,192; windows on both sides of a word and
    past the row."""
    idx, packed, mask, offs = _scan_world(tmp_path, k, target)
    table = scan_tables[k]
    size = -(-(1 << k) // world)
    planes = []
    for r in range(world):
        shard = table[r * size:(r + 1) * size]
        before = kernels.LAUNCHES["scan_hits"]
        filt = kernels.hit_filter(shard, 3)
        got = kernels.scan_hits(packed, mask, offs, shard, r * size, idx.perm, k, target, 3,
                                filt)
        want = kernels.scan_hits_plain(packed, mask, offs, shard, r * size, idx.perm, k, target)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["scan_hits"] == before + 1
        assert got.shape == (offs.shape[0], 3, target // 8) and got.dtype == torch.uint8
        assert torch.equal(got, want)
        planes.append(got)
    ored = torch.stack(planes).sum(dim=0, dtype=torch.uint8)
    assert torch.equal(ored, functools.reduce(torch.bitwise_or, planes))  # one owner a bit
    span = min(window, target)  # a window past the row flags only the row's end
    one_min, three_min = (1, 1) if span == 1 else (int(0.9 * span), int(0.5 * span))
    before = kernels.LAUNCHES["window_hits"]
    got = kernels.window_hits(ored, window, one_min, three_min)
    want = kernels.window_hits_plain(ored, window, one_min, three_min)
    whole = kernels.scan_chunk(packed, mask, offs, table, idx.perm, k, target, window, one_min,
                               three_min, 3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["window_hits"] == before + 1
    assert torch.equal(got, want) and torch.equal(got, whole)
    flags = np.unpackbits(got.cpu().numpy(), axis=1, bitorder="little")
    assert 0 < flags[:4].mean() < 1 and not flags[-2:].any()


@pytest.mark.cuda
def test_card_scan_hits_and_window_hits_raise_instead_of_falling_back(cuda, scan_tables,
                                                                      tmp_path):
    target = 12288
    idx, packed, mask, offs = _scan_world(tmp_path, 20, target)
    shard = scan_tables[20][: 1 << 19]
    filt = kernels.hit_filter(shard, 3)
    before = {n: kernels.LAUNCHES[n] for n in ("scan_hits", "window_hits")}
    for bad in ((packed, mask, offs, shard.cpu(), 0), (packed, mask, offs.cpu(), shard, 0),
                (packed, mask, offs, shard, 1 << 20)):
        with pytest.raises(ValueError):
            kernels.scan_hits(*bad, idx.perm, 20, target, 3, filt)
    other = scan_tables[20][1 << 19:]  # no filter, or one of another shard or depth
    for bad in (None, kernels.hit_filter(other, 3), kernels.hit_filter(shard, 2)):
        with pytest.raises(ValueError):
            kernels.scan_hits(packed, mask, offs, shard, 0, idx.perm, 20, target, 3, bad)
    for bad in (shard.int(), shard.reshape(2, -1), shard[:0]):
        with pytest.raises(ValueError):
            kernels.hit_filter(bad, 3)
    planes = torch.zeros(2, 3, 64, dtype=torch.uint8, device=cuda)
    for bad in (planes.int(), planes[:, :2]):
        with pytest.raises(ValueError):
            kernels.window_hits(bad, 50, 1, 1)
    assert {n: kernels.LAUNCHES[n] for n in before} == before


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 20])
@pytest.mark.parametrize("world", [1, 3])
@pytest.mark.parametrize("max_bits", [10, kernels.HIT_FILTER_BITS])
def test_card_hit_filter_equals_plain(cuda, scan_tables, tmp_path, monkeypatch, k, world,
                                      max_bits):
    """``hit_filter`` of each rank's shard (world 3: shards that start off
    a 16-byte boundary) equal to its plain version, one launch a call, and
    ``scan_hits`` through it equal to ``scan_hits_plain``: a filter of 2^10
    bits folds a 4 GiB shard's 2^22 slots onto each bit, so nearly every
    probe reads the shard."""
    monkeypatch.setattr(kernels, "HIT_FILTER_BITS", max_bits)
    target = 12288
    idx, packed, mask, offs = _scan_world(tmp_path, k, target)
    table = scan_tables[k]
    size = -(-(1 << k) // world)
    for r in range(world):
        shard = table[r * size:(r + 1) * size]
        before = kernels.LAUNCHES["hit_filter"]
        filt = kernels.hit_filter(shard, 3)
        want = kernels.hit_filter_plain(shard, 3)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["hit_filter"] == before + 1
        assert filt.fbits == want.fbits == min(max_bits, (shard.numel() - 1).bit_length())
        assert torch.equal(filt.words, want.words)
        got = kernels.scan_hits(packed, mask, offs, shard, r * size, idx.perm, k, target, 3, filt)
        assert kernels.LAUNCHES["hit_filter"] == before + 1  # the filter given, none made
        assert torch.equal(got, kernels.scan_hits_plain(packed, mask, offs, shard, r * size,
                                                        idx.perm, k, target, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("target", [8, 6152, 24584])
@pytest.mark.parametrize("offset", [0, 1])
def test_card_window_hits_byte_tail(cuda, target, offset):
    """``window_hits`` where its rows are not whole 32-bit words: targets
    that are a multiple of 8 but not of 32 (the last word of a row read and
    stored a byte at a time), and planes that start one byte past a 4-byte
    boundary (every word read a byte at a time), against its plain version."""
    rng = np.random.default_rng(target + offset)
    rows, nbytes = 3, target // 8
    rate = np.repeat(rng.uniform(0.6, 1.0, (rows, 1, -(-target // 700))), 700, axis=2)
    bits = rng.random((rows, 3, target)) < rate[:, :, :target]
    flat = np.packbits(bits, axis=2, bitorder="little").reshape(-1)
    buf = torch.from_numpy(np.pad(flat, (offset, 0))).to(cuda)
    planes = buf[offset:].view(rows, 3, nbytes)
    assert (planes.data_ptr() % 4 != 0) == (offset == 1)
    for window in (1, 33, 500):
        span = min(window, target)
        args = (window, *((1, 1) if span == 1 else (int(0.9 * span), int(0.5 * span))))
        before = kernels.LAUNCHES["window_hits"]
        got = kernels.window_hits(planes, *args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["window_hits"] == before + 1
        assert got.shape == (rows, nbytes)
        assert torch.equal(got, kernels.window_hits_plain(planes, *args))


@pytest.mark.cuda
def test_card_sharded_phase_b_of_one_rank_launches_scan_hits(cuda, tmp_path):
    """eref under a mesh of one rank on the card: ``scan_hits`` and
    ``window_hits`` once a chunk, no ``scan_chunk``, the CPU's hits."""
    from palace_tpu_torch.config import KmerParams
    from palace_tpu_torch.parallel import make_mesh
    from palace_tpu_torch.search import eref, index

    db, fq1, fq2 = chip_smoke.make_small_eref_world(tmp_path)
    idx = index.build_index(db, k=20, save=False)
    params = KmerParams(k=20)
    want = eref.run_search(fq1, fq2, idx, params, tmp_path / "cpu.txt", device="cpu")
    kernels.reset_launches()
    got = eref.run_search(fq1, fq2, idx, params, tmp_path / "card.txt", mesh=make_mesh())
    n_chunks = len(eref.plan_chunks(idx))
    assert kernels.LAUNCHES["scan_hits"] == kernels.LAUNCHES["window_hits"] == n_chunks > 0
    assert kernels.LAUNCHES["scan_chunk"] == 0
    assert [h.line() for h in got] == [h.line() for h in want] and len(got) == 3
    assert (tmp_path / "card.txt").read_bytes() == (tmp_path / "cpu.txt").read_bytes()


@pytest.mark.cuda
def test_card_search_references_launches_scan_chunk_once_a_chunk(cuda, tmp_path, monkeypatch):
    """Phase B on the card: one scan_chunk a chunk, no torch hashing chain,
    the CPU's hits."""
    from palace_tpu_torch.config import KmerParams
    from palace_tpu_torch.search import eref, index

    db, fq1, fq2 = chip_smoke.make_small_eref_world(tmp_path)
    idx = index.build_index(db, k=20, save=False)
    params = KmerParams(k=20)
    tables = {dev: eref.count_reads_into_table([fq1, fq2], idx, params, device=dev)
              for dev in ("cpu", "cuda")}
    want = [h.line() for h in eref.search_references(tables["cpu"], idx, params)]

    def refuse(*_a, **_k):
        raise AssertionError("the card's Phase B ran the torch hashing chain")

    monkeypatch.setattr(kernels, "kmer_hashes_masked", refuse)
    monkeypatch.setattr(kernels, "unpack_codes_mask", refuse)
    kernels.reset_launches()
    got = [h.line() for h in eref.search_references(tables["cuda"], idx, params)]
    assert kernels.LAUNCHES["scan_chunk"] == len(eref.plan_chunks(idx)) > 0
    assert kernels.LAUNCHES["good_windows"] == 0
    assert got == want and len(got) == 3
