"""The arithmetic of K3's float32 route on the CPU: the 3×TF32 split of
``palace_tpu_torch/csrc/conv_head.cu`` (``conv_tf32_kernel``), emulated
(``tests/_tf32.py`` ``conv_tf32``) through the three layers and held to
``conv_head_pallas`` in interpret mode at float32's 1e-4 (absolute and
relative, no steps), as ``tests/test_torch_kernels.py`` holds the plain
version.

The kernel's rule for its chains is what is tested: an mma rounds its sum
toward zero, so each 16-channel slice's 8 taps × 2 k8 steps × 3 terms are
one chain of 48 mma, added to the float32 accumulator with
round-to-nearest.  Two draws at 1 × 128 × 1024 positions, cut from the
main path's 4096: the init scale (``init_params``' U(±1/sqrt(C·8)), outputs
of order 1) and ``chip_smoke.large_conv_inputs`` (N(0, 1) input, N(0, 0.1)
weights), whose outputs reach 40.  On the large draw two controls fall
outside the tolerance, so the test tells them apart: one chain over the
whole tile (384 mma at C = 128) and one TF32 product.  The card runs the
kernel itself against the plain version and the float64 sums
(``tests/test_torch_cuda.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tf32 import ONE_TF32, THREE_TF32, conv_tf32

import chip_smoke
from palace_tpu.ops.pallas_kernels import conv_head_pallas
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.compare import TOLERANCES, compare

SHAPE = (1, 128, 1024)


@functools.lru_cache(maxsize=None)
def draw(name: str):
    """The draw's input, weights and biases (float32, seeded), and the
    Pallas kernel's output on them (interpret mode on the CPU)."""
    B, C0, L = SHAPE
    if name == "large":
        x, ws, bs = chip_smoke.large_conv_inputs(SHAPE, torch.float32, "cpu")
    else:
        rng = np.random.default_rng(14)
        x = torch.from_numpy(rng.normal(0, 1, SHAPE).astype(np.float32))
        scale = [np.float32(1 / np.sqrt(c * 8)) for c in (C0, 64, 64)]
        ws = [torch.from_numpy(rng.uniform(-1, 1, (64, c, 8)).astype(np.float32) * s)
              for c, s in zip((C0, 64, 64), scale)]
        bs = [torch.from_numpy(rng.uniform(-1, 1, 64).astype(np.float32) * s) for s in scale]
    want = np.array(conv_head_pallas(jnp.asarray(x.numpy()), [jnp.asarray(w.numpy()) for w in ws],
                                     [jnp.asarray(b.numpy()) for b in bs]))
    return x, ws, bs, torch.from_numpy(want)


@pytest.mark.parametrize("name,terms,chain_per_slice,within", [
    ("init", THREE_TF32, True, True),
    ("large", THREE_TF32, True, True),
    ("large", THREE_TF32, False, False),
    ("large", ONE_TF32, True, False),
], ids=["init-3xtf32", "large-3xtf32", "large-one-chain-a-tile", "large-1xtf32"])
def test_tf32_chains_against_pallas(name, terms, chain_per_slice, within):
    x, ws, bs, want = draw(name)
    got = conv_tf32(x, ws, bs, terms, chain_per_slice)
    assert got.shape == want.shape == (1, 64, SHAPE[2] - 21)
    res = compare(got, want, TOLERANCES[torch.float32])
    assert res["ok"] == within, res
    # the plain version, float32 products, is within the same tolerance
    assert compare(kernels.conv_head_plain(x, ws, bs), want, TOLERANCES[torch.float32])["ok"]


def test_large_draw_reaches_outputs_near_40():
    *_, want = draw("large")
    assert 30 < float(want.abs().max()) < 50


def test_chains_round_toward_zero_and_slices_add_to_nearest():
    """One output of one layer, C = 32 (two slices), weights 1 at tap 0.
    Slice 0's chain sums 1 + 1.5 ulp and cuts it to 1 + 1 ulp; slice 1 adds
    1.75 ulp.  Added to nearest, the two chains give 1 + 3 ulp; one chain
    over both slices cuts 1 + 2.75 ulp to 1 + 2 ulp."""
    ulp = 2.0 ** -23
    x, w, b = torch.zeros(1, 32, 8), torch.zeros(64, 32, 8), torch.zeros(64)
    w[0, :, 0] = 1.0
    x[0, 0, 0], x[0, 1, 0], x[0, 16, 0] = 1.0, 1.5 * ulp, 1.75 * ulp
    assert conv_tf32(x, [w], [b])[0, 0, 0].item() == 1 + 3 * ulp
    assert conv_tf32(x, [w], [b], chain_per_slice=False)[0, 0, 0].item() == 1 + 2 * ulp
