"""The arithmetic of K2's float32 route on the CPU: the 3×TF32 split of
``palace_tpu_torch/csrc/sage_rounds.cu`` (``sage_tf32_kernel``), emulated
(``tests/_tf32.py``) and dropped into a copy of
``kernels.sage_rounds_plain``'s chain, held at full width to
``gcn_sage_pallas`` in interpret mode at float32's 1e-4 (absolute and
relative, no steps), as ``tests/test_torch_kernels.py`` holds the plain
version.  One TF32 product on the same inputs falls outside it, so the test
tells the two apart.

The emulation follows the kernel: each float32 operand x is split into
big = tf32(x) and small = tf32(x - big), TF32 being x rounded to 10
mantissa bits, to nearest with ties away from zero (``cvt.rna.tf32.f32``).
A 128-deep product runs in 16 steps of 8; each step adds small·big, then
big·small, then big·big into one float32 accumulator, each as one mma: the
8 products (exact, 22 bits each) summed exactly with the accumulator, then
rounded toward zero to float32.  The 3-deep products, the group mean and
the LayerNorm stay float32 as in the plain version.  The card runs the
kernel itself against the plain version (``tests/test_torch_cuda.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tf32 import ONE_TF32, THREE_TF32, split_tf32, tf32, tf32_product, toward_zero

from palace_tpu.models import gcn as jgcn
from palace_tpu.ops.pallas_kernels import gcn_sage_pallas
from palace_tpu_torch.models import gcn as tgcn
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.compare import TOLERANCES, compare


def sage_rounds_emulated(x_p, x_f, w, terms) -> torch.Tensor:
    """``kernels.sage_rounds_plain`` in float32 with its three 128-deep
    products (agg·Wl2, x_f1n·Wl11, x_p1n·Wr11) taken as ``tf32_product``."""
    B, pn, d3 = x_p.shape
    f = x_f.shape[1]
    rep = pn // f
    Wr1, Wl1, Wr2f, Wl2, Wl11, Wr11, b1, b2, b11, ln_s, ln_b = kernels._unstack(w, d3)
    lifted1 = x_f @ Wl1 + b1
    x_p1 = torch.relu(lifted1.repeat_interleave(rep, dim=1) + x_p @ Wr1)
    groups = x_p1.reshape(B, rep, f, -1)
    acc = groups[:, 0]
    for a in range(1, rep):
        acc = acc + groups[:, a]
    agg = acc * (1.0 / rep)
    x_f1 = torch.relu(tf32_product(agg, Wl2, terms) + b2 + x_f @ Wr2f)
    x_p1n = kernels._layer_norm_f32(x_p1, ln_s, ln_b)
    x_f1n = kernels._layer_norm_f32(x_f1, ln_s, ln_b)
    lifted2 = tf32_product(x_f1n, Wl11, terms) + b11
    return torch.relu(lifted2.repeat_interleave(rep, dim=1) + tf32_product(x_p1n, Wr11, terms))


@functools.lru_cache(maxsize=None)
def full_width_case():
    """Seeded inputs at the published widths (f = 64, gd = 128), B = 2, the
    LayerNorm's parameters spread from their init, and the Pallas kernel's
    float32 output on them (interpret mode on the CPU)."""
    cfg = jgcn.GCNConfig(fnode_num=64, gcn_dim=128)
    rng = np.random.default_rng(13)
    params = dict(jgcn.init_params(jax.random.PRNGKey(13), cfg))
    params["ln.scale"] = jnp.asarray(rng.normal(1, 0.2, 128), jnp.float32)
    params["ln.bias"] = jnp.asarray(rng.normal(0, 0.2, 128), jnp.float32)
    xp = rng.normal(0, 1, (2, cfg.pnode_num, 3)).astype(np.float32)
    xf = rng.normal(0, 1, (2, 64, 3)).astype(np.float32)
    want = np.array(gcn_sage_pallas(params, jnp.asarray(xp), jnp.asarray(xf), cfg))
    w = tgcn.sage_weight_stack(tgcn.params_from_jax({k: np.asarray(v) for k, v in params.items()}),
                               torch.float32)
    return torch.from_numpy(xp), torch.from_numpy(xf), w, torch.from_numpy(want)


@pytest.mark.parametrize("terms,within", [(THREE_TF32, True), (ONE_TF32, False)],
                         ids=["3xtf32", "1xtf32"])
def test_tf32_split_against_pallas_at_full_width(terms, within):
    xp, xf, w, want = full_width_case()
    got = sage_rounds_emulated(xp, xf, w, terms)
    assert got.shape == want.shape == (2, 4096, 128)
    res = compare(got, want, TOLERANCES[torch.float32])
    assert res["ok"] == within, res
    # the plain version, float32 products, is within the same tolerance
    assert compare(kernels.sage_rounds_plain(xp, xf, w), want, TOLERANCES[torch.float32])["ok"]


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),              # a tie: away from zero
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),
    (1 + 2.0 ** -11 - 2.0 ** -23, 1.0),            # below the tie: down
    (3 * 2.0 ** -12 + 2.0 ** -24, 3 * 2.0 ** -12),  # 10 mantissa bits kept
    (1.5 + 3 * 2.0 ** -12, 1.5 + 2.0 ** -10),      # above the tie: up
])
def test_tf32_rounds_to_nearest_ties_away(x, want):
    got = tf32(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert (got.view(torch.int32) & 0x1FFF).item() == 0


def test_split_keeps_float32_within_2_to_the_minus_22():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3, 100_000).astype(np.float32))
    p = split_tf32(x)
    rest = (x.double() - p["big"].double() - p["small"].double()).abs()
    assert bool((rest <= 2.0 ** -22 * x.double().abs()).all())
    assert bool((p["small"].abs() <= 2.0 ** -11 * x.abs()).all())


def test_toward_zero_is_an_mma_sum():
    s = torch.tensor([1 + 2.0 ** -30, -(1 + 2.0 ** -30), 2.0 ** -30, 3.0], dtype=torch.float64)
    assert toward_zero(s).tolist() == [1.0, -1.0, 2.0 ** -30, 3.0]
    # k8 step 1 adds 1 + 7·2^-25 (1.75 ulp of 1), cut to 1 + 2^-23; step 2
    # adds 8·2^-25 exactly.  Rounded to nearest, step 1 would give 1 + 2^-22.
    a = torch.ones(1, 16)
    b = torch.tensor([1.0] + [2.0 ** -25] * 15).reshape(16, 1)
    assert tf32_product(a, b, ONE_TF32).item() == 1 + 3 * 2.0 ** -23
