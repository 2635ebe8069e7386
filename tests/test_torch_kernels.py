"""Plain versions of the SAGE-rounds (K2) and conv-head (K3) kernels
against the Pallas kernels in interpret mode and the XLA paths of
palace_tpu.  The CUDA kernels are held to these plain versions on the
card by tests/test_torch_cuda.py.

Tolerances: float32 1e-4 for K2 (sums of up to 128 products, taken in
another order); float32 1e-5 for K3 at small widths and 1e-4 at 128
input channels (sums of 1024 products).  bfloat16 K2 is held at 2e-3,
absolute and relative, as tests/test_pallas_kernels.py holds the Pallas
kernel to XLA, with one exception: a float32 sum taken in another order
can round to the neighbouring bf16 value.  Where that happens in a
round-2 term of magnitude up to 4, a step of one bf16 ulp there (up to
2^-6) passes through the sum into the output in full, whatever the
output's own magnitude.  Such steps are allowed on at most 1e-4 of the
elements, and are never larger than 2^-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palace_tpu.models import gcn as jgcn
from palace_tpu.ops.pallas_kernels import conv_head_pallas, gcn_sage_pallas
from palace_tpu_torch.models import gcn as tgcn
from palace_tpu_torch.ops import kernels



def _spread_ln(params, rng, gd):
    """LayerNorm parameters away from the (1, 0) init, so they matter."""
    params = dict(params)
    params["ln.scale"] = jnp.asarray(rng.normal(1, 0.2, gd), jnp.float32)
    params["ln.bias"] = jnp.asarray(rng.normal(0, 0.2, gd), jnp.float32)
    return params


@pytest.mark.parametrize("fnode_num,gcn_dim,dtype,tol", [
    (8, 16, "float32", 1e-4), (64, 128, "float32", 1e-4),
    (8, 16, "bfloat16", 2e-3), (64, 128, "bfloat16", 2e-3),
])
def test_plain_sage_rounds_equal_pallas(fnode_num, gcn_dim, dtype, tol):
    cfg = jgcn.GCNConfig(fnode_num=fnode_num, gcn_dim=gcn_dim)
    rng = np.random.default_rng(fnode_num)
    params = _spread_ln(jgcn.init_params(jax.random.PRNGKey(0), cfg), rng, gcn_dim)
    jdt = jnp.dtype(dtype)
    B = 2
    xp = rng.normal(0, 1, (B, cfg.pnode_num, 3)).astype(np.float32)
    xf = rng.normal(0, 1, (B, fnode_num, 3)).astype(np.float32)
    want = np.asarray(gcn_sage_pallas(params, jnp.asarray(xp, jdt), jnp.asarray(xf, jdt), cfg)
                      .astype(jnp.float32))

    tp = tgcn.params_from_jax({k: np.asarray(v) for k, v in params.items()})
    tdt = getattr(torch, dtype)
    w = tgcn.sage_weight_stack(tp, tdt)
    assert w.shape == (kernels.sage_stack_rows(3, gcn_dim), gcn_dim)
    got = kernels.sage_rounds(torch.from_numpy(xp).to(tdt), torch.from_numpy(xf).to(tdt), w)
    assert got.dtype == tdt and got.shape == (B, cfg.pnode_num, gcn_dim)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        return
    diff = np.abs(got - want)
    step = diff > tol + tol * np.abs(want)
    assert (diff[step] <= 2.0 ** -6).all(), diff[step].max()
    assert step.mean() <= 1e-4, step.sum()


def _conv_inputs(rng, B, C0, L, O):
    x = rng.normal(0, 1, (B, C0, L)).astype(np.float32)
    ws = [rng.normal(0, 0.1, (O, c, 8)).astype(np.float32) for c in (C0, O, O)]
    bs = [rng.normal(0, 0.1, O).astype(np.float32) for _ in range(3)]
    return x, ws, bs


@pytest.mark.parametrize("B,C0,L,O,tol", [(2, 16, 64, 8, 1e-5), (1, 32, 300, 16, 1e-5),
                                          (2, 128, 256, 64, 1e-4)])
def test_plain_conv_head_equals_pallas_and_xla(B, C0, L, O, tol):
    rng = np.random.default_rng(L)
    x, ws, bs = _conv_inputs(rng, B, C0, L, O)
    want = np.asarray(conv_head_pallas(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                       [jnp.asarray(b) for b in bs]))
    # the XLA conv branch of palace_tpu.models.gcn._head (gcn.py:290-298)
    y = jnp.asarray(x)
    for w, b in zip(ws, bs):
        y = jax.nn.relu(jax.lax.conv_general_dilated(
            y, jnp.asarray(w), window_strides=(1,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH")) + jnp.asarray(b)[None, :, None])
    got = kernels.conv_head(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                            [torch.from_numpy(b) for b in bs])
    assert got.shape == (B, O, L - 21) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=tol, atol=tol)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    kernels.reset_launches()
    rng = np.random.default_rng(1)
    x, ws, bs = _conv_inputs(rng, 1, 16, 40, 8)
    t = [torch.from_numpy(a) for a in [x] + ws + bs]
    assert torch.equal(kernels.conv_head(t[0], t[1:4], t[4:7]),
                       kernels.conv_head_plain(t[0], t[1:4], t[4:7]))
    data = torch.from_numpy(rng.integers(0, 256, 48, dtype=np.uint8))
    offsets = torch.tensor([0, 30, 40, 48], dtype=torch.int64)
    lens = torch.tensor([30, 10, 8], dtype=torch.int32)
    assert torch.equal(kernels.transition_features_bytes(data, offsets, lens),
                       kernels.transition_features_bytes_plain(data, offsets, lens))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_compare_holds_each_dtype_to_its_tolerance():
    from palace_tpu_torch.ops.compare import TOLERANCES, compare

    want = torch.linspace(-3, 3, 10_000)
    f32, bf16 = TOLERANCES[torch.float32], TOLERANCES[torch.bfloat16]
    assert compare(want + 5e-5, want, f32)["ok"]
    assert not compare(want + 5e-4, want, f32)["ok"]
    one = want.clone()
    one[7] += 2.0 ** -6  # a single rounding step is allowed in bf16, not in f32
    res = compare(one, want, bf16)
    assert res["ok"] and res["steps"] == 1 and res["max_abs_err"] == pytest.approx(2.0 ** -6)
    assert not compare(one, want, f32)["ok"]
    big = want.clone()
    big[7] += 2.0 ** -5  # larger than one step
    assert not compare(big, want, bf16)["ok"]
    many = want.clone()
    many[::50] += 2.0 ** -6  # 2% of the elements step: too many
    assert not compare(many, want, bf16)["ok"]
    nan = want.clone()
    nan[0] = float("nan")
    assert not compare(nan, want, bf16)["ok"]
    with pytest.raises(ValueError):
        compare(want[:5], want, f32)
