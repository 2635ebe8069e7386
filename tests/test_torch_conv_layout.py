"""The layouts the 16-bit conv-head kernel (K3) relies on, in plain torch
on the CPU: the weights repacked as the wrapper repacks them
(``kernels.conv_taps``), the input read position-major, the 8
tap-shifted products summed over channel-last intermediates in the
layouts ``kernels.conv_layouts`` gives, against ``conv_head_plain`` and
JAX ``conv_head_pallas`` (in interpret mode on the CPU).

Tolerance: float32 1e-5, absolute and relative (sums of up to 1024
products of unit-scale inputs and 0.1-scale weights, taken in another
order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palace_tpu.ops.pallas_kernels import conv_head_pallas
from palace_tpu_torch.ops import kernels

TOL = 1e-5


def _inputs(B, C0, L, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, C0, L)).astype(np.float32)
    ws = [rng.normal(0, 0.1, (64, c, 8)).astype(np.float32) for c in (C0, 64, 64)]
    bs = [rng.normal(0, 0.1, 64).astype(np.float32) for _ in range(3)]
    return x, ws, bs


def _tap_sums(x, weights, biases):
    """The kernel's arithmetic in its layouts: for each layer and tap k,
    acc[p, o] += X[p + k, :] · W_k[o, :] over a [position][channel] input,
    then bias, relu; intermediates stay channel-last (B, L, 64)."""
    shapes = []
    layouts = kernels.conv_layouts(len(weights), torch.bfloat16)
    for w, b, (in_cm, out_cm) in zip(weights, biases, layouts):
        wk = kernels.conv_taps(w)                        # (K, O, C)
        xs = x.transpose(1, 2) if in_cm else x           # (B, L, C), as in shared memory
        K, L_out = wk.shape[0], xs.shape[1] - wk.shape[0] + 1
        acc = sum(xs[:, k:k + L_out, :] @ wk[k].T for k in range(K))  # (B, L_out, O)
        y = torch.relu(acc + b)
        x = y.transpose(1, 2).contiguous() if out_cm else y.contiguous()
        shapes.append(tuple(x.shape))
    return x, shapes


@pytest.mark.parametrize("B,C0,L", [(2, 128, 60), (1, 64, 22), (3, 64, 37)])
def test_tap_sums_in_the_kernel_layouts_equal_plain_and_pallas(B, C0, L):
    x, ws, bs = _inputs(B, C0, L, seed=L)
    tx, tws, tbs = torch.from_numpy(x), [torch.from_numpy(w) for w in ws], \
        [torch.from_numpy(b) for b in bs]
    got, shapes = _tap_sums(tx, tws, tbs)
    # the intermediates are channel-last, the result the public channel-major
    assert shapes == [(B, L - 7, 64), (B, L - 14, 64), (B, 64, L - 21)]
    assert got.is_contiguous()
    plain = kernels.conv_head_plain(tx, tws, tbs)
    pallas = np.asarray(conv_head_pallas(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                         [jnp.asarray(b) for b in bs]))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)


def test_conv_taps_puts_one_taps_matrix_a_slab_channels_innermost():
    w = torch.arange(64 * 128 * 8, dtype=torch.float32).reshape(64, 128, 8)
    wk = kernels.conv_taps(w)
    assert wk.shape == (8, 64, 128) and wk.is_contiguous()
    for k in range(8):
        assert torch.equal(wk[k], w[:, :, k])


def test_conv_layouts_keep_float32_channel_major_and_take_three_16bit_layers():
    assert kernels.conv_layouts(2, torch.float32) == [(True, True)] * 2
    for dt in (torch.bfloat16, torch.float16):
        assert kernels.conv_layouts(3, dt) == [(True, False), (False, False), (False, True)]
        with pytest.raises(ValueError):
            kernels.conv_layouts(2, dt)
