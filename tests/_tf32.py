"""The 3×TF32 arithmetic of the kernels' float32 routes, emulated in
plain torch on any device: K2's ``sage_tf32_kernel``
(``palace_tpu_torch/csrc/sage_rounds.cu``) and K3's ``conv_tf32_kernel``
(``palace_tpu_torch/csrc/conv_head.cu``).  Imported by
``tests/test_torch_sage_tf32.py``, ``tests/test_torch_conv_tf32.py``,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; it imports torch only.

Each float32 operand x is split into big = tf32(x) and small = tf32(x -
big), TF32 being x rounded to 10 mantissa bits, to nearest with ties away
from zero (``cvt.rna.tf32.f32``).  One mma (``mma.sync`` m16n8k8) sums 8
products, each exact (22 bits), exactly with its float32 accumulator and
rounds the sum toward zero to float32.  A k8 step of the 3×TF32 split adds
small·big, then big·small, then big·big (A part, B part) into the chain.
"""
from __future__ import annotations

import contextlib

import torch

#: the kernels' three mma a k8 step, in their order: (A part, B part)
THREE_TF32 = (("small", "big"), ("big", "small"), ("big", "big"))
#: one TF32 product: each operand rounded to TF32 once
ONE_TF32 = (("big", "big"),)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 in a float32 pattern (the low 13 bits 0), to nearest
    with ties away from zero: half a TF32 ulp added to the magnitude, then
    cut."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> dict:
    big = tf32(x)
    return {"big": big, "small": tf32(x - big)}


def cut_to_float32(s: torch.Tensor) -> torch.Tensor:
    """float64 → float64 rounded toward zero to float32's 24 bits: the low
    29 of the 52 mantissa bits cut (exact for float32's normal range)."""
    return (s.contiguous().view(torch.int64) & ~0x1FFFFFFF).view(torch.float64)


def toward_zero(s: torch.Tensor) -> torch.Tensor:
    """float64 → float32, rounded toward zero."""
    return cut_to_float32(s).float()


@contextlib.contextmanager
def one_thread():
    """torch's CPU ops on one thread while the block runs: the emulation
    runs thousands of small ops in sequence, which a pool of threads only
    slows, the more so where test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tf32_product(a: torch.Tensor, b: torch.Tensor, terms) -> torch.Tensor:
    """a (..., K) · b (K, N) as ``sage_tf32_kernel``'s mma chain: for each
    k8 step, each (A part, B part) of ``terms`` added into the float32
    accumulator as one mma."""
    pa, pb = split_tf32(a), split_tf32(b)
    acc = torch.zeros(*a.shape[:-1], b.shape[1], dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for ta, tb in terms:
            acc = toward_zero(acc.double() + pa[ta][..., ks].double() @ pb[tb][ks].double())
    return acc


def conv_tf32(x: torch.Tensor, weights, biases, terms=THREE_TF32,
              chain_per_slice: bool = True) -> torch.Tensor:
    """The float32 conv head (Conv1d(k=8) + bias + relu a layer) summed as
    ``conv_tf32_kernel`` sums it: A the (O, C) weights of a tap, B the
    input's channels at the tap's shifted positions.  For each 16-channel
    slice, for each tap, for each of the slice's two k8 steps, each (A part,
    B part) of ``terms`` is one mma of one chain.  With ``chain_per_slice``
    a slice's 48 mma are a chain of their own, added to the float32
    accumulator with round-to-nearest; without, one chain runs over the
    whole layer (384 mma at C = 128).  Bias and relu in float32.

    x (B, C, L) float32, weights (O, C, 8), biases (O,) → (B, O, L - 21)."""
    with one_thread():
        for w, b in zip(weights, biases):
            (B, C, L), (O, _, K) = x.shape, w.shape
            L_out = L - K + 1
            # (B, C, L_out, K) and (O, C, K), each part in float64
            px = {t: v.double().unfold(2, K, 1) for t, v in split_tf32(x).items()}
            pw = {t: v.double() for t, v in split_tf32(w).items()}
            acc = torch.zeros(B, O, L_out, dtype=torch.float32, device=x.device)
            part = torch.zeros(B, O, L_out, dtype=torch.float64, device=x.device)
            for c0 in range(0, C, 16):
                ch = slice(c0, c0 + 16)
                # each mma's 8 products, exact, in the kernel's order: tap,
                # k8 step, term
                sums = torch.stack([torch.einsum(
                    "bsjlk,osjk->ksbol", px[tb][:, ch].reshape(B, 2, 8, L_out, K),
                    pw[ta][:, ch].reshape(O, 2, 8, K)) for ta, tb in terms], dim=2)
                for s in sums.reshape(-1, B, O, L_out):
                    part = cut_to_float32(part + s)
                if chain_per_slice:
                    acc, part = acc + part.float(), torch.zeros_like(part)
            x = torch.relu((acc if chain_per_slice else part.float()) + b[None, :, None])
    return x
