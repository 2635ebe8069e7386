"""The scorer's CUDA kernels, each beside its plain PyTorch version.

Counterpart of ``palace_tpu/ops/pallas_kernels.py``.  Every wrapper
takes the plain version for tensors on the CPU, and for CUDA tensors
launches its hand-written ``sm_90a`` kernel (``csrc/``) or raises:
there is no fallback from the card to the plain version.  Each launch
adds one to ``LAUNCHES[name]`` (``ops/_build.py``).

The plain versions repeat the kernels' arithmetic, rounding points
included, and are the reference the kernels are held to on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch

from palace_tpu_torch.ops import _build
from palace_tpu_torch.ops._build import LAUNCHES, reset_launches  # noqa: F401
from palace_tpu_torch.ops.encoder import (
    FEATURE_DIM,
    GAPS,
    K,
    NUM_CODES,
    locs_from_codes,
    unpack_codes,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _same_device(name: str, *ts: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix."""
    devs = {t.device for t in ts}
    _require(len(devs) == 1, f"{name}: inputs on different devices {devs}")
    dev = devs.pop()
    _require(dev.type in ("cuda", "cpu"), f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


# ---------------------------------------------------------------------------
# K1: transition counts, fused with the 2-bit unpack and the ×100/len scale
# ---------------------------------------------------------------------------

def transition_counts_plain(locs: torch.Tensor, n_locs: torch.Tensor) -> torch.Tensor:
    """(B, L) 3-mer codes + (B,) valid counts → (B, 3, 64, 64) float32
    ``M_d[u, v] = #{i < n - 3 - d : locs[i] = u, locs[i+3+d] = v}``."""
    B, L = locs.shape
    locs = locs.to(torch.int64)
    n_locs = n_locs.to(torch.int64)
    pos = torch.arange(L, device=locs.device)
    row = torch.arange(B, device=locs.device)[:, None] * (NUM_CODES * NUM_CODES)
    out = []
    for d in GAPS:
        shift = K + d
        n = max(L - shift, 0)
        valid = pos[None, :n] < (n_locs[:, None] - shift)
        idx = (row + locs[:, :n] * NUM_CODES + locs[:, shift:shift + n])[valid]
        out.append(torch.bincount(idx, minlength=B * NUM_CODES * NUM_CODES)
                   .reshape(B, NUM_CODES, NUM_CODES))
    return torch.stack(out, dim=1).to(torch.float32)


def transition_features_plain(packed: torch.Tensor, n_codes: torch.Tensor,
                              seq_lens: torch.Tensor) -> torch.Tensor:
    """Plain version of ``transition_features``."""
    locs, n_locs = locs_from_codes(unpack_codes(packed), n_codes)
    counts = transition_counts_plain(locs, n_locs).reshape(packed.shape[0], FEATURE_DIM)
    # a tensor numerator: ``100.0 / t`` would multiply by the reciprocal,
    # which is not IEEE division and differs from JAX in the last bit
    lens = torch.clamp(seq_lens.to(torch.float32), min=1.0)
    scale = torch.full_like(lens, 100.0) / lens
    return counts * scale[:, None]


def transition_features(packed: torch.Tensor, n_codes: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    """(B, P) uint8 2-bit-packed base codes, (B,) int32 valid code counts,
    (B,) int32 original lengths → (B, 12288) float32 features.

    Replaces ``transition_counts_pallas`` (palace_tpu/ops/pallas_kernels.py)
    together with the unpack and scale around it (palace_tpu/ops/encoder.py
    ``features_from_packed``).  Bound on the H100: bytes — about 1.3 MB
    in and 25 MB out per batch of 512 × 10 kb — but shared-memory atomics
    set the pace.  Design: one block per contig row keeps the row's
    3 × 4096 int32 histogram in 48 KiB of shared memory, so the one-hot
    matrices of the TPU kernel never exist; each thread unpacks the 2-bit
    codes it needs straight from the packed row.  Counts are integers, so
    the result equals the plain version exactly.
    """
    if not _same_device("transition_features", packed, n_codes, seq_lens):
        return transition_features_plain(packed, n_codes, seq_lens)
    B, P = packed.shape
    _require(packed.dtype == torch.uint8 and packed.is_contiguous(),
             "transition_features: packed must be contiguous uint8 (B, P)")
    _require(n_codes.dtype == torch.int32 and seq_lens.dtype == torch.int32
             and n_codes.shape == (B,) and seq_lens.shape == (B,),
             "transition_features: n_codes and seq_lens must be int32 (B,)")
    n_codes, seq_lens = n_codes.contiguous(), seq_lens.contiguous()
    out = torch.empty(B, FEATURE_DIM, dtype=torch.float32, device=packed.device)
    if B == 0:
        return out
    fn = _build.entry("transition_counts")
    err = fn(packed.data_ptr(), n_codes.data_ptr(), seq_lens.data_ptr(),
             out.data_ptr(), B, P, _stream(packed))
    LAUNCHES["transition_counts"] += 1
    _build.check("transition_counts", err)
    return out


# ---------------------------------------------------------------------------
# K2: both bipartite SAGE rounds + the LayerNorm between them
# ---------------------------------------------------------------------------

def sage_stack_rows(d3: int, gd: int) -> int:
    """Rows of the stacked SAGE weights (see ``sage_rounds``)."""
    return 3 * d3 + 3 * gd + 5


def _unstack(w: torch.Tensor, d3: int):
    gd = w.shape[1]
    o = 3 * d3 + 3 * gd
    return (w[0:d3], w[d3:2 * d3], w[2 * d3:3 * d3],
            w[3 * d3:3 * d3 + gd], w[3 * d3 + gd:3 * d3 + 2 * gd],
            w[3 * d3 + 2 * gd:o], w[o], w[o + 1], w[o + 2], w[o + 3], w[o + 4])


def _layer_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale.float() + bias.float()


def sage_rounds_plain(x_p: torch.Tensor, x_f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``sage_rounds``, at any widths."""
    dt = x_p.dtype
    B, pn, d3 = x_p.shape
    f = x_f.shape[1]
    rep = pn // f
    Wr1, Wl1, Wr2f, Wl2, Wl11, Wr11, b1, b2, b11, ln_s, ln_b = _unstack(w, d3)

    def dot(a, b):  # f32 accumulation of working-dtype operands
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))

    # round 1: x_p1 = relu(repeat(x_f0 @ Wl1 + b1) + x_p0 @ Wr1); p-node n
    # reads f-node n // rep
    lifted1 = (dot(x_f, Wl1) + b1.float()).to(dt)
    x_p1 = torch.relu(lifted1.repeat_interleave(rep, dim=1) + dot(x_p, Wr1).to(dt))
    # p→f group mean agg[j] = mean_a x_p1[a·f + j], summed in order of a
    groups = x_p1.reshape(B, rep, f, -1)
    acc = groups[:, 0].to(torch.float32)
    for a in range(1, rep):
        acc = acc + groups[:, a].to(torch.float32)
    agg = (acc * (1.0 / rep)).to(dt)
    x_f1 = torch.relu(dot(agg, Wl2).to(dt) + b2 + dot(x_f, Wr2f).to(dt))
    x_p1n = _layer_norm_f32(x_p1, ln_s, ln_b).to(dt)
    x_f1n = _layer_norm_f32(x_f1, ln_s, ln_b).to(dt)
    # round 2 with the convs_1.1 weights
    lifted2 = (dot(x_f1n, Wl11) + b11.float()).to(dt)
    return torch.relu(lifted2.repeat_interleave(rep, dim=1) + dot(x_p1n, Wr11).to(dt))


def sage_rounds(x_p: torch.Tensor, x_f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Both bipartite SAGE rounds and the LayerNorm between them.

    x_p (B, pn, 3) p-node and x_f (B, f, 3) f-node lifted inputs and
    ``w`` the stacked weights, all in the working dtype → (B, pn, gd)
    round-2 p-node activations.  Rows of ``w`` (``sage_stack_rows``):
    [0:3) convs_1.0.lin_r, [3:6) convs_1.0.lin_l, [6:9) convs_2.0.lin_r,
    then gd rows each of convs_2.0.lin_l, convs_1.1.lin_l, convs_1.1.lin_r,
    then the biases of convs_1.0.lin_l, convs_2.0.lin_l, convs_1.1.lin_l,
    and the LayerNorm scale and bias.  Products accumulate in float32 and
    round to the working dtype where the TPU kernel rounds; LayerNorm
    statistics are float32 (eps 1e-5).

    Replaces ``gcn_sage_pallas`` (palace_tpu/ops/pallas_kernels.py).
    Bound on the H100: bytes — the (B, 4096, 128) output, about 537 MB
    per batch of 512 in bf16.  Design: a row's activations (1 MiB in bf16)
    do not fit in a block's shared memory as they fit in the TPU's VMEM,
    so one block per batch row runs two passes that recompute the cheap
    round-1 activations (input width 3) instead of storing them: pass A
    accumulates the p→f group mean, then the f-node side is finished in
    shared memory; pass B recomputes round 1 tile by tile, normalises it,
    multiplies by convs_1.1.lin_r held in shared memory, and writes the
    output once.  The CUDA kernel takes the published widths (f = 64,
    gd = 128).
    """
    if not _same_device("sage_rounds", x_p, x_f, w):
        return sage_rounds_plain(x_p, x_f, w)
    B, pn, d3 = x_p.shape
    f, gd = x_f.shape[1], w.shape[1]
    dt = x_p.dtype
    _require(dt in _DTYPE_CODES and x_f.dtype == dt and w.dtype == dt,
             f"sage_rounds: inputs must share one of {list(_DTYPE_CODES)}")
    _require((pn, f, d3, gd) == (4096, 64, 3, 128) and x_f.shape == (B, f, d3)
             and w.shape == (sage_stack_rows(d3, gd), gd),
             "sage_rounds: the CUDA kernel takes pn=4096, f=64, d3=3, gd=128")
    x_p, x_f, w = x_p.contiguous(), x_f.contiguous(), w.contiguous()
    out = torch.empty(B, pn, gd, dtype=dt, device=x_p.device)
    if B == 0:
        return out
    fn = _build.entry("sage_rounds")
    err = fn(x_p.data_ptr(), x_f.data_ptr(), w.data_ptr(), out.data_ptr(),
             B, _DTYPE_CODES[dt], _stream(x_p))
    LAUNCHES["sage_rounds"] += 1
    _build.check("sage_rounds", err)
    return out


# ---------------------------------------------------------------------------
# K3: Conv1d(k=8) + bias + relu, three layers
# ---------------------------------------------------------------------------

def conv_head_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of ``conv_head``."""
    import torch.nn.functional as F

    dt = x.dtype
    for w, b in zip(weights, biases):
        acc = F.conv1d(x.to(torch.float32), w.to(torch.float32), b.to(torch.float32))
        x = torch.relu(acc).to(dt)
    return x


CONV_OUT = 64
CONV_TAPS = 8


def conv_head(x: torch.Tensor, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """The scorer's Conv1d(k=8)+bias+relu ×3 head (128→64→64→64).

    x (B, C0, L) channel-major activations in the working dtype, three
    (O, C, K) weights and three (O,) biases → contiguous (B, O, L - 21).
    Products accumulate in float32; bias and relu in float32; the result
    of each layer rounds to the working dtype.

    Replaces ``conv_head_pallas`` (palace_tpu/ops/pallas_kernels.py).
    Bound on the H100: operations — about 1.07 GFLOP a contig, 548 GFLOP
    per batch of 512.  Design: neither the weights (256 KB in bf16) nor a
    row's input fit in a block's shared memory, so one single-layer kernel
    runs three times; each block computes a 64-channel × 128-position
    output tile, streaming 16-channel slices of input (with a 7-column
    halo) and of the weights through shared memory, 32 accumulators a
    thread in registers.  It runs on the CUDA cores in float32: the
    tensor cores are work for a later change.  Each of the three layers
    is one launch, and counts as one.
    """
    if not _same_device("conv_head", x, *weights, *biases):
        return conv_head_plain(x, weights, biases)
    dt = x.dtype
    _require(dt in _DTYPE_CODES, f"conv_head: dtype {dt} not supported")
    fn = _build.entry("conv_head")
    stream = _stream(x)
    x = x.contiguous()
    for i, (w, b) in enumerate(zip(weights, biases)):
        B, C, L = x.shape
        _require(w.dtype == dt and b.dtype == dt,
                 "conv_head: weights and biases must be in the activations' dtype")
        _require(w.shape == (CONV_OUT, C, CONV_TAPS) and b.shape == (CONV_OUT,)
                 and C % 16 == 0 and L >= CONV_TAPS,
                 "conv_head: the CUDA kernel takes (64, C, 8) weights, C % 16 == 0")
        wt = w.permute(1, 2, 0).contiguous()  # (C, K, O): one load per tap
        out = torch.empty(B, CONV_OUT, L - CONV_TAPS + 1, dtype=dt, device=x.device)
        if B:
            err = fn(x.data_ptr(), wt.data_ptr(), b.contiguous().data_ptr(),
                     out.data_ptr(), B, C, L, _DTYPE_CODES[dt], stream)
            LAUNCHES["conv_head"] += 1
            _build.check("conv_head", err)
        x = out
    return x
