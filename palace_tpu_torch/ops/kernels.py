"""The port's CUDA kernels, each beside its plain PyTorch version: the
scorer's K1-K3 (K1 also at the Pallas kernel's padded-codes interface,
``transition_counts``) and the eref search's K4 (``good_windows``;
``scan_chunk``, which fuses it with the hashing and lookup before it; and,
against a table split over a mesh, ``scan_hits`` and ``window_hits``), and
eref Phase A's count of a batch of read codes into the table
(``count_codes``), which replaces no Pallas kernel.

Counterpart of ``palace_tpu/ops/pallas_kernels.py``.  Every wrapper
takes the plain version for tensors on the CPU, and for CUDA tensors
launches its hand-written ``sm_90a`` kernel (``csrc/``) or raises:
there is no fallback from the card to the plain version.  Each launch
adds one to ``LAUNCHES[name]`` (``ops/_build.py``).

The plain versions repeat the kernels' arithmetic, rounding points
included, and are the reference the kernels are held to on the card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from palace_tpu_torch.ops import _build
from palace_tpu_torch.ops._build import LAUNCHES, reset_launches  # noqa: F401
from palace_tpu_torch.ops.encoder import (
    BASE_LUT,
    FEATURE_DIM,
    GAPS,
    INVALID,
    K,
    NUM_CODES,
    locs_from_codes,
    scale_by_length,
)
from palace_tpu_torch.ops.kmer import coder_masks, kmer_hashes_masked, unpack_codes_mask
from palace_tpu_torch.utils.timers import StageTimer

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
# K1: transition counts from padded 3-mer codes, and from ASCII rows fused
# with the compaction and the ×100/len scale
# ---------------------------------------------------------------------------

#: bytes of a row that one block of the K1 kernel counts; longer rows are
#: split over blocks (a 10 kb contig is one tile)
TILE_BYTES = 16384


def _pair_counts(locs: torch.Tensor, row: torch.Tensor, pos: torch.Tensor,
                 n_locs: torch.Tensor, B: int) -> torch.Tensor:
    """Flat 3-mer codes ``locs`` (M,), each at position ``pos`` of row
    ``row`` whose valid count is ``n_locs`` (M,) → (B, 3, 64, 64) float32
    ``M_d[u, v] = #{i < n - 3 - d : locs[i] = u, locs[i+3+d] = v}``.  A
    pair with a code outside [0, 64) counts nothing, as JAX's one-hot
    gives such a code no bin."""
    out = []
    in_range = (locs >= 0) & (locs < NUM_CODES)
    for d in GAPS:
        shift = K + d
        n = max(locs.shape[0] - shift, 0)
        valid = pos[:n] < n_locs[:n] - shift  # so locs[i + shift] lies in the same row
        valid &= in_range[:n] & in_range[shift:shift + n]
        idx = ((row[:n] * NUM_CODES + locs[:n]) * NUM_CODES + locs[shift:shift + n])[valid]
        out.append(torch.bincount(idx, minlength=B * NUM_CODES * NUM_CODES)
                   .reshape(B, NUM_CODES, NUM_CODES))
    return torch.stack(out, dim=1).to(torch.float32)


def transition_counts_plain(locs: torch.Tensor, n_locs: torch.Tensor) -> torch.Tensor:
    """(B, L) 3-mer codes + (B,) valid counts → (B, 3, 64, 64) float32
    ``M_d[u, v] = #{i < n - 3 - d : locs[i] = u, locs[i+3+d] = v}``: the
    counting of ``transition_features_bytes_plain`` at the Pallas kernel's
    padded interface."""
    B, L = locs.shape
    dev = locs.device
    row = torch.arange(B, device=dev).repeat_interleave(L)
    pos = torch.arange(L, device=dev).repeat(B)
    n = torch.clamp(n_locs.to(torch.int64), max=L).repeat_interleave(L)
    return _pair_counts(locs.to(torch.int64).reshape(-1), row, pos, n, B)


#: codes of a row that one block of the codes entry counts; longer rows are
#: split over blocks (a 10 kb contig's 3-mer codes are one tile)
TILE_CODES = 16384


def transition_counts(locs: torch.Tensor, n_locs: torch.Tensor) -> torch.Tensor:
    """(B, L) int32 3-mer codes + (B,) int32 valid counts → (B, 3, 64, 64)
    float32 ``M_d[u, v] = #{i < n - 3 - d : locs[i] = u, locs[i+3+d] = v}``
    with ``n = min(n_locs, L)``; a pair with a code outside [0, 64) counts
    nothing.  The codes may be any; they need not be a sequence's 3-mers.

    K1 at the interface of ``transition_counts_pallas``
    (palace_tpu/ops/pallas_kernels.py), for ``encoder.transition_features``
    and the encodes from base codes; the scorer's path is
    ``transition_features_bytes``.  Bound on the H100: bytes — the codes
    read once and 48 KiB of counts a row written.  Design
    (``csrc/transition_counts.cu``, entry ``palace_transition_counts_codes``):
    one block a tile of ``TILE_CODES`` codes of a row, which it stages as
    bytes in shared memory with the 5 codes past it, counting into a
    3 × 4096 int32 shared histogram through each thread's last 4 bins in
    registers; a row of several tiles sums them in its output row, which
    its last tile converts.  Integer work, so it equals the plain version
    bit for bit.  Launches count under ``transition_counts_codes``.
    """
    if not _same_device("transition_counts", locs, n_locs):
        return transition_counts_plain(locs, n_locs)
    _require(locs.dtype == torch.int32 and locs.dim() == 2,
             "transition_counts: locs must be int32 (B, L)")
    B, L = locs.shape
    _require(n_locs.dtype == torch.int32 and n_locs.shape == (B,),
             "transition_counts: n_locs must be int32 (B,)")
    _require(16 <= TILE_CODES <= 65536, "transition_counts: TILE_CODES must be in [16, 65536]")
    locs, n_locs = locs.contiguous(), n_locs.contiguous()
    out = torch.empty(B, len(GAPS), NUM_CODES, NUM_CODES, dtype=torch.float32,
                      device=locs.device)
    if B == 0:
        return out
    done = torch.empty(B, dtype=torch.int32, device=locs.device)
    fn = _build.entry("transition_counts_codes")
    err = fn(locs.data_ptr(), n_locs.data_ptr(), done.data_ptr(), out.data_ptr(), B, L,
             TILE_CODES, _stream(locs))
    LAUNCHES["transition_counts_codes"] += 1
    _build.check("transition_counts_codes", err)
    return out


def transition_features_bytes_plain(data: torch.Tensor, offsets: torch.Tensor,
                                    seq_lens: torch.Tensor) -> torch.Tensor:
    """Plain version of ``transition_features_bytes``: the byte → code
    table, the compaction, and the counts over the compacted stream."""
    B, dev = seq_lens.shape[0], data.device
    codes = torch.from_numpy(BASE_LUT).to(dev)[data.to(torch.int64)]
    keep = codes != INVALID
    row = torch.repeat_interleave(torch.arange(B, device=dev), offsets.diff())[keep]
    n_codes = torch.bincount(row, minlength=B)
    first = torch.cumsum(n_codes, 0) - n_codes
    pos = torch.arange(row.shape[0], device=dev) - first[row]
    codes = torch.nn.functional.pad(codes[keep], (0, K - 1))
    locs, n_locs = locs_from_codes(codes[None], n_codes)
    counts = _pair_counts(locs[0], row, pos, n_locs[row], B).reshape(B, FEATURE_DIM)
    return scale_by_length(counts, seq_lens)


def transition_features_bytes(data: torch.Tensor, offsets: torch.Tensor,
                              seq_lens: torch.Tensor) -> torch.Tensor:
    """(N,) uint8 rows' bytes concatenated, (B+1,) int64 row offsets, (B,)
    int32 lengths in characters → (B, 12288) float32 features.

    Replaces ``transition_counts_pallas`` (palace_tpu/ops/pallas_kernels.py)
    together with the host packing before it and the unpack and scale
    around it (palace_tpu/ops/encoder.py ``pack_contigs``,
    ``features_from_packed``).  Bound on the H100: bytes — 5.1 MB in and
    25 MB out per batch of 512 × 10 kb.  Design (``csrc/transition_counts.cu``):
    a plan pass gives each row its tiles of ``TILE_BYTES`` (one block a
    tile, so a long row spreads over the card); a block compacts its bytes
    into shared memory, reading on past its tile for the 7 codes its last
    windows need, and counts into a 3 × 4096 int32 shared histogram, each
    thread holding its last 4 bins in registers so that low-complexity
    rows do not serialise the atomics; a row of several tiles sums them in
    its output row, scaled by its last tile.  Counts are integers, so the
    result equals the plain version exactly.
    """
    if not _same_device("transition_features_bytes", data, offsets, seq_lens):
        return transition_features_bytes_plain(data, offsets, seq_lens)
    B = seq_lens.shape[0] if seq_lens.dim() == 1 else -1
    _require(data.dtype == torch.uint8 and data.dim() == 1 and data.is_contiguous(),
             "transition_features_bytes: data must be contiguous uint8 (N,)")
    _require(seq_lens.dtype == torch.int32 and B >= 0,
             "transition_features_bytes: seq_lens must be int32 (B,)")
    _require(offsets.dtype == torch.int64 and offsets.shape == (B + 1,),
             "transition_features_bytes: offsets must be int64 (B+1,)")
    offsets, seq_lens = offsets.contiguous(), seq_lens.contiguous()
    out = torch.empty(B, FEATURE_DIM, dtype=torch.float32, device=data.device)
    if B == 0:
        return out
    scratch = torch.empty(2 * B + 1, dtype=torch.int32, device=data.device)
    fn = _build.entry("transition_counts")
    err = fn(data.data_ptr(), offsets.data_ptr(), seq_lens.data_ptr(), scratch.data_ptr(),
             out.data_ptr(), B, data.numel(), TILE_BYTES, _stream(data))
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
    Bound on the H100, a batch of 512: in bf16, bytes — the (B, 4096, 128)
    output, about 537 MB, 0.164 ms at 3.35 TB/s.  In float32, the 3×TF32
    products — 3 × 70.9 GFLOP at TF32's 495 TFLOP/s, 0.43 ms — above the
    bytes (1.07 GB out, 0.33 ms); all 72.5 GFLOP on the CUDA cores would
    take 1.083 ms at 67 TFLOP/s.  Design: a row's
    activations (1 MiB in bf16) do not fit in a block's shared memory as
    they fit in the TPU's VMEM, so one block per batch row runs two passes
    that recompute the cheap round-1 activations (input width 3) instead
    of storing them: pass A accumulates the p→f group mean, then the
    f-node side is finished in shared memory; pass B recomputes round 1
    64 p-nodes at a time, normalises them, multiplies by convs_1.1.lin_r
    and writes the output once.  In bf16 and f16 the three 128-deep
    products run on the tensor cores (``mma.sync`` m16n8k16, float32
    accumulators; their operands are already rounded to the working
    dtype, so only the order of the float32 sums changes); two blocks
    share an SM, so that one block's elementwise work and syncs overlap
    the other's products and stores; the epilogue is staged through
    shared memory and leaves in 16-byte stores, every output sector
    written whole.  float32 runs the same products on the tensor cores
    through a 3×TF32 split: one TF32 product (10 mantissa bits) would
    break float32's 1e-4 tolerance, so each operand is split into big =
    tf32(x) and small = tf32(x - big), and each 8-deep step adds
    small·big, big·small and big·big (``mma.sync`` m16n8k8) into one
    float32 chain, within 7e-6 of float32 products on an H100 80GB HBM3 at
    700.00 W.  A tile is split once, as it is stored; the weights'
    fragments stay split in registers; one block an SM stages its row's
    inputs in shared memory and fills one tile while it multiplies the
    other.  The CUDA kernel takes the published widths (f = 64, gd =
    128).  One launch a call.
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
    # the kernels copy weight rows (the float32 one also a row's x_p) 16 bytes at a time
    w = w.clone() if w.data_ptr() % 16 else w
    x_p = x_p.clone() if x_p.data_ptr() % 16 else x_p
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


def conv_taps(w: torch.Tensor) -> torch.Tensor:
    """(O, C, K) Conv1d weight → (K, O, C) contiguous: the 16-bit kernel's
    layout, one tap's (O, C) product operand a slab, channels innermost."""
    return w.permute(2, 0, 1).contiguous()


def conv_layouts(n_layers: int, dtype: torch.dtype) -> list:
    """(input channel-major, output channel-major) of each layer as
    ``conv_head`` runs it.  float32 keeps every layer channel-major,
    (B, C, L).  The 16-bit kernel reads the head's channel-major input,
    keeps the intermediates channel-last, (B, L, 64), and writes the
    public channel-major result from the last layer."""
    if dtype == torch.float32:
        return [(True, True)] * n_layers
    _require(n_layers == 3, "conv_head: the 16-bit kernel takes the three-layer head")
    return [(True, False), (False, False), (False, True)]


def conv_layer_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     in_channel_major: bool, out_channel_major: bool) -> torch.Tensor:
    """Plain version of ``conv_layer``."""
    y = conv_head_plain(x if in_channel_major else x.transpose(1, 2), [w], [b])
    return y if out_channel_major else y.transpose(1, 2).contiguous()


def conv_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               in_channel_major: bool, out_channel_major: bool) -> torch.Tensor:
    """One layer of ``conv_head``, in the layouts ``conv_layouts`` gives:
    x (B, C, L) if ``in_channel_major`` else (B, L, C), a (64, C, 8)
    weight and a (64,) bias → (B, 64, L - 7) if ``out_channel_major``
    else (B, L - 7, 64), contiguous.  One launch."""
    if not _same_device("conv_head", x, w, b):
        return conv_layer_plain(x, w, b, in_channel_major, out_channel_major)
    dt = x.dtype
    _require(dt in _DTYPE_CODES and w.dtype == dt and b.dtype == dt,
             f"conv_head: activations, weights and biases must share one of {list(_DTYPE_CODES)}")
    _require(x.dim() == 3, "conv_head: activations must be (B, C, L) or (B, L, C)")
    B, C, L = x.shape if in_channel_major else (x.shape[0], x.shape[2], x.shape[1])
    _require(w.shape == (CONV_OUT, C, CONV_TAPS) and b.shape == (CONV_OUT,)
             and L >= CONV_TAPS,
             f"conv_head: the CUDA kernel takes ({CONV_OUT}, C, {CONV_TAPS}) weights "
             f"and L >= {CONV_TAPS}")
    if dt == torch.float32:
        _require(in_channel_major and out_channel_major and C % 16 == 0,
                 "conv_head: the float32 kernel takes channel-major layers, C % 16 == 0")
        # work: the launch splits the weight into its TF32 planes there, on the card
        wk, work = w.contiguous(), torch.empty(2 * w.numel(), dtype=torch.int32,
                                               device=x.device)
    else:
        _require((in_channel_major and not out_channel_major and C in (64, 128))
                 or (not in_channel_major and C == 64),
                 "conv_head: the 16-bit kernel takes the layers of conv_layouts: a first "
                 "layer of 128 or 64 channels, then 64")
        wk, work = conv_taps(w), None
    L_out = L - CONV_TAPS + 1
    shape = (B, CONV_OUT, L_out) if out_channel_major else (B, L_out, CONV_OUT)
    out = torch.empty(shape, dtype=dt, device=x.device)
    if B:
        x = x.contiguous()
        err = _build.entry("conv_head")(
            x.data_ptr(), wk.data_ptr(), b.contiguous().data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), B, C, L, _DTYPE_CODES[dt],
            int(in_channel_major), int(out_channel_major), _stream(x))
        LAUNCHES["conv_head"] += 1
        _build.check("conv_head", err)
    return out


def conv_head(x: torch.Tensor, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """The scorer's Conv1d(k=8)+bias+relu ×3 head (128→64→64→64).

    x (B, C0, L) channel-major activations in the working dtype, three
    (O, C, K) weights and three (O,) biases → contiguous (B, O, L - 21).
    Products accumulate in float32; bias and relu in float32; the result
    of each layer rounds to the working dtype.

    Replaces ``conv_head_pallas`` (palace_tpu/ops/pallas_kernels.py).
    Bound on the H100: operations — about 1.07 GFLOP a contig, 548 GFLOP
    per batch of 512, 0.554 ms at bf16's 989 TFLOP/s.  Design, in bf16
    and f16: an implicit GEMM on the tensor cores (``mma.sync`` m16n8k16,
    float32 accumulators), one layer a launch, as the TPU kernel's 8
    tap-shifted (O, C)·(C, W) products.  Shared memory holds the input
    tile [position][channel], so a tap shift is a row shift that keeps
    ``ldmatrix`` aligned; persistent blocks load a layer's weights once
    and walk over 128-position tiles.  The layers stay unfused and on
    ``mma.sync``: unfused they move 1.9 GB a batch, 0.56 ms at 3.35 TB/s,
    while ``ldmatrix``'s shared-memory traffic holds ``mma.sync`` near
    half the tensor peak, so fusing pays only with ``wgmma`` and TMA.
    The intermediates are channel-last inside this function
    (``conv_layouts``).  An mma rounds its sum toward zero, so each
    16-channel slice's 8 taps are a chain of their own, added to the
    float32 accumulators with round-to-nearest: that keeps large outputs
    within ``compare.CONV_LARGE_OUTPUTS`` of the float64 sums.

    float32, the pipeline's default dtype, runs the same products on the
    tensor cores through a 3×TF32 split (``mma.sync`` m16n8k8 on TF32
    operands): one TF32 product would break float32's 1e-4 tolerance, so
    each operand is split into big = tf32(x) and small = tf32(x - big), and
    each 8-deep step adds small·big, big·small and big·big.  Its bounds, a
    batch of 512: the 3×TF32 products, 3 × 548 GFLOP at TF32's 495 TFLOP/s,
    3.32 ms, which its share is read against; all 548 GFLOP on the CUDA
    cores at 67 TFLOP/s, 8.18 ms; bytes, about 1.12 ms with the
    intermediates written and read back.  A 16-channel slice's 48 mma are
    one chain, added with round-to-nearest as in 16 bits: one chain over a
    whole tile drifts past 1e-4 where outputs reach 40
    (``tests/test_torch_conv_tf32.py``).  The weights are split once a call
    on the card, by a small kernel of the same launch, into planes that
    persistent blocks stream a slice at a time through a two-stage ring;
    the input is split once as a block stores its tile into shared memory.
    Every float32 layer stays channel-major.  Each layer is one launch (in
    float32, the split and the layer), and counts as one.
    """
    if not _same_device("conv_head", x, *weights, *biases):
        return conv_head_plain(x, weights, biases)
    _require(x.dtype in _DTYPE_CODES, f"conv_head: dtype {x.dtype} not supported")
    for w, b, (in_cm, out_cm) in zip(weights, biases, conv_layouts(len(weights), x.dtype)):
        x = conv_layer(x, w, b, in_cm, out_cm)
    return x


# ---------------------------------------------------------------------------
# K4: sliding-window good flags of the eref reference scan, bit-packed
# ---------------------------------------------------------------------------

#: the largest window K4 takes: the block's scan of tile + window positions
#: (``window_hits``: tile + window / 32 + 1 words) lives in shared memory,
#: and single and trio sums share one int32
GOOD_WINDOWS_MAX_WINDOW = 32768


def pack_bits_plain(flags: torch.Tensor) -> torch.Tensor:
    """(NB, L) bool, L % 8 == 0 → (NB, L/8) uint8, little-endian bit order
    (``np.packbits(..., bitorder="little")``)."""
    NB, L = flags.shape
    weights = (1 << torch.arange(8, device=flags.device, dtype=torch.int32))
    return (flags.reshape(NB, L // 8, 8).to(torch.int32) * weights).sum(dim=2).to(torch.uint8)


def good_windows_plain(counts: torch.Tensor, hashes: torch.Tensor, window: int,
                       one_min: int, three_min: int, least_depth: int = 3) -> torch.Tensor:
    """Plain version of ``good_windows``."""
    hit = (counts == least_depth) & (hashes != 0)
    return _window_stage_plain(hit.sum(dim=2), window, one_min, three_min)


def _window_stage_plain(n: torch.Tensor, window: int, one_min: int,
                        three_min: int) -> torch.Tensor:
    """(NB, L) coders hit a position → (NB, L/8) packed good flags: K4's
    window stage."""
    L = n.shape[1]
    cs = torch.cumsum((n > 0).to(torch.int32), dim=1)
    ct = torch.cumsum((n == 3).to(torch.int32), dim=1)
    # the sum over the `window` positions ending at j; for j < window the
    # shifted prefix is 0, which gives the reference's growing prefix
    lag = min(window, L)
    one = cs - torch.nn.functional.pad(cs, (lag, 0))[:, :L]
    three = ct - torch.nn.functional.pad(ct, (lag, 0))[:, :L]
    return pack_bits_plain((one >= one_min) & (three >= three_min))


def good_windows(counts: torch.Tensor, hashes: torch.Tensor, window: int,
                 one_min: int, three_min: int, least_depth: int = 3) -> torch.Tensor:
    """Good-window flags of the eref scan, packed 8 positions a byte.

    counts (NB, L, 3) uint8 count-table values and hashes (NB, L, 3) int64
    per (position, coder), L % 8 == 0 → (NB, L/8) uint8.  A coder hits at
    j when its count equals ``least_depth`` and its hash is not 0; "single"
    means at least one coder hits, "trio" all three.  Both are summed over
    the ``window`` positions ending at j (a growing prefix for j < window),
    and j is good when single_sum ≥ one_min and trio_sum ≥ three_min.  Bit
    j % 8 of byte j // 8 holds position j (little-endian, as
    ``np.packbits(..., bitorder="little")``).

    Replaces ``good_windows_pallas`` (palace_tpu/ops/pallas_kernels.py)
    and, on Phase B's path, its XLA twin ``good_windows_batch``
    (palace_tpu/ops/window.py).  Bound on the H100: bytes — 27 B read per
    position (3 counts, 3 int64 hashes) against a few integer operations.
    Design: the TPU kernel walks the tiles in order and carries the last
    ``window`` indicators in VMEM; Hopper's blocks run in no order, so
    each block (one row, 2048 positions) rereads the ``window`` positions
    before its tile (positions before 0 count as misses, which gives the
    growing prefix), scans single and trio at once as ``(trio << 16) |
    single`` in shared memory, and packs 32 flags a warp with
    ``__ballot_sync``.  Integer work, so it equals the plain version.
    """
    if not _same_device("good_windows", counts, hashes):
        return good_windows_plain(counts, hashes, window, one_min, three_min, least_depth)
    _require(counts.dim() == 3 and counts.shape[2] == 3 and hashes.shape == counts.shape,
             "good_windows: counts and hashes must be (NB, L, 3)")
    NB, L, _ = counts.shape
    _require(counts.dtype == torch.uint8 and hashes.dtype == torch.int64,
             "good_windows: counts must be uint8 and hashes int64")
    _require(L % 8 == 0, "good_windows: L must be a multiple of 8")
    _require(1 <= window <= GOOD_WINDOWS_MAX_WINDOW,
             f"good_windows: window must be in [1, {GOOD_WINDOWS_MAX_WINDOW}]")
    _require(NB < 65536, "good_windows: at most 65535 rows a launch")
    counts, hashes = counts.contiguous(), hashes.contiguous()
    out = torch.empty(NB, L // 8, dtype=torch.uint8, device=counts.device)
    if NB == 0 or L == 0:
        return out
    fn = _build.entry("good_windows")
    err = fn(counts.data_ptr(), hashes.data_ptr(), out.data_ptr(), NB, L, window,
             one_min, three_min, least_depth, _stream(counts))
    LAUNCHES["good_windows"] += 1
    _build.check("good_windows", err)
    return out


# ---------------------------------------------------------------------------
# K4 fused: one Phase B chunk from the packed phagedb, hashed, looked up and
# windowed in one kernel
# ---------------------------------------------------------------------------

#: positions a block of the fused scan takes (``csrc/good_windows.cu``
#: ``kScanTile``)
SCAN_TILE = 8192


def _check_scan(name: str, packed: torch.Tensor, mask: torch.Tensor, offsets: torch.Tensor,
                table: torch.Tensor, perm: np.ndarray, k: int, target: int) -> None:
    """The checks ``scan_chunk`` and ``scan_hits`` share; the offsets are read
    back to check them against the buffers (a synchronize, the span
    ``eref.scan_check``)."""
    _require(all(t.dtype == torch.uint8 and t.dim() == 1 and t.is_contiguous()
                 for t in (packed, mask, table)),
             f"{name}: packed, mask and table must be contiguous uint8 (n,)")
    _require(offsets.dtype == torch.int64 and offsets.dim() == 2 and offsets.shape[1] == 3,
             f"{name}: offsets must be int64 (rows, 3)")
    _require(1 <= k <= 32 and np.shape(perm) == (k, 3),
             f"{name}: k must be in [1, 32] and perm (k, 3)")
    _require(target % 8 == 0 and k <= target <= 1 << 30,
             f"{name}: target must be a multiple of 8 in [k, 2^30]")
    rows = offsets.shape[0]
    _require(rows < 65536, f"{name}: at most 65535 rows a launch")
    if rows:
        with StageTimer("eref.scan_check"):
            low, high = torch.stack([offsets.amin(0), offsets.amax(0)]).tolist()
        _require(min(low) >= 0 and high[0] + target // 4 <= packed.numel()
                 and high[1] + target // 8 <= mask.numel(),
                 f"{name}: offsets and ref_len must be >= 0, and each row's target/4 code "
                 "bytes and target/8 mask bytes inside packed and mask")


def _coder_masks(perm: np.ndarray, k: int):
    """``kmer.coder_masks`` as the 18 uint32 the kernels take."""
    return (ctypes.c_uint32 * 18)(*coder_masks(perm, k).reshape(-1).tolist())


def scan_hashes_plain(packed: torch.Tensor, mask: torch.Tensor, offsets: torch.Tensor,
                      perm: np.ndarray, k: int, target: int) -> torch.Tensor:
    """The (rows, target, 3) int64 hashes of one chunk (the inputs of
    ``scan_chunk``): slice each row's packed codes, unpack, mask the tail
    past ``ref_len`` (it may hold the next reference), hash, and pad the
    last k-1 positions with hash 0.  A pad row, offsets (0, 0, 0), masks to
    code 4 everywhere."""
    dev = packed.device
    pb = packed[offsets[:, 0:1] + torch.arange(target // 4, device=dev)]
    mb = mask[offsets[:, 1:2] + torch.arange(target // 8, device=dev)]
    codes = unpack_codes_mask(pb, mb)
    codes.masked_fill_(torch.arange(target, device=dev) >= offsets[:, 2:3], 4)
    hashes = kmer_hashes_masked(codes, perm, k)
    return torch.nn.functional.pad(hashes, (0, 0, 0, k - 1))


def scan_counts_plain(packed: torch.Tensor, mask: torch.Tensor, offsets: torch.Tensor,
                      table: torch.Tensor, perm: np.ndarray, k: int, target: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The counts and hashes, (rows, target, 3) uint8 and int64, that
    ``good_windows`` scans for one chunk: ``scan_hashes_plain``, then the
    table lookup (hash 0 always reads 0)."""
    hashes = scan_hashes_plain(packed, mask, offsets, perm, k, target)
    counts = table[hashes].masked_fill_(hashes == 0, 0)
    return counts, hashes


def scan_chunk_plain(packed: torch.Tensor, mask: torch.Tensor, offsets: torch.Tensor,
                     table: torch.Tensor, perm: np.ndarray, k: int, target: int, window: int,
                     one_min: int, three_min: int, least_depth: int = 3) -> torch.Tensor:
    """Plain version of ``scan_chunk``: ``scan_counts_plain``, then
    ``good_windows_plain``."""
    counts, hashes = scan_counts_plain(packed, mask, offsets, table, perm, k, target)
    return good_windows_plain(counts, hashes, window, one_min, three_min, least_depth)


def scan_chunk(packed: torch.Tensor, mask: torch.Tensor, offsets: torch.Tensor,
               table: torch.Tensor, perm: np.ndarray, k: int, target: int, window: int,
               one_min: int, three_min: int, least_depth: int = 3) -> torch.Tensor:
    """Good-window flags of one Phase B chunk, straight from the packed
    phagedb.

    packed (P,) and mask (Q,) uint8: the phagedb's 2-bit codes and invalid
    bits (``search/index.py``), padded so that every row's slice fits;
    offsets (rows, 3) int64: a row's code byte offset, mask byte offset and
    ref_len, (0, 0, 0) for a pad row; table (2^k,) uint8 counts; perm (k,
    3) the coder permutation, on the host → (rows, target/8) uint8: the
    ``good_windows`` flags of ``scan_counts_plain``'s counts and hashes
    over each row's ``target`` positions, bit j % 8 of byte j // 8.

    Replaces ``good_windows_pallas`` (palace_tpu/ops/pallas_kernels.py)
    together with the unpack, hash and lookup before it: the JAX
    package's ``_scan_body`` (palace_tpu/search/eref.py).  Bound on the
    H100: by bytes, each input byte read once, 0.375 B a position of packed
    phagedb and 0.125 B of flags, plus 3 B a position of table if each
    count were read once; in fact every valid position reads 3 counts at
    random addresses of the 2^k-byte table (4 GiB at k = 32), a 32-byte
    sector each, and those reads are the floor the design is held to.
    Design (``csrc/good_windows.cu``): one block takes ``SCAN_TILE``
    positions of a row and the ``window`` before them; it builds the
    codes' bit-planes in shared memory, hashes 8 positions a thread with
    the masks of ``kmer.coder_masks`` (funnel shifts, a bit reversal, no
    loop over k), issues their 24 table reads together (none for hash 0),
    and runs ``good_windows``' window stage on the indicators.  No hash or
    count goes to device memory.  Integer work, so it equals the plain
    version.

    Both routes check their inputs; the offsets are read back to check
    them against the buffers, one synchronize a call.
    """
    cuda = _same_device("scan_chunk", packed, mask, offsets, table)
    _check_scan("scan_chunk", packed, mask, offsets, table, perm, k, target)
    _require(table.numel() == 1 << k, "scan_chunk: the table must hold 2^k bytes")
    _require(1 <= window <= GOOD_WINDOWS_MAX_WINDOW,
             f"scan_chunk: window must be in [1, {GOOD_WINDOWS_MAX_WINDOW}]")
    if not cuda:
        return scan_chunk_plain(packed, mask, offsets, table, perm, k, target, window,
                                one_min, three_min, least_depth)
    rows = offsets.shape[0]
    offsets = offsets.contiguous()
    out = torch.empty(rows, target // 8, dtype=torch.uint8, device=packed.device)
    if rows == 0:
        return out
    masks = _coder_masks(perm, k)  # referenced until the call returns
    err = _build.entry("scan_chunk")(
        packed.data_ptr(), mask.data_ptr(), offsets.data_ptr(), table.data_ptr(),
        ctypes.addressof(masks), out.data_ptr(), rows, target, k, window, one_min, three_min,
        least_depth, _stream(packed))
    LAUNCHES["scan_chunk"] += 1
    _build.check("scan_chunk", err)
    return out


# ---------------------------------------------------------------------------
# K4 against a table split by hash range over a mesh: each rank's hit
# bit-planes of a chunk, then the flags of their OR
# ---------------------------------------------------------------------------

def scan_hits_plain(packed: torch.Tensor, mask: torch.Tensor, offsets: torch.Tensor,
                    shard: torch.Tensor, lo: int, perm: np.ndarray, k: int, target: int,
                    least_depth: int = 3) -> torch.Tensor:
    """Plain version of ``scan_hits``: ``scan_counts_plain``'s hashes, the
    counts of those in ``[lo, lo + shard.numel())`` read from the shard and
    every other count 0, the hits of ``good_windows_plain`` per coder, packed
    along the positions."""
    hashes = scan_hashes_plain(packed, mask, offsets, perm, k, target)
    mine = (hashes != 0) & (hashes >= lo) & (hashes < lo + shard.numel())
    counts = torch.zeros(hashes.shape, dtype=torch.uint8, device=hashes.device)
    counts[mine] = shard[hashes[mine] - lo]
    hit = mine & (counts == least_depth)  # (rows, target, 3)
    rows = hit.shape[0]
    return pack_bits_plain(hit.permute(0, 2, 1).reshape(rows * 3, target)).reshape(
        rows, 3, target // 8)


#: the most bits of ``scan_hits``' hit filter: 2^27 bits, 16 MiB.  On the
#: H100 random reads within 4-16 MiB run at 112-115 G/s, within 32 MiB at
#: 83 and 64 MiB at 48; on phase 22's chunks at world 1 filters of 2^25-2^29
#: bits gave 1.85, 1.64, 1.59, 2.00 and 3.06 ms, fewer bits setting more of
#: them (``palace_tpu_torch/tools/k4_sharded.py variants``); read at each call
HIT_FILTER_BITS = 27


@dataclass(frozen=True)
class HitFilter:
    """``scan_hits``' hit filter of one shard (``hit_filter``): ``words``,
    (2^fbits / 32,) int32, has bit ``i mod 2^fbits`` set for every slot i
    of the shard that counts ``least_depth``; ``shard`` is the (data_ptr,
    numel) of the shard it was read from.  It holds for the shard as it
    was: build it again after the shard changes."""
    words: torch.Tensor
    fbits: int
    least_depth: int
    shard: Tuple[int, int]


def _filter_bits(size: int) -> int:
    """One bit a slot up to 2^HIT_FILTER_BITS slots, at least one 32-bit word."""
    return max(5, min(HIT_FILTER_BITS, (size - 1).bit_length()))


def hit_filter_plain(shard: torch.Tensor, least_depth: int = 3) -> HitFilter:
    """Plain version of ``hit_filter``: the shard 2^fbits slots at a time,
    slot i + j onto bit j."""
    fbits = _filter_bits(shard.numel())
    n = 1 << fbits
    bits = torch.zeros(n, dtype=torch.bool, device=shard.device)
    for i in range(0, shard.numel(), n):
        part = shard[i:i + n] == least_depth
        bits[:part.numel()] |= part
    words = pack_bits_plain(bits.reshape(1, -1)).reshape(-1).view(torch.int32)
    return HitFilter(words, fbits, least_depth, (shard.data_ptr(), shard.numel()))


def hit_filter(shard: torch.Tensor, least_depth: int = 3) -> HitFilter:
    """The hit filter ``scan_hits`` reads before a shard: a bitmap of
    2^fbits bits, fbits = min(HIT_FILTER_BITS, ceil(log2 S)) (at least 32
    bits), with bit ``i mod 2^fbits`` set where ``shard[i] == least_depth``.
    A shard of at most 2^HIT_FILTER_BITS slots gets one bit a slot; a larger one
    folds its slots onto the bits, so that a clear bit rules out every
    slot it stands for and a set bit is read through to the shard.

    No TPU kernel computes it: it is the part of ``scan_hits``' redesign
    that is made once a Phase B (``search/eref.py``), since the table does
    not change while Phase B reads it.  Bound on the H100: bytes, the shard
    read once and the bitmap written once.  Design (``csrc/good_windows.cu``
    ``hit_filter_kernel``): the bitmap zeroed (``cudaMemsetAsync``), then
    the shard read 16 B a load by 8 blocks an SM, ``__vcmpeq4`` for the
    matching bytes and an ``atomicOr`` a match (few: most slots count 0).
    Integer work, so it equals the plain version.  One launch a call.
    """
    cuda = _same_device("hit_filter", shard)
    _require(shard.dtype == torch.uint8 and shard.dim() == 1 and shard.is_contiguous()
             and 0 < shard.numel() <= 1 << 32,
             "hit_filter: the shard must be contiguous uint8 (S,), 0 < S <= 2^32")
    _require(0 <= least_depth <= 255, "hit_filter: least_depth must be in [0, 255]")
    if not cuda:
        return hit_filter_plain(shard, least_depth)
    fbits = _filter_bits(shard.numel())
    words = torch.empty(1 << (fbits - 5), dtype=torch.int32, device=shard.device)
    err = _build.entry("hit_filter")(shard.data_ptr(), shard.numel(), words.data_ptr(), fbits,
                                     least_depth, _stream(shard))
    LAUNCHES["hit_filter"] += 1
    _build.check("hit_filter", err)
    return HitFilter(words, fbits, least_depth, (shard.data_ptr(), shard.numel()))


def scan_hits(packed: torch.Tensor, mask: torch.Tensor, offsets: torch.Tensor,
              shard: torch.Tensor, lo: int, perm: np.ndarray, k: int, target: int,
              least_depth: int, filt: Optional[HitFilter]) -> torch.Tensor:
    """One rank's hit bit-planes of a Phase B chunk against its shard of a
    count table split by hash range (``count_table.ShardedCountTable``).

    ``scan_chunk``'s inputs, with ``shard`` (S,) uint8, the counts of the
    hashes ``[lo, lo + S)``, in place of the table → (rows, 3, target/8)
    uint8: bit j % 8 of byte j // 8 of plane c is set where coder c's hash at
    position j is not 0, lies in the shard's range and counts
    ``least_depth``.  Every hash lies in one rank's range, so the sum of
    the ranks' planes (``dist.all_reduce``, uint8) is their OR, and
    ``window_hits`` of that equals ``scan_chunk`` on the whole table.
    ``filt`` is the shard's ``hit_filter`` for ``least_depth``, made once
    for many chunks (one a Phase B in ``search/eref.py``).  The card's
    kernel reads it and raises without it; the plain version reads the
    shard itself, so on the CPU it may be None.  A filter holds for the
    shard as it was when it was made, and the check below knows the shard
    only by its address and size: a caller that writes to the shard
    (``ShardedCountTable.add_packed``) makes the filter again before the
    next call, or a clear bit would hide a hit.

    Replaces, with ``window_hits``, ``good_windows_pallas``
    (palace_tpu/ops/pallas_kernels.py) on the sharded route of the JAX
    package's ``_scan_ref_fused_sharded`` (palace_tpu/search/eref.py), where
    every device's partial lookups (int32 counts, 12 B a position) are
    joined by a ``psum``; here 0.375 B a position crosses the mesh.  Bound
    on the H100: bytes, 0.375 B a position in (codes and invalid bits) and
    0.375 B out, 24 B of offsets a row, the filter read once, and a
    32-byte sector for each shard read behind a set filter bit (14.3 M of
    phase 22's 125.7 M in-range hashes at world 1, 2^27 bits); the
    filter's probes, a 32-byte sector for each in-range hash, are served
    by the L2 and are a term of their own, with no published rate.  The
    first design read the shard for every in-range hash, a floor of 1.20
    ms there at a 32-byte sector each.  What the card does with such
    reads (``palace_tpu_torch/tools/k4_sharded.py variants``, H100 80GB
    HBM3 at 700 W): 1-byte reads at random addresses of the 4 GiB table
    run at 30.5 G/s, 4.11 ms, whether 8, 24 or 64 are in flight a thread,
    and the first design, reading the shard for every in-range hash, at
    28.6 G/s: that ceiling is device memory's rate for random sectors, not
    the kernel's.  Read in 256 MiB or 1 GiB windows, or grouped by region
    in the order they come, they gain under 10 %; read within 4-16 MiB,
    which the L2 holds, they run at 116 G/s.  So the design puts what a
    probe asks, count == least_depth, into a bitmap the L2 holds
    (``hit_filter``, 2^27 bits, 16 MiB) and reads the shard only where a
    bit is set.  Design (``csrc/good_windows.cu``): ``scan_chunk``'s steps
    1a-1b (bit-planes in shared memory, funnel-shift hashing) over
    ``SCAN_TILE`` positions a block, no window halo; each thread's 24
    filter reads issued together, then the shard's reads behind the set
    bits, and three ``__ballot_sync`` words a warp.  Integer work, so it
    equals the plain version.  Checks its inputs as ``scan_chunk`` does
    (one synchronize a call), and the filter against the shard and
    ``least_depth``.
    """
    cuda = _same_device("scan_hits", packed, mask, offsets, shard)
    _check_scan("scan_hits", packed, mask, offsets, shard, perm, k, target)
    _require(0 <= lo < 1 << k, "scan_hits: the shard's range [lo, lo + S) must start "
                               "inside the 2^k hashes")
    if filt is not None:
        _require(filt.shard == (shard.data_ptr(), shard.numel())
                 and filt.least_depth == least_depth and filt.words.device == shard.device
                 and filt.words.numel() << 5 == 1 << filt.fbits,
                 "scan_hits: filt must be this shard's hit_filter for least_depth")
    if not cuda:
        return scan_hits_plain(packed, mask, offsets, shard, lo, perm, k, target, least_depth)
    _require(filt is not None, "scan_hits: on the card filt must be the shard's hit_filter")
    rows = offsets.shape[0]
    offsets = offsets.contiguous()
    out = torch.empty(rows, 3, target // 8, dtype=torch.uint8, device=packed.device)
    if rows == 0:
        return out
    masks = _coder_masks(perm, k)  # referenced until the call returns
    err = _build.entry("scan_hits")(
        packed.data_ptr(), mask.data_ptr(), offsets.data_ptr(), shard.data_ptr(),
        filt.words.data_ptr(), filt.fbits, ctypes.addressof(masks), out.data_ptr(), rows,
        target, k, least_depth, lo, lo + shard.numel(), _stream(packed))
    LAUNCHES["scan_hits"] += 1
    _build.check("scan_hits", err)
    return out


def window_hits_plain(planes: torch.Tensor, window: int, one_min: int,
                      three_min: int) -> torch.Tensor:
    """Plain version of ``window_hits``."""
    rows, _, nbytes = planes.shape
    bits = (planes[..., None] >> torch.arange(8, device=planes.device, dtype=torch.uint8)) & 1
    n = bits.reshape(rows, 3, nbytes * 8).sum(dim=1)
    return _window_stage_plain(n, window, one_min, three_min)


def window_hits(planes: torch.Tensor, window: int, one_min: int,
                three_min: int) -> torch.Tensor:
    """Good-window flags from the OR of the ranks' ``scan_hits`` planes.

    planes (rows, 3, L/8) uint8 → (rows, L/8) uint8 flags, bit j % 8 of
    byte j // 8: a position's coders hit is the popcount of its three bits,
    and the window stage is ``good_windows``'.

    Replaces, with ``scan_hits``, ``good_windows_pallas``
    (palace_tpu/ops/pallas_kernels.py) on the JAX package's sharded Phase B
    route.  Bound on the H100: bytes, 0.375 B a position in and 0.125 B
    out.  Design (``csrc/good_windows.cu``), bit-parallel: the input is
    bits, and a window sum is a difference of two prefix popcounts.  A
    block takes 256 words of 32 output positions of a row and the
    ``ceil(window / 32) + 1`` words before them; it forms single = p0 | p1
    | p2 and trio = p0 & p1 & p2 a word in shared memory, scans the words'
    popcounts once, and each thread forms one word of 32 flags: the sum
    ending before the word from two prefixes and a popcount, then a bit
    added and a bit (a funnel shift of two words) taken away a position,
    stored as one 4-byte word.  Rows whose plane bytes are not a multiple
    of 4, or planes not on a 4-byte boundary, are read and stored a byte
    at a time.  Integer work, so it equals the plain version
    (``tests/test_torch_window_bits.py`` emulates it).  Both routes check
    their inputs.
    """
    cuda = _same_device("window_hits", planes)
    _require(planes.dtype == torch.uint8 and planes.dim() == 3 and planes.shape[1] == 3,
             "window_hits: planes must be uint8 (rows, 3, L/8)")
    _require(1 <= window <= GOOD_WINDOWS_MAX_WINDOW,
             f"window_hits: window must be in [1, {GOOD_WINDOWS_MAX_WINDOW}]")
    rows, _, nbytes = planes.shape
    _require(rows < 65536 and nbytes * 8 <= 1 << 30,
             "window_hits: at most 65535 rows a launch and 2^30 positions a row")
    if not cuda:
        return window_hits_plain(planes, window, one_min, three_min)
    planes = planes.contiguous()
    out = torch.empty(rows, nbytes, dtype=torch.uint8, device=planes.device)
    if rows == 0 or nbytes == 0:
        return out
    err = _build.entry("window_hits")(planes.data_ptr(), out.data_ptr(), rows, nbytes * 8,
                                      window, one_min, three_min, _stream(planes))
    LAUNCHES["window_hits"] += 1
    _build.check("window_hits", err)
    return out


# ---------------------------------------------------------------------------
# Phase A: a batch of the reader's codes counted into the table in one kernel
# ---------------------------------------------------------------------------

def count_codes_plain(table: torch.Tensor, codes: torch.Tensor, perm: np.ndarray, k: int,
                      cap: int = 3) -> torch.Tensor:
    """Plain version of ``count_codes``: ``kmer.kmer_hashes`` of the codes
    with the invalid k-mers' hashes at slot 0, then
    ``count_table.CountTable.add_kmers``' update (``torch.unique``'s
    distinct hashes and multiplicities, ``min(old + multiplicity, cap)``
    gathered and scattered)."""
    slots, mult = torch.unique(kmer_hashes_masked(codes, perm, k).reshape(-1),
                               return_counts=True)
    table[slots] = torch.clamp(table[slots].to(torch.int64) + mult, max=cap).to(torch.uint8)
    return table


def count_codes(table: torch.Tensor, codes: torch.Tensor, perm: np.ndarray, k: int,
                cap: int = 3, counters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Count every k-mer of a batch of read codes into a saturating count
    table, in place.

    table (2^k,) uint8 counts; codes (B, L) uint8, the rows
    ``search.eref.read_code_batches`` yields (0-3 a base, 4 or more invalid
    or pad); perm (k, 3) the coder permutation, on the host; ``counters``,
    None or (2,) int64 on the card, gets the card's updates issued as a CAS
    added to [0] and those skipped at cap to [1] (how they split depends on
    the order the threads run, so the plain version leaves them) → the
    table, each of
    the k-mers' three canonical hashes (``kmer.kmer_hashes``) counted once,
    ``min(old + multiplicity, cap)``; a k-mer with an invalid base counts
    at slot 0.

    Replaces, on one device, the host's ``kmer.pack_codes_mask`` and
    ``count_table.CountTable.add_packed``'s unpack, hashing (192 tensor
    launches at k = 32) and update through ``torch.unique``, whose output
    size it reads back (a synchronize a batch); no TPU kernel computes it.
    Bound on the H100: bytes, 1 B a code read once (5.2 MB a batch of
    32,768 rows of 160), the table touched only at the updates; the floor
    of that traffic is a 32-byte sector read for each nonzero hash and a CAS
    for each below cap, against the card's 30.6 G/s for 1-byte reads at
    random addresses of a 4 GiB table (``scan_hits``' measure): 0.41 ms for
    a batch's 12.7 M hashes.  Design (``csrc/count_codes.cu``): a block
    takes rows, makes their bit-planes in shared memory with a warp's
    ballots, hashes 8 k-mers a thread as ``scan_chunk`` does and reads the
    aligned 32-bit words of their 24 slots together; a slot at cap is
    skipped (counts only grow, so that is exact), the others take an
    ``atomicCAS`` of the word with the byte one higher, retried from the
    returned word where another thread changed it; a block's hashes of 0
    are summed and added to slot 0 once.  Serial saturating increments
    give ``min(old + multiplicity, cap)`` in any order, so the table equals
    the plain version's byte for byte.  One launch a call, none for rows
    shorter than k; nothing is read back.
    """
    cuda = _same_device("count_codes", table, codes)
    _require(table.dtype == torch.uint8 and table.dim() == 1 and table.is_contiguous(),
             "count_codes: the table must be contiguous uint8 (2^k,)")
    _require(codes.dtype == torch.uint8 and codes.dim() == 2,
             "count_codes: codes must be uint8 (B, L)")
    _require(2 <= k <= 32 and np.shape(perm) == (k, 3),
             "count_codes: k must be in [2, 32] and perm (k, 3)")
    _require(table.numel() == 1 << k, "count_codes: the table must hold 2^k bytes")
    _require(0 <= cap <= 255, "count_codes: cap must be in [0, 255]")
    B, L = codes.shape
    _require(L <= 1 << 16, "count_codes: at most 2^16 codes a row")
    if counters is not None:
        _require(counters.dtype == torch.int64 and counters.shape == (2,)
                 and counters.is_contiguous() and counters.device == table.device,
                 "count_codes: counters must be contiguous int64 (2,) on the table's device")
    if not cuda:
        return count_codes_plain(table, codes, perm, k, cap)
    if L < k or B == 0:
        return table
    codes = codes.contiguous()
    masks = _coder_masks(perm, k)  # referenced until the call returns
    # the launch runs in the calling thread's current context: the table's
    # card's, which need not be the current device (Phase A on "cuda:1")
    with torch.cuda.device(table.device):
        err = _build.entry("count_codes")(
            codes.data_ptr(), table.data_ptr(), ctypes.addressof(masks),
            0 if counters is None else counters.data_ptr(), B, L, k, cap, _stream(codes))
    LAUNCHES["count_codes"] += 1
    _build.check("count_codes", err)
    return table
