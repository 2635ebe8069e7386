"""The scorer's weights, drawn on the device from the run's seed.

One ``torch.rand`` call on a generator of the device draws every
parameter at once, in float32, the type a checkpoint holds them in;
each parameter is a view of it, 256-byte aligned: weights uniform
within ``GAIN / sqrt(fan_in)``, biases within ``1 / sqrt(fan_in)``, the
LayerNorm near 1 and 0.  The last layer is then set from a few of the
sample's contigs (``centre_head``) so that the scores spread over (0, 1)
for every seed, as a trained model's do, and none sits at 0 or 1 where a
float32 probability hides its errors.  Names and
layouts are PALACE's modules', weights stored (in, out), as the
package under test and the reference both take them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

ALIGN = 64  # elements: 256 bytes of float32
#: weights uniform within GAIN / sqrt(fan_in): He's bound for layers
#: followed by a ReLU, so activations keep their size through the layers
#: and the scores differ from contig to contig as a trained model's do
GAIN = math.sqrt(6.0)
#: the head is set so that the logit of P(phage) over a few of the
#: sample's contigs has median 0 and this standard deviation
HEAD_SPREAD = 1.5
HEAD_CONTIGS = 64


def layout(cfg: Mapping[str, int]) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, half-width, centre) of every parameter."""
    d3, gd, f = cfg["hidden_dim"], cfg["gcn_dim"], cfg["fnode_num"]
    pn, cnn, kw = f * f, cfg["cnn_dim"], cfg["conv_kernel"]
    out: List[Tuple[str, Tuple[int, ...], float, float]] = []

    def linear(name, n_in, n_out, bias=True):
        out.append((f"{name}.w", (n_in, n_out), GAIN / math.sqrt(n_in), 0.0))
        if bias:
            out.append((f"{name}.b", (n_out,), 1 / math.sqrt(n_in), 0.0))

    linear("pnode_d", pn * d3, pn * d3)
    linear("fnode_d", f, f * d3)
    for i, (src1, dst1, src2, dst2) in enumerate([(d3, d3, gd, d3), (gd, gd, gd, gd)]
                                                  [:cfg["num_layers"]]):
        linear(f"convs_1.{i}.lin_l", src1, gd)
        linear(f"convs_1.{i}.lin_r", dst1, gd, bias=False)
        linear(f"convs_2.{i}.lin_l", src2, gd)
        linear(f"convs_2.{i}.lin_r", dst2, gd, bias=False)
    out.append(("ln.scale", (gd,), 0.1, 1.0))
    out.append(("ln.bias", (gd,), 0.1, 0.0))
    conv_in = [gd, cnn, cnn]
    for i, cin in enumerate(conv_in, 1):
        bound = 1 / math.sqrt(cin * kw)
        out.append((f"conv{i}.w", (cnn, cin, kw), GAIN * bound, 0.0))
        out.append((f"conv{i}.b", (cnn,), bound, 0.0))
    linear("d1", (pn - 3 * (kw - 1)) * cnn, cfg["fc_dim"])
    linear("d2", cfg["fc_dim"], 2)
    return out


def gcn_params(cfg: Mapping[str, int], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``cfg``'s scorer, on ``device``, from ``seed``."""
    spec = layout(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // ALIGN) * ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    params = {}
    for (name, shape, half, centre), lo, n in zip(spec, offsets, sizes):
        params[name] = flat[lo:lo + n].view(shape).mul_(half).add_(centre)
    return params


def centre_head(params: Dict[str, torch.Tensor], seqs: List[str], cfg: Mapping[str, int],
                device: torch.device) -> None:
    """Set ``d2`` in place so that over ``seqs`` the logit of P(phage), the
    difference of the two logits, has median 0 and standard deviation
    ``HEAD_SPREAD``: from the plain reference's float32 activations of
    ``d1`` (deterministic cuDNN), the scale to 3 digits and the shift to 3
    decimals, so that the same seed gives the same weights."""
    from portbench.reference import gcn as gcn_ref

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        with torch.inference_mode(), gcn_ref.full_float32():
            h = gcn_ref.hidden(params, gcn_ref.features(seqs, device), cfg).double()
    finally:
        cudnn.deterministic = saved
    w, b = params["d2.w"], params["d2.b"]
    v = (w[:, 1] - w[:, 0]).double()
    d = h @ v
    scale = float(f"{HEAD_SPREAD / float(d.std()):.3g}")
    shift = round(float((d * scale).median()), 3)
    v = (v * scale).to(w.dtype)
    w[:, 1], w[:, 0] = v / 2, -v / 2
    b[1], b[0] = -shift / 2, shift / 2
