"""The PALACE contig scorer in plain PyTorch: transition features and the GCN.

Features (encode.pyx:8-55): non-ACGT characters are dropped (positions
shift), 3-mers are read as base-4 codes, and for each gap d in (0, 1, 2)
``matrix[loc[i], loc[i+3+d]] += 1`` over ``i < len(loc) - 3 - d``; the
three 64 x 64 matrices are concatenated and scaled by ``100 / len(seq)``,
the length counting every character.

Model (phage_scoring.py:57-120, its bipartite graph densified): the
p-node and f-node lifts, two SAGE rounds with mean aggregation, where
p-node ``i`` takes f-node ``i // 64`` and f-node ``j`` the mean of the
p-nodes ``i % 64 == j``, a LayerNorm after the first round, the raw
(B, 128, 4096) reshape, three valid convs with ReLU, two dense layers
and a softmax.  Parameters are stored (in, out) under the PALACE module
names (``pnode_d.w``, ``convs_1.0.lin_l.w``, ...).

Everything runs in float32 with TF32 off.  ``quant`` rounds both
operands of every product to a lower precision first, for the check's
control: ``"tf32"`` (10 mantissa bits) or ``"fp8"`` (e4m3, one scale a
tensor).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

GAPS = (0, 1, 2)
CODES = 64
FEATURES = len(GAPS) * CODES * CODES  # 12288

_LUT = np.full(256, 255, dtype=np.uint8)
for _code, _ch in enumerate(b"ACGT"):
    _LUT[_ch] = _code
    _LUT[_ch + 32] = _code  # lower case


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """TF32 off for matmuls and convolutions inside the block."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits, ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 → float8 e4m3 with one scale for the tensor, back to float32."""
    amax = float(x.abs().max()) if x.numel() else 0.0
    scale = amax / 448.0 if amax > 0 else 1.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


QUANT: Dict[Optional[str], Callable[[torch.Tensor], torch.Tensor]] = {
    None: lambda x: x, "tf32": round_tf32, "fp8": round_fp8}


def features(seqs: Sequence[str], device: torch.device) -> torch.Tensor:
    """(B, 12288) float32 transition features of ``seqs``."""
    B = len(seqs)
    bufs = [s.encode() for s in seqs]
    data = torch.from_numpy(np.frombuffer(b"".join(bufs), dtype=np.uint8).copy()).to(device)
    nbytes = torch.tensor([len(b) for b in bufs], device=device)
    rows = torch.repeat_interleave(torch.arange(B, device=device), nbytes)
    codes = torch.from_numpy(_LUT).to(device)[data.long()].long()
    keep = codes != 255
    codes, rows = codes[keep], rows[keep]
    n_codes = torch.bincount(rows, minlength=B)
    first = torch.cumsum(n_codes, 0) - n_codes
    rel = torch.arange(codes.numel(), device=device) - first[rows]   # position in its row
    n_locs = torch.clamp(n_codes - 2, min=0)
    loc = codes[:-2] * 16 + codes[1:-1] * 4 + codes[2:]
    counts = torch.zeros(B * FEATURES, dtype=torch.float64, device=device)
    for d in GAPS:
        g = 3 + d
        t = torch.arange(max(loc.numel() - g, 0), device=device)
        ok = rel[t] < n_locs[rows[t]] - g   # both 3-mers of the pair lie in the row
        t, r = t[ok], rows[t][ok]
        idx = r * FEATURES + d * CODES * CODES + loc[t] * CODES + loc[t + g]
        counts += torch.bincount(idx, minlength=B * FEATURES).to(torch.float64)
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.float64, device=device)
    return (counts.reshape(B, FEATURES) / lens[:, None] * 100).to(torch.float32)


def hidden(params: Mapping[str, torch.Tensor], feats: torch.Tensor, cfg: Mapping[str, int],
           quant: Optional[str] = None) -> torch.Tensor:
    """(B, 3·f²) features → (B, fc) activations of the first dense layer."""
    q = QUANT[quant]
    p = {k: v.to(feats.device, torch.float32) for k, v in params.items()}
    B = feats.shape[0]
    f, d3, gd = cfg["fnode_num"], cfg["hidden_dim"], cfg["gcn_dim"]
    pn = f * f

    def lin(x, name, bias=True):
        y = q(x) @ q(p[f"{name}.w"])
        return y + p[f"{name}.b"] if bias else y

    def norm(x):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * p["ln.scale"] + p["ln.bias"]

    x_p = feats.reshape(B, d3, pn).transpose(1, 2)                  # (B, pn, d3)
    x_f = feats.reshape(B, d3, f, f)[:, 0].sum(dim=2)               # gap-0 row sums, (B, f)
    x_p = lin(x_p.reshape(B, pn * d3), "pnode_d").reshape(B, pn, d3)
    x_f = lin(x_f, "fnode_d").reshape(B, f, d3)
    for i in range(cfg["num_layers"]):
        agg_p = x_f.repeat_interleave(f, dim=1)                     # p-node i ← f-node i // f
        x_p = torch.relu(lin(agg_p, f"convs_1.{i}.lin_l") + lin(x_p, f"convs_1.{i}.lin_r", False))
        agg_f = x_p.reshape(B, f, f, -1).mean(dim=1)                # f-node j ← p-nodes i % f == j
        x_f = torch.relu(lin(agg_f, f"convs_2.{i}.lin_l") + lin(x_f, f"convs_2.{i}.lin_r", False))
        if i < cfg["num_layers"] - 1:
            x_p, x_f = norm(x_p), norm(x_f)
    x = x_p.reshape(B, gd, pn)                                      # the raw reshape, no permute
    for i in (1, 2, 3):
        x = torch.relu(F.conv1d(q(x), q(p[f"conv{i}.w"]), p[f"conv{i}.b"]))
    return torch.relu(lin(x.reshape(B, -1), "d1"))


def forward(params: Mapping[str, torch.Tensor], feats: torch.Tensor, cfg: Mapping[str, int],
            quant: Optional[str] = None) -> torch.Tensor:
    """(B, 3·f²) features → (B, 2) logits."""
    q = QUANT[quant]
    h = hidden(params, feats, cfg, quant)
    return q(h) @ q(params["d2.w"].to(h.device, torch.float32)) + params["d2.b"].to(h.device)


def probabilities(params: Mapping[str, torch.Tensor], seqs: Sequence[str],
                  cfg: Mapping[str, int], device: torch.device, quant: Optional[str] = None,
                  block: int = 256) -> np.ndarray:
    """P(phage) of every sequence, in blocks of ``block`` rows, float32."""
    out: List[np.ndarray] = []
    with torch.inference_mode(), full_float32():
        for lo in range(0, len(seqs), block):
            logits = forward(params, features(seqs[lo:lo + block], device), cfg, quant)
            out.append(torch.softmax(logits, dim=1)[:, 1].cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)
