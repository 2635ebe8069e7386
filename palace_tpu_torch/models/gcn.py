"""GCN phage-contig scorer: the eval forward in PyTorch.

The reference model (phage_scoring.py:57-120 ``GNN_Model`` of the
original PALACE) runs PyG SAGEConv over a fixed bipartite graph: edges
``[i//64, i]`` and ``[i%64, i]`` (phage_scoring.py:130-134).  With the
graph fixed, message passing collapses into dense reshapes:

* f→p aggregation: p-node ``i`` has exactly one neighbour ``f[i//64]``,
  a 64× row repeat;
* p→f aggregation: f-node ``j`` takes the mean of the 64 p-nodes
  ``{i : i%64 == j}``.

SAGEConv (mean aggregation, root weight, bias on the neighbour branch)
is ``agg @ W_l + b_l + x_dst @ W_r``.  Parameters keep the layout and
names of ``palace_tpu.models.gcn`` (Linear weights stored (in, out)),
so JAX parameters carry over as they are (``params_from_jax``).

The final reshape scrambles (position, channel) exactly like
``torch.reshape(x_p, (-1, gcn_dim, PNODE_NUM))`` on the row-major
(B·4096, 128) activations (phage_scoring.py:112), to stay compatible
with reference checkpoints.

Two forwards share the layers: ``forward`` (eval, through the kernels,
held by ``GCNScorer``) and ``train_forward`` (plain tensor ops with
dropout, for autograd, held by ``TrainableGCN``).  The kernels have no
backward; JAX trains through XLA too, not through its Pallas kernels.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from palace_tpu_torch.ops import kernels
from palace_tpu_torch.parallel import collectives
from palace_tpu_torch.parallel.mesh import Mesh, data_sharding
from palace_tpu_torch.utils.timers import StageTimer

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class GCNConfig:
    """Architecture constants (phage_scoring.py:47-55)."""

    hidden_dim: int = 3          # HIDDEN_DIM / PNODE_DIM
    fnode_num: int = 64          # FNODE_NUM
    gcn_dim: int = 128           # GCN_HIDDEN_DIM
    cnn_dim: int = 64            # CNN_HIDDEN_DIM
    fc_dim: int = 100            # FC_HIDDEN_DIM
    num_layers: int = 2          # GCN_LAYER_NUM
    drop_rate: float = 0.2       # DROP_RATE
    conv_kernel: int = 8

    @property
    def pnode_num(self) -> int:
        return self.fnode_num * self.fnode_num  # 4096

    @property
    def conv_out_len(self) -> int:
        # three valid convs of width ``conv_kernel``: L - 3*(k-1) = 4075
        return self.pnode_num - 3 * (self.conv_kernel - 1)

    @property
    def flat_dim(self) -> int:
        return self.conv_out_len * self.cnn_dim  # 4075*64 = 260800


DEFAULT_CONFIG = GCNConfig()


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: GCNConfig = DEFAULT_CONFIG,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters, torch-Linear-style fan-in uniform
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, drawn on the generator's
    device in the order of ``palace_tpu.models.gcn.init_params``."""
    dev = generator.device

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=dev, dtype=torch.float32)
        return ((u * 2 - 1) * bound).to(dtype)

    def linear(n_in: int, n_out: int, bias: bool = True):
        bound = 1.0 / np.sqrt(n_in)
        w = uniform((n_in, n_out), bound)
        return w, (uniform((n_out,), bound) if bias else None)

    p: Params = {}
    d3, gd, f, pn = cfg.hidden_dim, cfg.gcn_dim, cfg.fnode_num, cfg.pnode_num
    p["pnode_d.w"], p["pnode_d.b"] = linear(pn * d3, pn * d3)
    p["fnode_d.w"], p["fnode_d.b"] = linear(f, f * d3)
    dims_1 = [(d3, d3), (gd, gd)]       # convs_1: (in_src, in_dst)
    dims_2 = [(gd, d3), (gd, gd)]       # convs_2
    for i in range(cfg.num_layers):
        for tag, (in_src, in_dst) in (("convs_1", dims_1[i]), ("convs_2", dims_2[i])):
            w, b = linear(in_src, gd)
            p[f"{tag}.{i}.lin_l.w"], p[f"{tag}.{i}.lin_l.b"] = w, b
            p[f"{tag}.{i}.lin_r.w"], _ = linear(in_dst, gd, bias=False)
    p["ln.scale"] = torch.ones(gd, dtype=dtype, device=dev)
    p["ln.bias"] = torch.zeros(gd, dtype=dtype, device=dev)
    conv_dims = [(gd, cfg.cnn_dim), (cfg.cnn_dim, cfg.cnn_dim), (cfg.cnn_dim, cfg.cnn_dim)]
    for i, (cin, cout) in enumerate(conv_dims, 1):
        bound = 1.0 / np.sqrt(cin * cfg.conv_kernel)
        p[f"conv{i}.w"] = uniform((cout, cin, cfg.conv_kernel), bound)
        p[f"conv{i}.b"] = uniform((cout,), bound)
    p["d1.w"], p["d1.b"] = linear(cfg.flat_dim, cfg.fc_dim)
    p["d2.w"], p["d2.b"] = linear(cfg.fc_dim, 2)
    return p


def params_from_jax(params: Mapping[str, np.ndarray]) -> Params:
    """JAX parameters (``palace_tpu`` layout and names, as numpy arrays)
    → the port's parameters, on the CPU, in the same dtype."""
    out: Params = {}
    for name, a in params.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy
            out[name] = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(a.copy())
    return out


_TORCH_LINEAR_KEYS = ("pnode_d", "fnode_d", "d1", "d2")


def params_from_numpy_state(state: Mapping[str, np.ndarray], cfg: GCNConfig = DEFAULT_CONFIG,
                            dtype: torch.dtype = torch.float32) -> Params:
    """Map a reference torch ``state_dict`` (as numpy arrays) onto the
    port's layout: Linear ``weight`` (out, in) is transposed to (in, out);
    SAGEConv parameters are ``lin_l.{weight,bias}`` / ``lin_r.weight``
    (phage_scoring.py:69-76: ``convs_1``/``convs_2``, ``lns.0``,
    ``conv1..3``, ``d1``, ``d2``)."""
    def get(name: str, transpose: bool = False) -> torch.Tensor:
        a = np.asarray(state[name])
        return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a)).to(dtype)

    p: Params = {}
    for name in _TORCH_LINEAR_KEYS:
        p[f"{name}.w"] = get(f"{name}.weight", transpose=True)
        p[f"{name}.b"] = get(f"{name}.bias")
    for i in range(cfg.num_layers):
        for tag in ("convs_1", "convs_2"):
            p[f"{tag}.{i}.lin_l.w"] = get(f"{tag}.{i}.lin_l.weight", transpose=True)
            p[f"{tag}.{i}.lin_l.b"] = get(f"{tag}.{i}.lin_l.bias")
            p[f"{tag}.{i}.lin_r.w"] = get(f"{tag}.{i}.lin_r.weight", transpose=True)
    p["ln.scale"] = get("lns.0.weight")
    p["ln.bias"] = get("lns.0.bias")
    for i in (1, 2, 3):
        p[f"conv{i}.w"] = get(f"conv{i}.weight")  # (O, I, K)
        p[f"conv{i}.b"] = get(f"conv{i}.bias")
    return p


def load_torch_state_dict(path: str, cfg: GCNConfig = DEFAULT_CONFIG,
                          dtype: torch.dtype = torch.float32) -> Params:
    """Load a reference ``GCN_model_retrained.pt`` checkpoint: a bare
    state_dict or a pickled module with ``state_dict()``
    (phage_scoring.py:172-179).  Only load checkpoints you trust: a
    pickled module runs code when it is read."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(checkpoint, "state_dict"):
        checkpoint = checkpoint.state_dict()
    state = {k: v.detach().cpu().numpy() for k, v in checkpoint.items()}
    return params_from_numpy_state(state, cfg, dtype)


# ---------------------------------------------------------------------------
# forward pass (eval)
# ---------------------------------------------------------------------------

def model_inputs_from_features(features: torch.Tensor, cfg: GCNConfig = DEFAULT_CONFIG
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3·4096) encoder features → (x_p (B,4096,3), x_f (B,64,1)).

    Mirrors phage_scoring.py:191-194: pnode = the (B,3,4096) reshape with
    its axes moved (not a flat reshape); fnode = row sums of the gap-0
    64×64 matrix."""
    B = features.shape[0]
    f, pn, d3 = cfg.fnode_num, cfg.pnode_num, cfg.hidden_dim
    x_p = features.reshape(B, d3, pn).movedim(1, 2)
    x_f = features.reshape(B, d3, f, f)[:, 0].sum(dim=2).reshape(B, f, 1)
    return x_p, x_f


def sage_weight_stack(params: Params, dtype: torch.dtype) -> torch.Tensor:
    """The SAGE weights stacked in the row order ``kernels.sage_rounds`` takes."""
    rows = [params["convs_1.0.lin_r.w"], params["convs_1.0.lin_l.w"],
            params["convs_2.0.lin_r.w"], params["convs_2.0.lin_l.w"],
            params["convs_1.1.lin_l.w"], params["convs_1.1.lin_r.w"],
            params["convs_1.0.lin_l.b"][None], params["convs_2.0.lin_l.b"][None],
            params["convs_1.1.lin_l.b"][None], params["ln.scale"][None],
            params["ln.bias"][None]]
    return torch.cat([r.to(dtype) for r in rows])


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """JAX ``_dropout``: keep each element with probability ``1 - rate`` and
    scale what is kept by ``1 / (1 - rate)``; the identity when
    ``generator`` is None or ``rate <= 0``.  The mask is drawn from
    ``generator``, which must lie on ``x``'s device (``F.dropout`` would
    draw from the global generator).  Under a ``mesh`` ``x`` is this rank's
    data block of the batch: the mask is drawn for the whole global batch
    and this rank keeps its block, so every rank's generator stays in step
    and the masks are those of one device."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape if mesh is None else (x.shape[0] * mesh.dp, *x.shape[1:])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if mesh is not None:
        mask = data_sharding(mask, mesh)
    return torch.where(mask, x / keep, 0.0)


def _sage_layers(params: Params, x_p: torch.Tensor, x_f: torch.Tensor,
                 cfg: GCNConfig, generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The SAGE rounds as plain tensor code, at any depth: the eval path for
    depths other than 2, and the training path, which drops ``x_p`` and
    then ``x_f`` after each round's relu (JAX's keys 2i and 2i+1), before
    the LayerNorm between the rounds."""
    B, f, pn = x_p.shape[0], cfg.fnode_num, cfg.pnode_num
    for i in range(cfg.num_layers):
        # repeat(x_f) @ W == repeat(x_f @ W): lift the 64 f-nodes, then add each
        # to its 64 p-nodes by broadcasting (the same sums as a repeat; its
        # backward is a sum, where repeat_interleave's accumulates atomically)
        lifted = x_f @ params[f"convs_1.{i}.lin_l.w"] + params[f"convs_1.{i}.lin_l.b"]
        root = x_p @ params[f"convs_1.{i}.lin_r.w"]
        x_p = torch.relu(lifted[:, :, None, :] + root.reshape(B, f, pn // f, -1)
                         ).reshape(B, pn, -1)
        x_p = dropout(x_p, cfg.drop_rate, generator, mesh)
        agg_f = x_p.reshape(B, f, f, -1).mean(dim=1)  # mean over {i : i%64 == j}
        x_f = torch.relu(agg_f @ params[f"convs_2.{i}.lin_l.w"]
                         + params[f"convs_2.{i}.lin_l.b"]
                         + x_f @ params[f"convs_2.{i}.lin_r.w"])
        x_f = dropout(x_f, cfg.drop_rate, generator, mesh)
        if i < cfg.num_layers - 1:
            x_p = _layer_norm(x_p, params["ln.scale"], params["ln.bias"])
            x_f = _layer_norm(x_f, params["ln.scale"], params["ln.bias"])
    return x_p


def lift_inputs(params: Params, x_p: torch.Tensor, x_f: torch.Tensor,
                cfg: GCNConfig = DEFAULT_CONFIG, mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense node lifts (phage_scoring.py:93-99): (B,4096,3), (B,64,1)
    → the SAGE rounds' inputs (B,4096,3), (B,64,3).

    Under a ``mesh`` whose model axis split ``pnode_d`` by output columns
    (``parallel.mesh.shard_params_for_gcn``), each rank takes its columns
    and the model group gathers them: the result is replicated."""
    B = x_p.shape[0]
    f, pn, d3 = cfg.fnode_num, cfg.pnode_num, cfg.hidden_dim
    x = x_p.reshape(B, pn * d3)
    w, b = params["pnode_d.w"], params["pnode_d.b"]
    if w.shape[1] == pn * d3:
        x_p = x @ w + b
    else:  # column-split over the mesh's model axis
        x_p = collectives.gather_columns(collectives.copy_to_model(x, mesh) @ w + b, mesh)
    x_p = x_p.reshape(B, pn, d3)
    x_f = (x_f.reshape(B, f) @ params["fnode_d.w"] + params["fnode_d.b"]).reshape(B, f, d3)
    return x_p, x_f


def _dense_1(params: Params, x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x @ d1.w + d1.b`` on the flat conv output; where the mesh's model
    axis split ``d1.w`` by input rows, each rank multiplies its block of
    ``x``'s columns and the model group sums the partial products."""
    w = params["d1.w"]
    if w.shape[0] == x.shape[1]:
        return x @ w + params["d1.b"]
    partial = collectives.scatter_to_model(x, mesh) @ w
    return collectives.reduce_from_model(partial, mesh) + params["d1.b"]


def forward(params: Params, x_p: torch.Tensor, x_f: torch.Tensor,
            cfg: GCNConfig = DEFAULT_CONFIG, return_logits: bool = False,
            plain: bool = False, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Eval forward: (B,4096,3), (B,64,1) → (B,2) softmax probabilities
    (or logits).

    At depth 2 the SAGE rounds run in one kernel (``kernels.sage_rounds``)
    and the conv head in another (``kernels.conv_head``); other depths take
    plain tensor code for the rounds.  ``plain=True`` runs the kernels'
    plain versions instead, on any device: the reference a card's run is
    held to.

    Under a ``mesh`` the inputs are this rank's data block and ``params``
    its shards (``parallel.mesh.shard_params_for_gcn``): ``pnode_d`` runs
    column-split and ``d1`` row-split, with the model group's collectives
    around them, and the kernels run unchanged on the replicated
    activations between.  Its four parts are the spans ``gcn.lift``,
    ``gcn.sage``, ``gcn.conv`` and ``gcn.fc``, as in ``train_forward``."""
    B = x_p.shape[0]
    pn, gd = cfg.pnode_num, cfg.gcn_dim
    with StageTimer("gcn.lift"):
        x_p, x_f = lift_inputs(params, x_p, x_f, cfg, mesh)

    # alternating bipartite SAGE rounds (phage_scoring.py:101-110)
    with StageTimer("gcn.sage"):
        if cfg.num_layers == 2:
            sage = kernels.sage_rounds_plain if plain else kernels.sage_rounds
            x_p = sage(x_p, x_f, sage_weight_stack(params, x_p.dtype))
        else:
            x_p = _sage_layers(params, x_p, x_f, cfg)

    # channel-scramble reshape (phage_scoring.py:112): a raw reshape of the
    # row-major (B·4096, 128) activations, not a permute
    with StageTimer("gcn.conv"):
        x = x_p.reshape(B, gd, pn)
        conv = kernels.conv_head_plain if plain else kernels.conv_head
        x = conv(x, [params[f"conv{i}.w"] for i in (1, 2, 3)],
                 [params[f"conv{i}.b"] for i in (1, 2, 3)])
    with StageTimer("gcn.fc"):
        x = torch.relu(_dense_1(params, x.reshape(B, cfg.flat_dim), mesh))
        logits = x @ params["d2.w"] + params["d2.b"]
        return logits if return_logits else torch.softmax(logits, dim=1)


def phage_probabilities(params: Params, features: torch.Tensor,
                        cfg: GCNConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """(B, 12288) encoder features → (B,) P(phage), column 1 of the eval
    softmax (phage_scoring.py:212); on a card one launch of K2 and three
    of K3 at depth 2."""
    return forward(params, *model_inputs_from_features(features, cfg), cfg)[:, 1]


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Full float32 products inside the block, whatever the global flags:
    TF32 off in cuBLAS and in cuDNN (``torch.backends.cuda.matmul`` and
    ``torch.backends.cudnn`` ``allow_tf32``), both restored on exit.
    Training holds to JAX's float32 this way, forward and backward: TF32
    would break the 1e-4 tolerance.  The flags are process-wide while the
    block runs."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def train_forward(params: Params, x_p: torch.Tensor, x_f: torch.Tensor,
                  cfg: GCNConfig = DEFAULT_CONFIG,
                  generator: Optional[torch.Generator] = None,
                  return_logits: bool = True, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The training forward: JAX ``forward(..., dropout_key=key)``, which
    runs through XLA and none of its kernels, in plain tensor ops at any
    depth, so autograd can take its gradient.  (B,4096,3), (B,64,1) →
    (B,2) logits (or softmax probabilities).

    Dropout at rate ``cfg.drop_rate`` is drawn from ``generator`` at JAX's
    six sites, in the order of JAX's keys: ``x_p`` and ``x_f`` after each
    SAGE round's relu (keys 0-3), then after conv2's and conv3's relu (keys
    4, 5; conv1 has none).  With no generator it is the eval forward in the
    same ops.  The convs run through ``F.conv1d``, the counterpart of JAX's
    ``conv_general_dilated`` on this path; on a card, call it inside
    ``full_float32()``, backward included.  Its four parts run in the
    spans ``gcn.lift``, ``gcn.sage``, ``gcn.conv`` and ``gcn.fc``;
    each backward node carries its forward op's ``sequence_nr``.  Under a
    ``mesh``, as ``forward``: the inputs are this rank's data block, the
    parameters its shards, and each dropout mask this rank's block of the
    global batch's (``dropout``)."""
    B = x_p.shape[0]
    with StageTimer("gcn.lift"):
        x_p, x_f = lift_inputs(params, x_p, x_f, cfg, mesh)
    with StageTimer("gcn.sage"):
        x_p = _sage_layers(params, x_p, x_f, cfg, generator, mesh)
    with StageTimer("gcn.conv"):
        x = x_p.reshape(B, cfg.gcn_dim, cfg.pnode_num)  # the channel scramble, as ``forward``
        for i in (1, 2, 3):
            x = torch.relu(F.conv1d(x, params[f"conv{i}.w"], params[f"conv{i}.b"]))
            if i > 1:
                x = dropout(x, cfg.drop_rate, generator, mesh)
    with StageTimer("gcn.fc"):
        x = torch.relu(_dense_1(params, x.reshape(B, cfg.flat_dim), mesh))
        logits = x @ params["d2.w"] + params["d2.b"]
    return logits if return_logits else torch.softmax(logits, dim=1)


def _buffer_name(name: str) -> str:
    return name.replace(".", "__")


class GCNScorer(nn.Module):
    """The scorer as a module: the parameters are buffers (the model is
    eval-only), so ``.to(device)`` / ``.to(dtype)`` move and cast them.
    Trained parameters (``TrainableGCN.params()``) go in as they are."""

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: GCNConfig = DEFAULT_CONFIG):
        super().__init__()
        self.cfg = cfg
        self._names = list(params)
        for name, t in params.items():
            self.register_buffer(_buffer_name(name), torch.as_tensor(t).detach())

    def params(self) -> Params:
        return {n: getattr(self, _buffer_name(n)) for n in self._names}

    def forward(self, x_p: torch.Tensor, x_f: torch.Tensor, return_logits: bool = False,
                plain: bool = False, mesh: Optional[Mesh] = None) -> torch.Tensor:
        return forward(self.params(), x_p, x_f, self.cfg, return_logits, plain, mesh)

    def score_features(self, features: torch.Tensor, plain: bool = False,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
        """(B, 12288) features → P(phage), column 1 of the softmax
        (phage_scoring.py:212).  Features are cast to the parameters' dtype.
        Under a ``mesh`` the buffers are this rank's shards and ``features``
        its data block."""
        dtype = getattr(self, _buffer_name("pnode_d.w")).dtype
        x_p, x_f = model_inputs_from_features(features.to(dtype), self.cfg)
        return self.forward(x_p, x_f, plain=plain, mesh=mesh)[:, 1]


class TrainableGCN(nn.Module):
    """The model to train: each parameter an ``nn.Parameter`` (a copy of the
    one given), registered under its JAX name with the dots mangled as
    ``GCNScorer`` mangles them.  ``params()`` gives them back under the JAX
    names, in the layout of ``palace_tpu.models.gcn``."""

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: GCNConfig = DEFAULT_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.names = list(params)
        for name, t in params.items():
            self.register_parameter(_buffer_name(name),
                                    nn.Parameter(torch.as_tensor(t).detach().clone()))

    def params(self) -> Params:
        return {n: getattr(self, _buffer_name(n)) for n in self.names}

    def forward(self, x_p: torch.Tensor, x_f: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                return_logits: bool = False, mesh: Optional[Mesh] = None) -> torch.Tensor:
        """``train_forward`` in full float32: with ``generator`` dropout is
        on; without it this is the eval forward in the same plain ops."""
        with full_float32():
            return train_forward(self.params(), x_p, x_f, self.cfg, generator, return_logits,
                                 mesh)
