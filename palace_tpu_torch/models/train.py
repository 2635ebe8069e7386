"""Training for the GCN phage scorer, the counterpart of
``palace_tpu/models/train.py``.

JAX trains through XLA, not through its Pallas kernels (``forward`` takes
them only without a dropout key), so the port trains with autograd over
plain tensor ops (``models.gcn.train_forward``), in full float32 on any
device (``models.gcn.full_float32``): Adam as optax computes it, softmax
cross-entropy on the two logits, dropout drawn from a seeded
``torch.Generator``.  The hand kernels stay on the eval path, where the
trained parameters go (``GCNScorer(state.model.params())``).

``train_step`` updates the state in place and returns it, where JAX
returns a new one.

Under a ``mesh`` (``parallel.mesh.make_mesh``: one process a rank) the
state holds this rank's shards of the parameters and of Adam's moments
(``pnode_d`` by output columns, ``d1`` by input rows over the model axis,
``parallel.mesh.shard_params_for_gcn``), each data rank takes its
contiguous block of every batch, and the gradients are averaged over the
data group before the same Adam runs on each rank's shards: JAX's dp×tp
``train_step``, with the collectives ``parallel.collectives`` writes out.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from palace_tpu_torch.device import resolve_device
from palace_tpu_torch.models.gcn import (DEFAULT_CONFIG, GCNConfig, Params, TrainableGCN,
                                         full_float32, init_params, model_inputs_from_features,
                                         params_from_jax, train_forward)
from palace_tpu_torch.parallel.collectives import all_mean
from palace_tpu_torch.parallel.mesh import Mesh, Spec, data_sharding, shard_params_for_gcn

BETAS = (0.9, 0.999)  # optax.adam's b1, b2
EPS = 1e-8            # optax.adam's eps, with eps_root 0


class Adam(torch.optim.Optimizer):
    """optax.adam, operation for operation in the parameters' float32.

    ``m = (1 - b) * g + b * m`` for both moments (``g * g`` for the
    second), the bias corrections ``1 - b**count`` in float32 with ``b``
    rounded to float32, ``u = (m1 / c1) / (sqrt(m2 / c2) + eps)`` and
    ``p = p + (-lr) * u``.  ``torch.optim.Adam`` takes the bias corrections
    in double with the exact ``b``: its updates lie 6e-6 relative from
    optax's.  The state keeps ``torch.optim.Adam``'s names: ``exp_avg``,
    ``exp_avg_sq`` and ``step`` (a float32 tensor on the CPU).
    """

    def __init__(self, params, lr: float = 1e-4, betas: Tuple[float, float] = BETAS,
                 eps: float = EPS):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            (b1, b2), eps, lr = group["betas"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                mu, nu = state["exp_avg"], state["exp_avg_sq"]
                mu.mul_(b1).add_(g * (1 - b1))
                nu.mul_(b2).add_(g * g * (1 - b2))
                # 0-d float32 tensors on the CPU: a card takes them as kernel
                # arguments, with no copy to wait for (its division by one
                # multiplies by the reciprocal, a rounding more than optax)
                c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), state["step"])
                c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), state["step"])
                denom = (nu / c2).sqrt_().add_(eps)
                p.add_((mu / c1).div_(denom).mul_(-lr))


@dataclass
class TrainState:
    """The model (its parameters), Adam and the count of steps taken; under
    a ``mesh``, this rank's shards and the spec of each parameter."""

    model: TrainableGCN
    optimizer: Adam
    step: int = 0
    mesh: Optional[Mesh] = None
    specs: Optional[Dict[str, Spec]] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(model: TrainableGCN, learning_rate: float = 1e-4) -> Adam:
    """optax.adam(learning_rate) with its defaults: betas (0.9, 0.999), eps
    1e-8 outside the square root, eps_root 0."""
    return Adam(model.parameters(), lr=learning_rate)


def init_train_state(params: Mapping[str, torch.Tensor], cfg: GCNConfig = DEFAULT_CONFIG,
                     learning_rate: float = 1e-4, device: str | torch.device = "cuda",
                     mesh: Optional[Mesh] = None) -> TrainState:
    """A state at step 0 holding a float32 copy of ``params`` on ``device``
    (the card unless ``device="cpu"``); under a ``mesh``, this rank's
    shards of the (whole) ``params`` on ``mesh.device``."""
    specs = None
    if mesh is not None:
        params, specs = shard_params_for_gcn(params, mesh)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    model = TrainableGCN({n: torch.as_tensor(t).to(dev, torch.float32)
                          for n, t in params.items()}, cfg)
    return TrainState(model, make_optimizer(model, learning_rate), 0, mesh, specs)


def loss_fn(params: Params, x_p: torch.Tensor, x_f: torch.Tensor, labels: torch.Tensor,
            cfg: GCNConfig = DEFAULT_CONFIG, generator: Optional[torch.Generator] = None,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean softmax cross-entropy of the logits against integer labels
    (under a ``mesh``, over this rank's data block)."""
    logits = train_forward(params, x_p, x_f, cfg, generator, return_logits=True, mesh=mesh)
    return F.cross_entropy(logits, labels.long())


def value_and_grad(model: TrainableGCN, x_p: torch.Tensor, x_f: torch.Tensor,
                   labels: torch.Tensor, cfg: GCNConfig = DEFAULT_CONFIG,
                   generator: Optional[torch.Generator] = None,
                   mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, Params]:
    """``jax.value_and_grad(loss_fn)``: the loss and its gradient for every
    parameter by JAX name, forward and backward in full float32.  The
    gradients are the parameters' ``.grad``, replaced at each call; a
    parameter the loss does not reach (the last round's f-node side) gets
    zeros, as in JAX, so Adam steps every parameter as optax does.

    Under a ``mesh`` the batch is this rank's data block and the model its
    shards: the loss and the gradients are averaged over the data group
    (the global batch's mean, its blocks being of one size), so each rank
    holds the gradient of its shards for the whole batch."""
    params = model.params()
    with full_float32():
        model.zero_grad(set_to_none=True)
        loss = loss_fn(params, x_p, x_f, labels, cfg, generator, mesh)
        loss.backward()
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    loss = loss.detach()
    if mesh is not None:
        loss = loss.reshape(1)
        all_mean([loss] + [p.grad for p in params.values()], mesh.data_group, mesh.dp)
        loss = loss[0]
    return loss, {n: p.grad for n, p in params.items()}


def train_step(state: TrainState, x_p: torch.Tensor, x_f: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator], cfg: GCNConfig = DEFAULT_CONFIG,
               learning_rate: float = 1e-4) -> Tuple[TrainState, torch.Tensor]:
    """One Adam step on one batch, on the state's device; the state is
    updated in place.  Returns it and the batch's loss, a tensor on the
    device (nothing is read back).  Under the state's mesh the batch is
    this rank's data block (``parallel.mesh.data_sharding``) and the loss
    is the whole batch's."""
    loss, _ = value_and_grad(state.model, x_p, x_f, labels, cfg, generator, state.mesh)
    for group in state.optimizer.param_groups:
        group["lr"] = learning_rate
    state.optimizer.step()
    state.step += 1
    return state, loss


def adam_moments(state: TrainState) -> Tuple[Params, Params, float]:
    """Adam's first and second moments by parameter name, and its step
    count: zeros and 0 before the first step, as optax's ``init``."""
    mu: Params = {}
    nu: Params = {}
    count = 0.0
    for name, p in state.model.params().items():
        s = state.optimizer.state.get(p)
        if s:
            mu[name], nu[name], count = s["exp_avg"], s["exp_avg_sq"], float(s["step"])
        else:
            mu[name], nu[name] = torch.zeros_like(p), torch.zeros_like(p)
    return mu, nu, count


def set_adam_moments(state: TrainState, mu: Mapping[str, torch.Tensor],
                     nu: Mapping[str, torch.Tensor], count: float) -> None:
    """Load Adam's moments (by parameter name) and step count into
    ``state.optimizer``, onto the parameters' device."""
    names = state.model.names
    groups = state.optimizer.state_dict()["param_groups"]
    state.optimizer.load_state_dict({
        "state": {i: {"step": torch.tensor(float(count), dtype=torch.float32),
                      "exp_avg": torch.as_tensor(mu[n]), "exp_avg_sq": torch.as_tensor(nu[n])}
                  for i, n in enumerate(names)},
        "param_groups": groups,
    })


def train_state_from_jax(params: Mapping[str, np.ndarray], mu: Mapping[str, np.ndarray],
                         nu: Mapping[str, np.ndarray], count: int, step: int,
                         cfg: GCNConfig = DEFAULT_CONFIG, learning_rate: float = 1e-4,
                         device: str | torch.device = "cuda") -> TrainState:
    """A JAX ``TrainState`` as numpy arrays → the port's: the parameters,
    optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) and the step."""
    state = init_train_state(params_from_jax(params), cfg, learning_rate, device)
    set_adam_moments(state, params_from_jax(mu), params_from_jax(nu), count)
    state.step = int(step)
    return state


def _epoch_batches(order: np.ndarray, batch_size: int) -> np.ndarray:
    """The epoch's batches of indices, the last one wrapped round to the
    start of ``order`` until it is full (JAX ``fit``'s one jit shape)."""
    batches = []
    for i in range(0, len(order), batch_size):
        idx = order[i: i + batch_size]
        while len(idx) < batch_size:
            idx = np.concatenate([idx, order[: batch_size - len(idx)]])
        batches.append(idx)
    return np.stack(batches)


def fit(
    features,
    labels,
    cfg: GCNConfig = DEFAULT_CONFIG,
    *,
    epochs: int = 1,
    batch_size: int = 64,
    learning_rate: float = 1e-4,
    seed: int = 0,
    ckpt_dir: str | Path | None = None,
    ckpt_every: int = 0,
    init_state: Optional[TrainState] = None,
    device: str | torch.device = "cuda",
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, List[float]]:
    """Mini training loop over encoded features, as JAX ``fit``.

    features: (N, 3·64·64) float32 (``ops.encoder`` / ``kernels``), numpy
    or a tensor; labels: (N,) int {0 = non-phage, 1 = phage}.  Both are
    moved to ``device`` once and indexed there.

    Each epoch takes ``np.random.default_rng(seed)``'s next permutation in
    batches of ``batch_size``, the last one wrapped round.  A
    ``torch.Generator`` on the device, seeded with ``seed``, draws the
    initial parameters (when ``init_state`` is None) and then every
    dropout mask.  With ``ckpt_dir`` a checkpoint is saved every
    ``ckpt_every`` steps and at the end; if the directory already holds
    one, training resumes from it, and, as in JAX, the generator and the
    permutations start again from ``seed``.  ``init_state`` (on
    ``device``) is trained in place.  The losses are read back once an
    epoch.  Returns the final state and the per-epoch mean losses.

    With a ``mesh`` every rank calls ``fit`` with the same arguments and
    runs on ``mesh.device``: it draws the whole initial parameters and
    keeps its shards (``init_state`` must be a state on that mesh), takes
    its data block of each batch (``batch_size`` a multiple of
    ``mesh.dp``), and draws the whole batch's dropout masks, so the
    parameters, the permutations and the masks are those of one device.
    Checkpoints hold the whole state, written by rank 0.
    """
    from palace_tpu_torch.models.checkpoint import restore_train_state, save_train_state

    n = int(features.shape[0])
    if n == 0:
        raise ValueError("no training examples")
    if mesh is not None and batch_size % mesh.dp:
        raise ValueError(f"batch_size {batch_size} does not split over {mesh.dp} data ranks")
    dev = mesh.device if mesh is not None else resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    if init_state is None:
        state = init_train_state(init_params(generator, cfg), cfg, learning_rate, dev, mesh)
    else:
        if init_state.device != dev or init_state.mesh is not mesh:
            raise ValueError(f"init_state lies on {init_state.device} (mesh "
                             f"{init_state.mesh}), fit runs on {dev} (mesh {mesh})")
        state = init_state
    if ckpt_dir is not None:
        state = restore_train_state(ckpt_dir, state) or state

    feats = torch.as_tensor(features, dtype=torch.float32).to(dev)
    labs = torch.as_tensor(labels).to(dev, torch.int64)
    rng = np.random.default_rng(seed)
    saved = None
    losses: List[float] = []
    for _ in range(epochs):
        batches = torch.from_numpy(_epoch_batches(rng.permutation(n), batch_size)).to(dev)
        epoch_losses = []
        for idx in batches:
            if mesh is not None:
                idx = data_sharding(idx, mesh)
            x_p, x_f = model_inputs_from_features(feats[idx], cfg)
            state, loss = train_step(state, x_p, x_f, labs[idx], generator, cfg, learning_rate)
            epoch_losses.append(loss)
            if ckpt_dir is not None and ckpt_every and state.step % ckpt_every == 0:
                saved = save_train_state(ckpt_dir, state)
        losses.append(float(np.mean(torch.stack(epoch_losses).cpu().numpy())))
    if ckpt_dir is not None and saved != state.step:
        save_train_state(ckpt_dir, state)
    return state, losses

