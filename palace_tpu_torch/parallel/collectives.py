"""The collectives of the GCN's (data, model) sharding, as autograd
functions.

JAX leaves them to XLA, which derives them from the shardings; here they
are written out, Megatron-style:

* around the column-split ``pnode_d``: ``copy_to_model`` (identity; its
  backward sums the input gradient over the model group) before the
  product, ``gather_columns`` (the output's column blocks gathered; its
  backward keeps this rank's block) after it;
* around the row-split ``d1``: ``scatter_to_model`` (this rank's column
  block of the input; its backward gathers the input gradient) before the
  product, ``reduce_from_model`` (the partial products summed; its
  backward is the identity) after it;
* ``all_mean`` over a group: the dp mean of the gradients and the loss.

Every one is built on ``dist.all_reduce`` alone: a gather is the sum of
zero-filled full buffers, each rank writing its own block, which is
exact.  gloo carries CUDA tensors for ``all_reduce``, ``broadcast`` and
``barrier`` only, and ``all_reduce`` is spelled the same in every torch
release.  Floating tensors narrower than float32 travel as float32 (gloo
need not sum bfloat16; a gather is exact either way, a sum of bf16
partials is rounded once, at the end).  With no group (one process)
every collective is the identity.

``TIMING``: when ``enabled``, each collective synchronizes the card
before and after itself and adds its seconds and count to ``seconds`` /
``calls``, so a caller can read what the collectives cost apart from the
work around them.  Off by default: the synchronizations cost overlap.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from palace_tpu_torch.parallel.mesh import Mesh, block


@dataclass
class _Timing:
    enabled: bool = False
    seconds: float = 0.0
    calls: int = 0

    def reset(self) -> None:
        self.seconds, self.calls = 0.0, 0


TIMING = _Timing()


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def all_reduce_(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (float32 on the wire for narrower
    floats) and return it; the identity without a group."""
    if group is None:
        return t
    wire = t.float() if t.is_floating_point() and t.element_size() < 4 else t
    if TIMING.enabled:
        _sync(t)
        t0 = time.perf_counter()
    dist.all_reduce(wire, group=group)
    if TIMING.enabled:
        _sync(t)
        TIMING.seconds += time.perf_counter() - t0
        TIMING.calls += 1
    if wire is not t:
        t.copy_(wire)
    return t


def gather_blocks(local: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The whole tensor, on every rank of ``axis``'s group, from each
    rank's contiguous block along ``dim`` (zero-filled, then summed)."""
    n = mesh.shape[axis]
    if n == 1:
        return local
    shape = list(local.shape)
    shape[dim] *= n
    full = local.new_zeros(shape)
    block(full, mesh, axis, dim).copy_(local)
    return all_reduce_(full, mesh.group(axis))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.mesh.model_group), None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        return gather_blocks(y, mesh, "model", y.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        return block(grad, ctx.mesh, "model", grad.dim() - 1).contiguous(), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return block(x, mesh, "model", x.dim() - 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return gather_blocks(grad, ctx.mesh, "model", grad.dim() - 1), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, mesh):
        return all_reduce_(partial.clone(), mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` (replicated over the model group) as it is; the backward sums
    its gradient over the group."""
    return _CopyToModel.apply(x, mesh)


def gather_columns(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The last dim's column blocks of the model group gathered into the
    whole; the backward keeps this rank's block of the gradient."""
    return _GatherColumns.apply(y, mesh)


def scatter_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the last dim of a replicated ``x``; the
    backward gathers the whole gradient."""
    return _ScatterToModel.apply(x, mesh)


def reduce_from_model(partial: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The partial products of the model group summed; the backward passes
    the (replicated) gradient through."""
    return _ReduceFromModel.apply(partial, mesh)


def all_mean(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup],
             size: int) -> List[torch.Tensor]:
    """Each tensor replaced in place by its mean over ``group`` (``size``
    ranks), in one all-reduce of one flat buffer: the dp gradient mean."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group).div_(size)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()
    return list(tensors)
