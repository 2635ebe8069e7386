"""The (data, model) mesh of ``torch.distributed`` ranks, the counterpart
of ``palace_tpu/parallel/mesh.py``.

JAX holds a whole mesh of devices in one process and lets XLA insert the
collectives that the shardings imply.  PyTorch's idiom is one process a
device: each rank is one cell of a row-major (data, model) grid and holds
its own shard of every tensor.

* ``data``  — batch parallelism: each data index takes a contiguous block
  of the leading dim (JAX's ``P("data")``);
* ``model`` — tensor parallelism for the GCN's two large dense layers:
  ``pnode_d`` (12288×12288) split by output columns, ``d1`` (260800×100)
  by input rows (``_GCN_PARAM_SPECS``); everything else is replicated.

The collectives those splits need are ``parallel.collectives``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from palace_tpu_torch.device import resolve_device

#: a partition spec: for each dim of a tensor the mesh axis it is split
#: over, or None; ``()`` is replicated (JAX's ``PartitionSpec``)
Spec = Tuple[Optional[str], ...]


def best_mesh_shape(n_devices: int, model_parallel: int = 1) -> Tuple[int, int]:
    """(data, model) factorisation of ``n_devices``; shrink the model axis
    until it divides."""
    mp = max(1, min(model_parallel, n_devices))
    while n_devices % mp != 0:
        mp -= 1
    return n_devices // mp, mp


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, model) grid of ranks.

    ``grid[i, j]`` is the global rank at data index ``i`` and model index
    ``j``; ``data_group`` holds this rank's column of the grid (the ranks
    that split the batch), ``model_group`` its row (the ranks that split
    the parameters).  The groups are None when ``torch.distributed`` is
    not initialized (one process, one device), where every collective is
    the identity."""

    grid: np.ndarray
    rank: int
    device: torch.device
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def dp(self) -> int:
        return self.grid.shape[0]

    @property
    def mp(self) -> int:
        return self.grid.shape[1]

    @property
    def coords(self) -> Tuple[int, int]:
        """(data index, model index) of this rank."""
        i, j = np.argwhere(self.grid == self.rank)[0]
        return int(i), int(j)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "model": self.mp}

    def axis_index(self, axis: str) -> int:
        return self.coords[0 if axis == "data" else 1]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.data_group if axis == "data" else self.model_group


def _rank_device(device: str | torch.device) -> torch.device:
    """The rank's own device: ``cuda:<local rank % cards>`` for a card
    (``LOCAL_RANK`` as torchrun sets it, else the global rank), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return resolve_device(dev)
    resolve_device(dev)  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(model_parallel: int = 1, device: str | torch.device = "cuda") -> Mesh:
    """The mesh over every rank of the default process group (one rank
    without ``torch.distributed``), shaped by ``best_mesh_shape``.  Every
    rank must call it, in the same order as its other group creations:
    each row's and each column's group is made with ``dist.new_group`` on
    all ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp, mp = best_mesh_shape(world, model_parallel)
    grid = np.arange(world).reshape(dp, mp)
    data_group = model_group = None
    if dist.is_initialized():
        for row in grid:
            g = dist.new_group(row.tolist())
            if rank in row:
                model_group = g
        for col in grid.T:
            g = dist.new_group(col.tolist())
            if rank in col:
                data_group = g
    return Mesh(grid, rank, _rank_device(device), data_group, model_group)


def block(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` when ``dim`` is
    split over ``axis`` (a view)."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways over {axis}")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * size, size)


def data_sharding(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the leading dim over the data axis, the rest
    whole (JAX ``data_sharding``: ``P("data", None, ...)``)."""
    return block(x, mesh, "data")


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole of ``x`` on this rank's device (JAX ``replicate``: ``P()``)."""
    return x.to(mesh.device)


def local_shard(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a global ``x`` under ``spec`` (a view)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = block(x, mesh, axis, dim)
    return x


#: GCN parameter partition specs for tensor parallelism over "model":
#: the two giant matmuls split their output columns / input rows;
#: everything else is replicated
_GCN_PARAM_SPECS: Dict[str, Spec] = {
    "pnode_d.w": (None, "model"),
    "pnode_d.b": ("model",),
    "d1.w": ("model", None),
    "fnode_d.w": (),
}


def gcn_param_specs(params: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, Spec]:
    """The spec each parameter takes on ``mesh``: ``_GCN_PARAM_SPECS``, or
    replicated where a dim does not divide its axis (e.g. d1's 4075·64
    rows under a 3-way model axis)."""
    specs = {}
    for name, value in params.items():
        spec = _GCN_PARAM_SPECS.get(name, ())
        if not all(axis is None or value.shape[dim] % mesh.shape[axis] == 0
                   for dim, axis in enumerate(spec)):
            spec = ()
        specs[name] = spec
    return specs


def shard_params_for_gcn(params: Mapping[str, torch.Tensor], mesh: Mesh
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Spec]]:
    """Each parameter's shard for this rank, on its device, and the spec
    that was applied (``gcn_param_specs``)."""
    specs = gcn_param_specs(params, mesh)
    local = {name: local_shard(torch.as_tensor(value), specs[name], mesh)
                 .to(mesh.device).clone(memory_format=torch.contiguous_format)
             for name, value in params.items()}
    return local, specs
