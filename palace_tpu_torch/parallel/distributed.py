"""Multi-process runtime: process-group start-up and per-process input
sharding, the counterpart of ``palace_tpu/parallel/distributed.py``.

JAX brings up ``jax.distributed`` on a pod slice and reads each host's
process index; here every rank is one process under ``torch.distributed``
(``torchrun --nproc-per-node N``, or ranks the caller starts with an
explicit address, world size and rank).  Single-process runs use the same
code paths: ``initialize()`` is a no-op without arguments or a torchrun
environment, and the mesh is then one rank.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from palace_tpu_torch.parallel.collectives import gather_blocks
from palace_tpu_torch.parallel.mesh import Mesh, Spec
from palace_tpu_torch.utils.logging import get_logger

logger = get_logger("palace")


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device: str | torch.device = "cuda") -> bool:
    """Bring up the default process group; True when it is up.

    ``init_method`` (``tcp://host:port``, ``file:///path``), ``world_size``
    and ``rank`` are the caller's; without them a torchrun environment
    (``WORLD_SIZE`` > 1) supplies them through ``env://``, and without
    either this is a no-op, as JAX's ``initialize`` is without a
    coordinator.  The backend is NCCL for a CUDA ``device`` and gloo for
    the CPU unless ``backend`` names one (gloo also carries CUDA tensors
    for ``all_reduce`` and ``broadcast``); it is never switched on its own.
    A CUDA rank first makes ``cuda:<LOCAL_RANK or rank % cards>`` current."""
    if dist.is_initialized():
        return True
    explicit = init_method is not None or world_size is not None or rank is not None
    if not explicit and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        logger.info("single-process run (no process group); skipping torch.distributed")
        return False
    if init_method is None:
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    logger.info("torch.distributed up: rank %d/%d, backend %s", rank, world_size, backend)
    return True


def _process(process_id: Optional[int], process_count: Optional[int]):
    up = dist.is_initialized()
    pid = (dist.get_rank() if up else 0) if process_id is None else process_id
    pcount = (dist.get_world_size() if up else 1) if process_count is None else process_count
    return pid, pcount


def shard_inputs_for_process(paths: Sequence[str], process_id: Optional[int] = None,
                             process_count: Optional[int] = None) -> List[str]:
    """Round-robin file assignment: rank i reads files i, i+P, i+2P …
    of the sorted paths."""
    pid, pcount = _process(process_id, process_count)
    return [p for j, p in enumerate(sorted(paths)) if j % pcount == pid]


def keep_record_for_process(record_idx: int, process_id: Optional[int] = None,
                            process_count: Optional[int] = None) -> bool:
    """Record striping within a shared file: rank i keeps records
    ``idx % P == i``."""
    pid, pcount = _process(process_id, process_count)
    return record_idx % pcount == pid


def global_array_from_local(local: torch.Tensor, mesh: Mesh, spec: Spec) -> torch.Tensor:
    """The global tensor, on every rank, from each rank's contiguous block
    along the axes of ``spec`` (``("data", None)``: rows split over the
    data axis; dims without an axis are whole on every rank).  The blocks
    are placed in zero-filled buffers and summed over each axis's group in
    turn, which is exact."""
    out = local.to(mesh.device)
    for dim, axis in enumerate(spec):
        if axis is not None:
            out = gather_blocks(out, mesh, axis, dim)
    return out
