"""Saturating k-mer count table, on one device or split over a mesh.

The reference allocates one 2^32-byte host array and lets threads race
on saturating increments (extract_ref.cpp:26, :995-998; counts saturate
at least_depth = 3).  Here the table is a flat uint8 tensor of 2^k bytes
on the device, indexed with int64 hashes, and a batch updates it
exactly: ``torch.unique`` gives each distinct hash of the batch and its
multiplicity, then one gather, a clamp and one scatter write
``min(old + multiplicity, cap)``.  Invalid k-mers go to slot 0, the
reference's permanent-miss slot (extract_ref.cpp:861-866), which counts
like any other slot but always reads 0 on lookup.  On a CUDA card a batch
of the reader's codes can instead be counted by one hand-written kernel
(``add_codes``, ``ops.kernels.count_codes``): the same counts, with no
host packing, no hash in device memory and no read-back.

This is the JAX package's ``CountTable`` without its TPU layouts (the
2-D ``(2^(k-16), 2^16)`` table and the nibble-packed words, both there
for XLA:TPU's int32 index limits): the counts are the same.

``ShardedCountTable`` splits the flat table by hash range over every rank
of a mesh (``parallel.mesh``), as the JAX package's does over every
device of its mesh; its counts are the same as the one-device table's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from palace_tpu_torch.device import resolve_device
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.kmer import kmer_hashes, unpack_codes_mask
from palace_tpu_torch.parallel.collectives import all_reduce_, gather_ragged
from palace_tpu_torch.parallel.mesh import Mesh


@dataclass
class CountTable:
    """Single-device saturating counter over 2^k hash slots.

    Updates are IN PLACE (the JAX table is updated by value): ``add_kmers``,
    ``add_packed`` and ``add_codes`` change ``table`` and return ``self``."""

    table: torch.Tensor  # (2^k,) uint8
    k: int
    cap: int = 3

    @classmethod
    def create(cls, k: int, cap: int = 3, device: str | torch.device = "cuda") -> "CountTable":
        """An empty table of 2^k slots on ``device`` (the CUDA card unless
        ``device="cpu"``; raises without a card)."""
        dev = resolve_device(device)
        return cls(table=torch.zeros(1 << k, dtype=torch.uint8, device=dev), k=k, cap=cap)

    @property
    def device(self) -> torch.device:
        return self.table.device

    def add_kmers(self, hashes: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> "CountTable":
        """Count a batch of hashes (any shape, values < 2^k).  ``valid`` is
        per hash or one axis short (per position of (…, 3) coder hashes);
        invalid hashes count at slot 0."""
        hashes = _masked(hashes, valid, self.device)
        slots, mult = torch.unique(hashes.reshape(-1), return_counts=True)
        # int64 sums: a multiplicity above 255 must not wrap
        new = torch.clamp(self.table[slots].to(torch.int64) + mult, max=self.cap)
        self.table[slots] = new.to(torch.uint8)
        return self

    def add_packed(self, packed: np.ndarray | torch.Tensor, mask: np.ndarray | torch.Tensor,
                   perm: np.ndarray, kmer_k: int) -> "CountTable":
        """Count every k-mer of a batch of 2-bit packed reads
        (``kmer.pack_codes_mask``): unpack, hash and update on the device."""
        codes = unpack_codes_mask(torch.as_tensor(packed, device=self.device),
                                  torch.as_tensor(mask, device=self.device))
        hashes, valid = kmer_hashes(codes, perm, kmer_k)
        return self.add_kmers(hashes, valid)

    def add_codes(self, codes: torch.Tensor, perm: np.ndarray, kmer_k: int,
                  counters: Optional[torch.Tensor] = None) -> "CountTable":
        """Count every k-mer of a batch of (B, L) uint8 base codes (0-3, 4
        invalid or pad) on the table's device: one launch of
        ``kernels.count_codes`` on the card, its plain version on the CPU.
        The counts equal ``add_packed``'s of the same rows packed;
        ``counters`` as ``kernels.count_codes`` takes them."""
        kernels.count_codes(self.table, torch.as_tensor(codes, device=self.device), perm,
                            kmer_k, self.cap, counters)
        return self

    def lookup(self, hashes: torch.Tensor) -> torch.Tensor:
        """Counts per hash (uint8, the hashes' shape); slot 0 always reads 0
        (extract_ref.cpp:861-866)."""
        hashes = torch.as_tensor(hashes, device=self.device).to(torch.int64)
        return self.table[hashes].masked_fill_(hashes == 0, 0)


def _masked(hashes: torch.Tensor, valid: Optional[torch.Tensor], device) -> torch.Tensor:
    """int64 hashes on ``device``, the invalid ones (``valid`` per hash or
    one axis short) moved to slot 0."""
    hashes = torch.as_tensor(hashes, device=device).to(torch.int64)
    if valid is not None:
        valid = torch.as_tensor(valid, device=device)
        if valid.dim() == hashes.dim() - 1:
            valid = valid[..., None]
        hashes = hashes.masked_fill(~valid.expand(hashes.shape), 0)
    return hashes


def _my_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of the leading dim: ceil(n / size) rows
    a rank, the last blocks short or empty."""
    n = -(-x.shape[0] // mesh.size)
    return x[mesh.index * n:(mesh.index + 1) * n]


#: bits of an exchanged pair that hold its increment: a pair is one int64,
#: ``hash << PAIR_SHIFT | min(multiplicity, cap)`` (hash < 2^32, cap ≤ 255)
PAIR_SHIFT = 8


@dataclass
class ShardedCountTable:
    """A saturating counter over 2^k hash slots split by hash range over
    every rank of a mesh, whatever its (data, model) shape (JAX's
    ``P(axes)`` over all the mesh's axes): the rank at ``mesh.index`` r
    holds the slots ``[r·S, (r+1)·S)`` on ``mesh.device``, S = ceil(2^k /
    mesh.size); the last shard's slots past 2^k are never hashed to.

    Updates are in place and collective: every rank of the mesh makes the
    same calls.  Each rank turns its part of a batch into distinct
    ``(hash, min(multiplicity, cap))`` pairs, the pairs of every rank are
    gathered on every rank (``collectives.gather_ragged``: the counts in one
    small all-reduce, the pairs in a zero-filled buffer, summed), and each
    rank applies those of its range: ``min(old + Σ inc, cap)``.  This is
    exact: ``min(old + Σ_r min(m_r, cap), cap) == min(old + Σ_r m_r, cap)``.
    Nothing is cut to a window, so nothing is dropped: unlike the JAX
    package's windowed scatter (``palace_tpu/ops/count_table.py``
    ``_batch_sharded_scatter``) there is no overflow to count, no
    ``ShardedOverflowError`` and no retry on a replicated table.  The
    counts equal ``CountTable``'s and JAX's; the layout is flat, where
    JAX's is 2-D rows (at k = 16 its one row sits on its first device).
    """

    table: torch.Tensor  # (S,) uint8: this rank's slots [lo, lo + S)
    k: int
    mesh: Mesh
    cap: int = 3

    @classmethod
    def create(cls, mesh: Mesh, k: int, cap: int = 3) -> "ShardedCountTable":
        """An empty table whose shard for this rank lies on ``mesh.device``."""
        size = -(-(1 << k) // mesh.size)
        return cls(torch.zeros(size, dtype=torch.uint8, device=mesh.device), k, mesh, cap)

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def lo(self) -> int:
        """The first slot of this rank's shard."""
        return self.mesh.index * self.table.numel()

    def add_kmers(self, hashes: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> "ShardedCountTable":
        """Count a batch of hashes (any shape, values < 2^k; ``valid`` as in
        ``CountTable.add_kmers``): every rank is given the whole batch and
        counts its block of the flattened hashes."""
        flat = _masked(hashes, valid, self.device).reshape(-1)
        return self._count(_my_rows(flat, self.mesh))

    def add_packed(self, packed: np.ndarray | torch.Tensor, mask: np.ndarray | torch.Tensor,
                   perm: np.ndarray, kmer_k: int, local: bool = False) -> "ShardedCountTable":
        """Count every k-mer of a batch of 2-bit packed reads: every rank is
        given the whole batch and unpacks and hashes its block of the rows,
        unless ``local``: then the batch is this rank's own (the reads of
        its files, ``search.eref.run_search_distributed``) and all of it is
        counted."""
        packed = torch.as_tensor(packed, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        if not local:
            packed, mask = _my_rows(packed, self.mesh), _my_rows(mask, self.mesh)
        hashes, valid = kmer_hashes(unpack_codes_mask(packed, mask), perm, kmer_k)
        return self._count(_masked(hashes, valid, self.device).reshape(-1))

    def _count(self, flat: torch.Tensor) -> "ShardedCountTable":
        slots, mult = torch.unique(flat, return_counts=True)
        pairs = gather_ragged(slots << PAIR_SHIFT | torch.clamp(mult, max=self.cap), self.mesh)
        h = (pairs >> PAIR_SHIFT) - self.lo
        mine = (h >= 0) & (h < self.table.numel())
        slots, where = torch.unique(h[mine], return_inverse=True)
        inc = torch.zeros(slots.numel(), dtype=torch.int64, device=self.device).index_add_(
            0, where, pairs[mine] & ((1 << PAIR_SHIFT) - 1))
        new = torch.clamp(self.table[slots].to(torch.int64) + inc, max=self.cap)
        self.table[slots] = new.to(torch.uint8)
        return self

    def lookup(self, hashes: torch.Tensor) -> torch.Tensor:
        """Counts per hash (uint8, the hashes' shape) on every rank: each rank
        reads those of its range, the rest are 0, and the parts are summed
        over the mesh; slot 0 always reads 0.  Collective."""
        hashes = torch.as_tensor(hashes, device=self.device).to(torch.int64)
        h = hashes - self.lo
        mine = (h >= 0) & (h < self.table.numel())
        part = torch.zeros(hashes.shape, dtype=torch.uint8, device=self.device)
        part[mine] = self.table[h[mine]]
        return all_reduce_(part, self.mesh.group_all).masked_fill_(hashes == 0, 0)
