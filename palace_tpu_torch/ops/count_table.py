"""Saturating k-mer count table on one device.

The reference allocates one 2^32-byte host array and lets threads race
on saturating increments (extract_ref.cpp:26, :995-998; counts saturate
at least_depth = 3).  Here the table is a flat uint8 tensor of 2^k bytes
on the device, indexed with int64 hashes, and a batch updates it
exactly: ``torch.unique`` gives each distinct hash of the batch and its
multiplicity, then one gather, a clamp and one scatter write
``min(old + multiplicity, cap)``.  Invalid k-mers go to slot 0, the
reference's permanent-miss slot (extract_ref.cpp:861-866), which counts
like any other slot but always reads 0 on lookup.

This is the JAX package's ``CountTable`` without its TPU layouts (the
2-D ``(2^(k-16), 2^16)`` table and the nibble-packed words, both there
for XLA:TPU's int32 index limits): the counts are the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from palace_tpu_torch.device import resolve_device
from palace_tpu_torch.ops.kmer import kmer_hashes, unpack_codes_mask


@dataclass
class CountTable:
    """Single-device saturating counter over 2^k hash slots.

    Updates are IN PLACE (the JAX table is updated by value): ``add_kmers``
    and ``add_packed`` change ``table`` and return ``self``."""

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
        hashes = torch.as_tensor(hashes, device=self.device).to(torch.int64)
        if valid is not None:
            valid = torch.as_tensor(valid, device=self.device)
            if valid.dim() == hashes.dim() - 1:
                valid = valid[..., None]
            hashes = hashes.masked_fill(~valid.expand(hashes.shape), 0)
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

    def lookup(self, hashes: torch.Tensor) -> torch.Tensor:
        """Counts per hash (uint8, the hashes' shape); slot 0 always reads 0
        (extract_ref.cpp:861-866)."""
        hashes = torch.as_tensor(hashes, device=self.device).to(torch.int64)
        return self.table[hashes].masked_fill_(hashes == 0, 0)
