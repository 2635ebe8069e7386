"""Phage reference k-mer index.

Equivalent of the reference's ``.k32.index.dat`` (extract_ref.cpp
read_ref :652-811), stored as 2-bit packed base codes plus a 1-bit
invalid mask per reference (~0.28 B a base) instead of 12 B of hashes a
position: the whole phagedb stays on the device and Phase B hashes it
there.  The coder permutation comes from a fixed seed, and reference
indices are the 1-based FASTA record number.

The cache file ``{fasta}.k{k}.palace.npz`` has the JAX package's layout,
so either package loads the other's.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from palace_tpu_torch.device import resolve_device
from palace_tpu_torch.io.fasta import iter_fasta
from palace_tpu_torch.ops.kmer import (
    kmer_hashes_masked,
    make_choose_coder,
    pack_codes_mask,
    seq_to_codes,
)
from palace_tpu_torch.utils.logging import get_logger
from palace_tpu_torch.utils.timers import StageTimer

logger = get_logger("palace")

TILE = 1 << 18  # reference positions hashed a call (compute_hashes_for_codes)


@dataclass
class PhageIndex:
    k: int
    perm: np.ndarray            # (k, 3)
    names: List[str]
    lengths: np.ndarray         # (R,) int64 reference lengths
    code_offsets: np.ndarray    # (R+1,) int64 byte offsets into ``packed``
    mask_offsets: np.ndarray    # (R+1,) int64 byte offsets into ``maskbits``
    packed: np.ndarray          # flat uint8: 4 bases/byte, refs byte-aligned
    maskbits: np.ndarray        # flat uint8: 8 positions/byte invalid bits

    @property
    def n_refs(self) -> int:
        return len(self.names)

    def ref_codes(self, r: int) -> np.ndarray:
        """(L,) uint8 base codes 0..4 of reference ``r`` (host unpack)."""
        L = int(self.lengths[r])
        pb = self.packed[self.code_offsets[r] : self.code_offsets[r + 1]]
        mb = self.maskbits[self.mask_offsets[r] : self.mask_offsets[r + 1]]
        codes = np.empty(pb.shape[0] * 4, dtype=np.uint8)
        for i in range(4):
            codes[i::4] = (pb >> (2 * i)) & 3
        inv = np.unpackbits(mb, bitorder="little")[: codes.shape[0]].astype(bool)
        codes[inv] = 4
        return codes[:L]

    def ref_hashes(self, r: int, device: str | torch.device = "cuda") -> np.ndarray:
        """(M, 3) canonical hashes of reference ``r``, computed on ``device``;
        invalid windows → 0."""
        return compute_hashes_for_codes(self.ref_codes(r), self.perm, self.k, device)


def _index_path(fasta_path: str | Path, k: int) -> Path:
    return Path(str(fasta_path) + f".k{k}.palace.npz")


def perm_from_reference_index(index_dat: str | Path, k: int = 32) -> np.ndarray:
    """The coder permutation of a reference ``.k32.index.dat``: its first
    100 "u32" header entries carry ``choose_coder[j]`` in their low 16 bits
    (extract_ref.cpp:680-682, saved_random_coder :1104-1122)."""
    raw = np.fromfile(index_dat, dtype="<u4", count=100)
    if raw.shape[0] < 100:
        raise ValueError(f"{index_dat}: truncated header ({raw.shape[0]} < 100 u32)")
    shorts = (raw & 0xFFFF).astype(np.int32)
    perm = shorts[: k * 3].reshape(k, 3)
    if perm.min() < 0 or perm.max() > 2:
        raise ValueError(f"{index_dat}: header is not a coder permutation")
    return perm


def iter_reference_index_records(index_dat: str | Path, k: int = 32):
    """Yield ``(ref_len, hashes (ref_len-k+1, 3) uint32)`` per record of a
    reference-format index (extract_ref.cpp:841-878: u32 ref_len, then
    (ref_len-k+1)·3 u32 canonical hashes)."""
    with open(index_dat, "rb") as fh:
        fh.seek(400)  # 100-u32 choose_coder header
        while True:
            head = fh.read(4)
            if len(head) < 4:
                return
            ref_len = int(np.frombuffer(head, dtype="<u4")[0])
            m = ref_len - k + 1
            data = np.fromfile(fh, dtype="<u4", count=m * 3)
            if data.shape[0] < m * 3:
                return
            yield ref_len, data.reshape(m, 3)


def compute_hashes_for_codes(codes: np.ndarray, perm: np.ndarray, k: int,
                             device: str | torch.device = "cuda") -> np.ndarray:
    """Canonical (M, 3) uint32 hashes of one code sequence, computed on
    ``device`` in tiles of ``TILE`` positions; invalid windows → 0
    (extract_ref.cpp:793-796)."""
    dev = resolve_device(device)
    M = codes.shape[0] - k + 1
    if M <= 0:
        return np.zeros((0, 3), np.uint32)
    chunks = []
    for start in range(0, M, TILE):
        stop = min(start + TILE, M)
        tile = torch.from_numpy(np.ascontiguousarray(codes[start : stop + k - 1]))[None]
        chunks.append(kmer_hashes_masked(tile.to(dev), perm, k)[0].cpu().numpy())
    return np.concatenate(chunks, axis=0).astype(np.uint32)


def compute_hashes_for_seq(seq: str, perm: np.ndarray, k: int,
                           device: str | torch.device = "cuda") -> np.ndarray:
    """``compute_hashes_for_codes`` of a sequence's base codes."""
    return compute_hashes_for_codes(seq_to_codes(seq), perm, k, device)


def build_index(
    fasta_path: str | Path,
    k: int = 32,
    coder_seed: int = 1,
    save: bool = True,
    perm: Optional[np.ndarray] = None,
) -> PhageIndex:
    """Build the packed index on the host.  ``perm`` overrides the seeded
    coder permutation: pass ``perm_from_reference_index(...)`` to search
    hash-compatibly with an index the reference binary built."""
    if perm is None:
        perm = make_choose_coder(k, coder_seed)
    with StageTimer("eref.index_build", unit="refs") as span:
        names: List[str] = []
        lengths: List[int] = []
        code_offsets: List[int] = [0]
        mask_offsets: List[int] = [0]
        packed_parts: List[np.ndarray] = []
        mask_parts: List[np.ndarray] = []
        for name, seq in iter_fasta(fasta_path):
            names.append(name)
            lengths.append(len(seq))
            codes = seq_to_codes(seq)
            pad = (-codes.shape[0]) % 8
            if pad:
                codes = np.pad(codes, (0, pad), constant_values=4)
            pb, mb = pack_codes_mask(codes[None, :])
            packed_parts.append(pb[0])
            mask_parts.append(mb[0])
            code_offsets.append(code_offsets[-1] + pb.shape[1])
            mask_offsets.append(mask_offsets[-1] + mb.shape[1])
        index = PhageIndex(
            k=k,
            perm=perm,
            names=names,
            lengths=np.asarray(lengths, np.int64),
            code_offsets=np.asarray(code_offsets, np.int64),
            mask_offsets=np.asarray(mask_offsets, np.int64),
            packed=(np.concatenate(packed_parts) if packed_parts else np.zeros(0, np.uint8)),
            maskbits=(np.concatenate(mask_parts) if mask_parts else np.zeros(0, np.uint8)),
        )
        span.items = len(names)
    if save:
        save_index(fasta_path, index)
    return index


def save_index(fasta_path: str | Path, index: PhageIndex) -> None:
    path = _index_path(fasta_path, index.k)
    np.savez(
        path,
        k=np.int64(index.k),
        perm=index.perm,
        names=np.asarray(index.names),
        lengths=index.lengths,
        code_offsets=index.code_offsets,
        mask_offsets=index.mask_offsets,
        packed=index.packed,
        maskbits=index.maskbits,
    )
    logger.info("Saved k-mer index: %s (%d refs, %d bytes packed)",
                path, index.n_refs, index.packed.shape[0])


def load_index(fasta_path: str | Path, k: int = 32) -> Optional[PhageIndex]:
    path = _index_path(fasta_path, k)
    if not path.exists():
        return None
    with np.load(path, allow_pickle=False) as meta:
        return PhageIndex(
            k=int(meta["k"]),
            perm=np.asarray(meta["perm"]),
            names=[str(n) for n in meta["names"]],
            lengths=np.asarray(meta["lengths"]),
            code_offsets=np.asarray(meta["code_offsets"]),
            mask_offsets=np.asarray(meta["mask_offsets"]),
            packed=np.asarray(meta["packed"]),
            maskbits=np.asarray(meta["maskbits"]),
        )


def load_or_build_index(fasta_path: str | Path, k: int = 32, coder_seed: int = 1) -> PhageIndex:
    """Cache-or-build, as the reference skips an existing index
    (extract_ref.cpp:1245-1254)."""
    index = load_index(fasta_path, k)
    if index is not None:
        logger.info("Reference index is detected.")
        return index
    logger.info("Reference index not detected, start index...")
    return build_index(fasta_path, k, coder_seed)
