"""k-mer reference search — the ``eref`` stage on one device.

Pipeline stage 3.3 (palace:473-477): decide which phage reference
genomes are present in the read set.

Phase A (extract_ref.cpp read_fastq :905-1008): reads, down-sampled to
~2 Gbp, fill a saturating count table over the canonical 3-coder k-mer
hashes.  Reads are packed on the host in fixed-shape batches and hashed
and counted on the device (``ops.count_table``).

Phase B (read_index :813-903 + slide_window :504-624): every reference
position's 3 hashes are looked up; a 500 bp sliding window marks good
regions (kernel K4); references covered >75 % are reported.  The packed
phagedb lives on the device; references of one length bucket are
scanned together in chunks of at most ``CHUNK_POS`` positions.

Down-sampling: the reference samples reads with C ``rand()`` seeded 1
(:1238-1242, :374).  When the input is ≤ 2 Gbp the ratio is ≥100 and
every read is used, the only regime where the reference is
deterministic; above that a deterministic per-read hash keeps the same
expected coverage.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from palace_tpu_torch.config import KmerParams
from palace_tpu_torch.device import resolve_device
from palace_tpu_torch.io.fasta import iter_fastq
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.count_table import CountTable
from palace_tpu_torch.ops.kmer import (
    BASE_LUT,
    kmer_hashes_masked,
    pack_codes_mask,
    unpack_codes_mask,
)
from palace_tpu_torch.ops.window import (
    RefHit,
    bucket_len,
    hit_from_good,
    unpack_good,
    window_thresholds,
)
from palace_tpu_torch.search.index import PhageIndex
from palace_tpu_torch.utils.logging import get_logger
from palace_tpu_torch.utils.timers import GLOBAL_METRICS

logger = get_logger("palace")

READ_BATCH = 4096         # Phase-A rows a batch on the CPU
CUDA_READ_BATCH = 32768   # Phase-A rows a batch on the card
ROW_LEN = 160             # row width: ≥150 bp short reads
#: positions a Phase-B chunk scans at most: references of one length bucket
#: stack into ``CHUNK_POS // bucket`` rows
CHUNK_POS = 1 << 22
_MIX = np.uint64(2654435761)


def read_batch_size(device: torch.device) -> int:
    return CUDA_READ_BATCH if device.type == "cuda" else READ_BATCH


def compute_downsample_ratio(fastq_path: str | Path, target_bases: int) -> int:
    """Reference cal_sam_ratio (extract_ref.cpp:1124-1148): percentage
    = 100·target / (2 × total bases of fq1)."""
    total = 2 * sum(len(seq) for _, seq, _ in iter_fastq(fastq_path))  # paired
    if total == 0:
        return 100
    return int(100 * target_bases // total)


def _keep_read(read_idx: int, ratio: int) -> bool:
    if ratio >= 100:
        return True
    return int((np.uint64(read_idx) * _MIX) % np.uint64(100)) < ratio


def _split_rows(codes: np.ndarray, maxlen: int, k: int) -> List[np.ndarray]:
    """Rows of ≤maxlen codes with k-1 overlap between consecutive rows of
    the same read, so the read's k-mer multiset is kept exactly."""
    n = codes.shape[0]
    if n <= maxlen:
        return [codes]
    rows = []
    stride = maxlen - (k - 1)
    off = 0
    while off < n:
        m = min(maxlen, n - off)
        rows.append(codes[off : off + m])
        if m < maxlen or off + m >= n:
            break
        off += stride
    return rows


def _pack(reads: List[np.ndarray], maxlen: int) -> np.ndarray:
    out = np.full((len(reads), maxlen), 4, dtype=np.uint8)
    for i, r in enumerate(reads):
        out[i, : r.shape[0]] = r
    return out


def read_code_batches(
    fastq_path: str | Path,
    batch: int = READ_BATCH,
    maxlen: int = ROW_LEN,
    ratio: int = 100,
    k: int = 32,
) -> Iterator[np.ndarray]:
    """(rows ≤ batch, maxlen) uint8 base-code matrices of the kept reads,
    pad code 4."""
    buf: List[np.ndarray] = []
    idx = 0
    for _, seq, _ in iter_fastq(fastq_path):
        if _keep_read(idx, ratio):
            codes = BASE_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]
            buf.extend(_split_rows(codes, maxlen, k))
        idx += 1
        while len(buf) >= batch:
            yield _pack(buf[:batch], maxlen)
            buf = buf[batch:]
    if buf:
        yield _pack(buf, maxlen)


def count_reads_into_table(
    fastq_files: Sequence[str | Path],
    index: PhageIndex,
    params: KmerParams,
    device: str | torch.device = "cuda",
) -> CountTable:
    """Phase A: count every k-mer of the reads into a new table on
    ``device`` (the CUDA card unless ``device="cpu"``)."""
    table = CountTable.create(params.k, params.least_depth, device=device)
    ratio = compute_downsample_ratio(fastq_files[0], params.down_sampling_size)
    logger.info("Down-sampling ratio is %d%%.", min(ratio, 100))
    t0 = time.perf_counter()
    n_reads = 0
    maxlen = max(ROW_LEN, params.k)
    maxlen += (-maxlen) % 8  # pack_codes_mask wants L % 8 == 0
    batch = read_batch_size(table.device)
    for fq in fastq_files:
        for codes in read_code_batches(fq, batch, maxlen, ratio, params.k):
            n_reads += codes.shape[0]
            if codes.shape[0] < batch:
                # full batches, as the JAX package pads for one jit shape:
                # the pad rows' invalid k-mers count at slot 0 in both
                codes = np.pad(codes, ((0, batch - codes.shape[0]), (0, 0)),
                               constant_values=4)
            packed, mask = pack_codes_mask(codes)
            table.add_packed(torch.from_numpy(packed), torch.from_numpy(mask),
                             index.perm, params.k)
    if table.device.type == "cuda":
        torch.cuda.synchronize(table.device)
    GLOBAL_METRICS.record("eref.count_reads", time.perf_counter() - t0,
                          items=n_reads, unit="reads")
    return table


def plan_chunks(index: PhageIndex) -> List[Tuple[int, List[int], int]]:
    """Phase B's chunks, in launch order: ``(bucket, refs, rows)``.

    References longer than k (read_ref :698) are grouped by
    ``bucket_len`` in reference order; a bucket's refs go ``rows`` at a
    time, where rows is bounded by CHUNK_POS of work and by the next power
    of two ≥ the bucket's ref count.  A chunk with fewer refs than rows
    is padded with empty rows."""
    by_bucket: dict = {}
    for r in range(index.n_refs):
        L = int(index.lengths[r])
        if L > index.k:
            by_bucket.setdefault(bucket_len(L), []).append(r)
    chunks = []
    for target in sorted(by_bucket):
        refs = by_bucket[target]
        rows = max(1, min(CHUNK_POS // target, 1 << max(0, len(refs) - 1).bit_length()))
        for c0 in range(0, len(refs), rows):
            chunks.append((target, refs[c0:c0 + rows], rows))
    return chunks


class DeviceDB:
    """The packed phagedb on the device, padded by the largest slice a
    chunk reads past a reference's start."""

    def __init__(self, index: PhageIndex, device: torch.device):
        targets = [bucket_len(int(L)) for L in index.lengths]
        slack = max(targets, default=0)
        self.index = index
        self.packed = torch.from_numpy(np.pad(index.packed, (0, slack // 4))).to(device)
        self.mask = torch.from_numpy(np.pad(index.maskbits, (0, slack // 8))).to(device)


def chunk_inputs(db: DeviceDB, table: CountTable, target: int, refs: List[int], rows: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The counts and hashes, (rows, target, 3) uint8 and int64, that K4
    scans for one chunk: slice each reference's packed codes, unpack, mask
    the tail past ``ref_len`` (it may hold the next reference), hash, pad
    the last k-1 positions with hash 0, and look the hashes up (hash 0
    always reads 0).  Empty pad rows mask to code 4 everywhere.  The
    profiler spans ``eref.gather``, ``eref.hash`` and ``eref.lookup`` name
    the three steps."""
    index, dev = db.index, db.packed.device
    pad = rows - len(refs)
    with record_function("eref.gather"):
        offs = torch.tensor([[int(index.code_offsets[r]), int(index.mask_offsets[r]),
                              int(index.lengths[r])] for r in refs] + [[0, 0, 0]] * pad,
                            dtype=torch.int64).to(dev)
        pb = db.packed[offs[:, 0:1] + torch.arange(target // 4, device=dev)]
        mb = db.mask[offs[:, 1:2] + torch.arange(target // 8, device=dev)]
        codes = unpack_codes_mask(pb, mb)
        codes.masked_fill_(torch.arange(target, device=dev) >= offs[:, 2:3], 4)
    with record_function("eref.hash"):
        hashes = kmer_hashes_masked(codes, index.perm, index.k)
        hashes = torch.nn.functional.pad(hashes, (0, 0, 0, index.k - 1))
    with record_function("eref.lookup"):
        counts = table.lookup(hashes)
    return counts, hashes


def search_references(table: CountTable, index: PhageIndex, params: KmerParams) -> List[RefHit]:
    """Phase B on the table's device: scan every reference and return the
    hits in reference order.  Every chunk is launched before any result is
    fetched; each returns its good flags packed 8 positions a byte (K4,
    under the profiler span ``eref.good_windows``)."""
    t0 = time.perf_counter()
    one_min, three_min = window_thresholds(params.window, params.hit_ratio,
                                           params.perfect_hit_ratio)
    db = DeviceDB(index, table.device)
    launched = []
    for target, refs, rows in plan_chunks(index):
        counts, hashes = chunk_inputs(db, table, target, refs, rows)
        with record_function("eref.good_windows"):
            bits = kernels.good_windows(counts, hashes, params.window, one_min, three_min,
                                        params.least_depth)
        del counts, hashes
        launched.append((refs, bits))

    hits: List[RefHit] = []
    for refs, bits in launched:
        bits_host = bits.cpu().numpy()
        for row, r in enumerate(refs):
            ref_len = int(index.lengths[r])
            hit = hit_from_good(unpack_good(bits_host[row], ref_len), r + 1, ref_len,
                                params.window, params.min_cover_ratio)
            if hit is not None:
                hits.append(hit)
    hits.sort(key=lambda h: h.ref_index)
    GLOBAL_METRICS.record("eref.scan_refs", time.perf_counter() - t0,
                          items=index.n_refs, unit="refs")
    return hits


def write_ref_names(path: str | Path, hits: Sequence[RefHit]) -> None:
    """The ``{prefix}_ref_names.txt`` artifact (palace:475-477 captures
    eref's stdout)."""
    with open(path, "w") as fh:
        for hit in hits:
            fh.write(hit.line() + "\n")


def run_search(
    fastq1: str | Path,
    fastq2: str | Path,
    index: PhageIndex,
    params: KmerParams,
    out_ref_names: str | Path,
    device: str | torch.device = "cuda",
) -> List[RefHit]:
    """The eref stage: count the paired reads, scan the references and
    write ``out_ref_names``, on the CUDA card unless ``device="cpu"``."""
    dev = resolve_device(device)
    table = count_reads_into_table([fastq1, fastq2], index, params, device=dev)
    hits = search_references(table, index, params)
    write_ref_names(out_ref_names, hits)
    logger.info("eref: %d references reported", len(hits))
    return hits
