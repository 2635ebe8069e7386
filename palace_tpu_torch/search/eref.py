"""k-mer reference search — the ``eref`` stage, on one device or across a
mesh of ranks.

Pipeline stage 3.3 (palace:473-477): decide which phage reference
genomes are present in the read set.

Phase A (extract_ref.cpp read_fastq :905-1008): reads, down-sampled to
~2 Gbp, fill a saturating count table over the canonical 3-coder k-mer
hashes.  The native loader (``io/fastq_native.py``) parses the FASTQ
into fixed-shape code batches on the host.  On a CUDA card (one device)
each batch goes to the card as it is and one launch of
``kernels.count_codes`` hashes and counts it (``CountTable.add_codes``),
with no read-back until Phase A's end, so the card's work overlaps the
reader's next batch; elsewhere (the CPU, a mesh) a batch is packed on the
host (``kmer.pack_codes_mask``) and unpacked, hashed and counted by
``add_packed`` (``ops.count_table``).

Phase B (read_index :813-903 + slide_window :504-624): every reference
position's 3 hashes are looked up; a 500 bp sliding window marks good
regions; references covered >75 % are reported.  The packed phagedb
lives on the device; references of one length bucket are scanned
together in chunks of at most ``CHUNK_POS`` positions, each by one
launch of ``kernels.scan_chunk`` (K4 fused with the unpack, hashing and
lookup before it).

Across devices (``mesh=``, ``parallel.mesh.make_mesh``) the table is a
``ShardedCountTable``, split by hash range over the ranks, and Phase B
scans each chunk on every rank against its own shard (``kernels.scan_hits``),
ORs the ranks' hit bits with one all-reduce and windows them
(``kernels.window_hits``); every rank gets the same hits, and rank 0 alone
writes ``ref_names.txt``.  ``run_search_distributed`` also splits the
reads: each rank reads its share of the FASTQ files.

Down-sampling: the reference samples reads with C ``rand()`` seeded 1
(:1238-1242, :374).  When the input is ≤ 2 Gbp the ratio is ≥100 and
every read is used, the only regime where the reference is
deterministic; above that a deterministic per-read hash keeps the same
expected coverage.

Spans (``utils.timers.StageTimer``): ``eref.run_search`` holds a call;
Phase A is ``eref.table_create``, ``eref.downsample_ratio`` and
``eref.count_reads``, which holds ``eref.read`` (each batch from the
reader), ``eref.pack`` (the host's preparation of a batch: on the card
its copy into a reused pinned buffer, whose rows past a short batch's are
set to the pad code 4; elsewhere the pad and ``pack_codes_mask``),
``eref.add_packed`` (on the card the batch's upload and the launch;
elsewhere the uploads, the unpack and hash launches and
``torch.unique``'s wait) and ``eref.count_sync`` (the one
wait for the card, and the read-back of ``count_codes``' counters, which go
into ``GLOBAL_METRICS`` as ``eref.count_updates`` and ``eref.count_at_cap``);
Phase B is ``eref.scan_refs``, which holds ``eref.plan``,
``eref.upload``, ``eref.hit_filter`` (sharded), and a chunk at a time
``eref.scan`` (with the wrapper's ``eref.scan_check``),
``eref.scan_fetch`` and ``eref.verdicts``; ``eref.write`` writes the
report.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from palace_tpu_torch.config import KmerParams
from palace_tpu_torch.device import resolve_device
from palace_tpu_torch.io import fastq_native
from palace_tpu_torch.io.fasta import iter_fastq
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.count_table import CountTable, ShardedCountTable
from palace_tpu_torch.ops.kmer import BASE_LUT, pack_codes_mask
from palace_tpu_torch.ops.window import (
    RefHit,
    bucket_len,
    hit_from_good,
    unpack_good,
    window_thresholds,
)
from palace_tpu_torch.parallel.collectives import TIMING, all_reduce_, gather_ragged
from palace_tpu_torch.parallel.distributed import shard_inputs_for_process
from palace_tpu_torch.parallel.mesh import Mesh
from palace_tpu_torch.search.index import PhageIndex
from palace_tpu_torch.utils.logging import get_logger
from palace_tpu_torch.utils.timers import GLOBAL_METRICS, StageTimer

logger = get_logger("palace")

READ_BATCH = 4096         # Phase-A rows a batch on the CPU
CUDA_READ_BATCH = 32768   # Phase-A rows a batch on the card
ROW_LEN = 160             # row width: ≥150 bp short reads
#: positions a Phase-B chunk scans at most: references of one length bucket
#: stack into ``CHUNK_POS // bucket`` rows
CHUNK_POS = 1 << 22
_MIX = np.uint64(2654435761)
#: FASTQ files read by each of Phase A's readers (``read_code_batches``)
READERS: Dict[str, int] = {"native": 0, "python": 0}


def read_batch_size(device: torch.device) -> int:
    return CUDA_READ_BATCH if device.type == "cuda" else READ_BATCH


def compute_downsample_ratio(fastq_path: str | Path, target_bases: int) -> int:
    """Reference cal_sam_ratio (extract_ref.cpp:1124-1148): percentage
    = 100·target / (2 × total bases of fq1).  The bases are counted by the
    native loader, or in Python where it is unavailable."""
    with StageTimer("eref.downsample_ratio", unit="bases") as span:
        total = fastq_native.count_bases(fastq_path)
        if total is None:
            total = sum(len(seq) for _, seq, _ in iter_fastq(fastq_path))
        span.items = total
    total *= 2  # paired
    if total == 0:
        return 100
    return int(100 * target_bases // total)


def _keep_read(read_idx: int, ratio: int) -> bool:
    if ratio >= 100:
        return True
    return int((np.uint64(read_idx) * _MIX) % np.uint64(100)) < ratio


def _split_rows(codes: np.ndarray, maxlen: int, k: int) -> List[np.ndarray]:
    """Rows of ≤maxlen codes with k-1 overlap between consecutive rows of
    the same read, so the read's k-mer multiset is kept exactly (the
    native loader's ``emit_read``)."""
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


def _py_read_batches(fastq_path: str | Path, batch: int, maxlen: int, ratio: int,
                     k: int) -> Iterator[np.ndarray]:
    """The Python reader: (rows ≤ batch, maxlen) uint8 base-code matrices
    of the kept reads, pad code 4, as the native loader gives them."""
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


def read_code_batches(
    fastq_path: str | Path,
    batch: int = READ_BATCH,
    maxlen: int = ROW_LEN,
    ratio: int = 100,
    k: int = 32,
) -> Iterator[np.ndarray]:
    """(rows ≤ batch, maxlen) uint8 base-code matrices of the kept reads,
    pad code 4: from the native loader where it is built, else from the
    Python reader (the same batches), each made under the span
    ``eref.read``.  ``READERS`` counts the files each read."""
    if fastq_native.available():
        READERS["native"] += 1
        batches = fastq_native.native_batches(fastq_path, batch, maxlen, ratio, k)
    else:
        READERS["python"] += 1
        batches = _py_read_batches(fastq_path, batch, maxlen, ratio, k)
    while True:
        with StageTimer("eref.read", unit="rows") as span:
            codes = next(batches, None)
            span.items = 0 if codes is None else codes.shape[0]
        if codes is None:
            return
        yield codes


def _timing() -> Tuple[float, int]:
    return TIMING.seconds, TIMING.bytes


def _record_collectives(stage: str, before: Tuple[float, int]) -> None:
    """The collectives' seconds and bytes since ``before``, under ``stage``
    in ``GLOBAL_METRICS``, when ``collectives.TIMING`` is on."""
    if TIMING.enabled:
        secs, nbytes = _timing()
        GLOBAL_METRICS.record(stage, secs - before[0], items=nbytes - before[1], unit="bytes")


def _count_sync(table, counters: Optional[torch.Tensor] = None) -> None:
    """The end of Phase A: the card's updates done, and ``count_codes``'
    counters, where there are any, read back into ``GLOBAL_METRICS``:
    ``eref.count_updates`` (the updates issued as a CAS) and
    ``eref.count_at_cap`` (those skipped at cap)."""
    with StageTimer("eref.count_sync"):
        if table.device.type == "cuda":
            torch.cuda.synchronize(table.device)
        if counters is not None:
            updates, at_cap = counters.tolist()
    if counters is not None:
        GLOBAL_METRICS.record("eref.count_updates", 0.0, updates, unit="updates")
        GLOBAL_METRICS.record("eref.count_at_cap", 0.0, at_cap, unit="hashes")


def _row_len(params: KmerParams) -> int:
    maxlen = max(ROW_LEN, params.k)
    return maxlen + (-maxlen) % 8  # pack_codes_mask wants L % 8 == 0


def count_reads_into_table(
    fastq_files: Sequence[str | Path],
    index: PhageIndex,
    params: KmerParams,
    device: str | torch.device = "cuda",
    mesh: Optional[Mesh] = None,
) -> CountTable | ShardedCountTable:
    """Phase A: count every k-mer of the reads into a new table on
    ``device`` (the CUDA card unless ``device="cpu"``).  Under a ``mesh``
    the table is a ``ShardedCountTable`` on ``mesh.device`` (``device`` is
    not read): every rank reads the same files, the batch rounds up to a
    multiple of the mesh's ranks, and each rank counts its block of every
    batch.  On one CUDA card each batch is counted by one launch of
    ``kernels.count_codes`` (``CountTable.add_codes``) from the reader's
    codes; on the CPU and under a mesh it is packed on the host and counted
    by ``add_packed``.  The tables are the same."""
    with StageTimer("eref.table_create"):
        if mesh is None:
            table = CountTable.create(params.k, params.least_depth, device=device)
        else:
            table = ShardedCountTable.create(mesh, params.k, params.least_depth)
    on_card = mesh is None and table.device.type == "cuda"
    counters = torch.zeros(2, dtype=torch.int64, device=table.device) if on_card else None
    uploaded = torch.cuda.Event() if on_card else None  # the last upload from `staging`
    ratio = compute_downsample_ratio(fastq_files[0], params.down_sampling_size)
    logger.info("Down-sampling ratio is %d%%.", min(ratio, 100))
    before = _timing()
    with StageTimer("eref.count_reads", unit="reads") as span:
        maxlen = _row_len(params)
        batch = read_batch_size(table.device)
        if mesh is not None:
            batch = -(-batch // mesh.size) * mesh.size
        if on_card:
            staging = torch.empty((batch, maxlen), dtype=torch.uint8, pin_memory=True)
            staged = staging.numpy()
        # eref.pack's items are the reader's rows, eref.add_packed's the pad rows too.
        # A batch's arrays stay alive until the next batch's replace them: freed
        # before the next read, they let glibc trim the heap and fault it back in
        # every batch (Phase A 1.99-2.08 s a sample against 1.41-1.49 on the host
        # of an H100)
        for fq in fastq_files:
            for codes in read_code_batches(fq, batch, maxlen, ratio, params.k):
                span.items += codes.shape[0]
                if on_card:
                    # staged in one pinned buffer once the last upload has read it (a
                    # fresh pinned block a batch cost 0.43 ms to allocate and 0.81 ms to
                    # fill, on the host of an H100), by NumPy on this thread: torch's
                    # copy_ splits it over the intra-op threads, and on that shared host
                    # took 0.26-3.2 ms a batch (medians of two runs) against 0.61-0.79;
                    # a short batch's missing rows are code 4, the pad of the other route
                    n = codes.shape[0]
                    with StageTimer("eref.pack", n, unit="rows"):
                        uploaded.synchronize()
                        staged[:n] = codes
                        staged[n:] = 4
                    with StageTimer("eref.add_packed", batch, unit="rows"):
                        # the upload and the launch run on the table's device's stream,
                        # which need not be the current device's
                        dev_codes = staging.to(table.device, non_blocking=True)
                        uploaded.record(torch.cuda.current_stream(table.device))
                        table.add_codes(dev_codes, index.perm, params.k, counters)
                    continue
                with StageTimer("eref.pack", codes.shape[0], unit="rows"):
                    if codes.shape[0] < batch:
                        # full batches, as the JAX package pads for one jit shape:
                        # the pad rows' invalid k-mers count at slot 0 in both
                        codes = np.pad(codes, ((0, batch - codes.shape[0]), (0, 0)),
                                       constant_values=4)
                    packed, mask = pack_codes_mask(codes)
                with StageTimer("eref.add_packed", batch, unit="rows"):
                    table.add_packed(torch.from_numpy(packed), torch.from_numpy(mask),
                                     index.perm, params.k)
        _count_sync(table, counters)
    _record_collectives("eref.count_reads.collectives", before)
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
        slack = max((bucket_len(int(L)) for L in index.lengths), default=0)
        self.index = index
        self.packed = self._padded(index.packed, slack // 4, device)
        self.mask = self._padded(index.maskbits, slack // 8, device)

    @staticmethod
    def _padded(a: np.ndarray, pad: int, device: torch.device) -> torch.Tensor:
        """``a`` followed by ``pad`` zero bytes on ``device``, with no
        padded copy on the host."""
        out = torch.zeros(a.shape[0] + pad, dtype=torch.uint8, device=device)
        out[:a.shape[0]].copy_(torch.from_numpy(a))
        return out


def chunk_offsets(index: PhageIndex, refs: List[int], rows: int) -> np.ndarray:
    """A chunk's (rows, 3) int64 offsets, as ``kernels.scan_chunk`` takes
    them: each reference's code byte offset, mask byte offset and length,
    then (0, 0, 0) for each pad row."""
    offs = np.zeros((rows, 3), np.int64)
    r = np.asarray(refs, np.int64)
    offs[:len(refs)] = np.stack([index.code_offsets[r], index.mask_offsets[r],
                                 index.lengths[r]], axis=1)
    return offs


def chunk_inputs(db: DeviceDB, table: CountTable, target: int, refs: List[int], rows: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The counts and hashes, (rows, target, 3) uint8 and int64, of one
    chunk (``kernels.scan_counts_plain``): what K4's ``good_windows``
    scans, and what ``scan_chunk`` keeps out of device memory."""
    offs = torch.from_numpy(chunk_offsets(db.index, refs, rows)).to(db.packed.device)
    return kernels.scan_counts_plain(db.packed, db.mask, offs, table.table, db.index.perm,
                                     db.index.k, target)


def search_references(table: CountTable | ShardedCountTable, index: PhageIndex,
                      params: KmerParams) -> List[RefHit]:
    """Phase B on the table's device: scan every reference and return the
    hits in reference order.  Every chunk's offsets go to the device in
    one copy, and every chunk is launched before any result is fetched:
    ``kernels.scan_chunk`` under the profiler span ``eref.scan`` returns
    its good flags packed 8 positions a byte.  On a ``ShardedCountTable``
    (collective: every rank makes the same calls) the rank's shard gets one
    ``kernels.hit_filter``, and each chunk is instead
    ``kernels.scan_hits`` against the shard, one uint8 all-reduce of
    the hit bit-planes over the mesh (each bit has one owning rank, so the
    sum is their OR), and ``kernels.window_hits``; every rank gets the same
    hits.  Its spans are ``eref.plan``, ``eref.upload``, ``eref.hit_filter``
    (sharded, on the card) and, a chunk at a time, ``eref.scan`` (the
    launches, with the wrapper's synchronizing ``eref.scan_check``),
    ``eref.scan_fetch`` (which waits for the card) and ``eref.verdicts``
    (the host's verdicts on the flags)."""
    before = _timing()
    with StageTimer("eref.scan_refs", index.n_refs, unit="refs"):
        with StageTimer("eref.plan", unit="chunks") as span:
            one_min, three_min = window_thresholds(params.window, params.hit_ratio,
                                                   params.perfect_hit_ratio)
            chunks = plan_chunks(index)
            offs = np.concatenate([np.zeros((0, 3), np.int64)]
                                  + [chunk_offsets(index, refs, rows) for _, refs, rows in chunks])
            span.items = len(chunks)
        with StageTimer("eref.upload", unit="bytes") as span:
            db = DeviceDB(index, table.device)
            offs = torch.from_numpy(offs).to(db.packed.device)
            span.items = db.packed.numel() + db.mask.numel() + offs.numel() * offs.element_size()
        launched, row0 = [], 0
        sharded = isinstance(table, ShardedCountTable)
        filt = None  # the card's scan_hits reads a filter; the plain version reads the shard
        if sharded and table.device.type == "cuda":  # one a Phase B: the shard does not change
            with StageTimer("eref.hit_filter"):
                filt = kernels.hit_filter(table.table, params.least_depth)
        for target, refs, rows in chunks:
            with StageTimer("eref.scan", rows * target, unit="positions"):
                if sharded:
                    planes = kernels.scan_hits(db.packed, db.mask, offs[row0:row0 + rows],
                                               table.table, table.lo, index.perm, index.k, target,
                                               params.least_depth, filt)
                    bits = kernels.window_hits(all_reduce_(planes, table.mesh.group_all),
                                               params.window, one_min, three_min)
                else:
                    bits = kernels.scan_chunk(db.packed, db.mask, offs[row0:row0 + rows],
                                              table.table, index.perm, index.k, target,
                                              params.window, one_min, three_min, params.least_depth)
            launched.append((refs, bits))
            row0 += rows

        hits: List[RefHit] = []
        for refs, bits in launched:
            with StageTimer("eref.scan_fetch", bits.numel(), unit="bytes"):
                bits_host = bits.cpu().numpy()
            with StageTimer("eref.verdicts", len(refs), unit="refs"):
                for row, r in enumerate(refs):
                    ref_len = int(index.lengths[r])
                    hit = hit_from_good(unpack_good(bits_host[row], ref_len), r + 1, ref_len,
                                        params.window, params.min_cover_ratio)
                    if hit is not None:
                        hits.append(hit)
        hits.sort(key=lambda h: h.ref_index)
    _record_collectives("eref.scan_refs.collectives", before)
    return hits


def write_ref_names(path: str | Path, hits: Sequence[RefHit]) -> None:
    """The ``{prefix}_ref_names.txt`` artifact (palace:475-477 captures
    eref's stdout), under the span ``eref.write``."""
    with StageTimer("eref.write", len(hits), unit="lines"), open(path, "w") as fh:
        for hit in hits:
            fh.write(hit.line() + "\n")


def run_search(
    fastq1: str | Path,
    fastq2: str | Path,
    index: PhageIndex,
    params: KmerParams,
    out_ref_names: str | Path,
    device: str | torch.device = "cuda",
    mesh: Optional[Mesh] = None,
) -> List[RefHit]:
    """The eref stage: count the paired reads, scan the references and
    write ``out_ref_names``, on the CUDA card unless ``device="cpu"``.
    Under a ``mesh`` (collective) every rank reads both files and counts
    into the sharded table on ``mesh.device``, every rank returns the same
    hits, and rank 0 alone writes the file.  The call is the span
    ``eref.run_search``."""
    with StageTimer("eref.run_search", 1, unit="samples"):
        if mesh is None:
            device = resolve_device(device)
        table = count_reads_into_table([fastq1, fastq2], index, params, device=device,
                                       mesh=mesh)
        hits = search_references(table, index, params)
        if mesh is None or mesh.rank == 0:
            write_ref_names(out_ref_names, hits)
    logger.info("eref: %d references reported", len(hits))
    return hits


def run_search_distributed(
    fastq_files: Sequence[str | Path],
    index: PhageIndex,
    params: KmerParams,
    out_ref_names: str | Path,
    mesh: Mesh,
) -> List[RefHit]:
    """The eref stage with the reads split over the ranks of ``mesh``
    (collective): each rank reads its round-robin share of the FASTQ files
    (``shard_inputs_for_process``) and counts its own batches into the
    sharded table (``add_packed(..., local=True)``), so no rank reads every
    file; Phase B as ``search_references``; rank 0 alone writes the file.

    Every rank must make as many updates as the others, so the batch counts
    are gathered and each rank pads up to the largest with all-pad batches
    (code 4: every k-mer invalid, counted at slot 0, which no lookup
    reads).  Each update's exchange sends its pair counts to the host, so
    the ranks meet at every batch; that bounds their skew and the device
    queue, as the JAX package's ``PALACE_DIST_SYNC_EVERY`` sync does every
    few batches.  The down-sampling ratio comes from the first file, on
    every rank, as in JAX.  Its spans are ``run_search``'s."""
    with StageTimer("eref.run_search", 1, unit="samples"):
        my_files = shard_inputs_for_process([str(f) for f in fastq_files], mesh.index,
                                            mesh.size)
        ratio = compute_downsample_ratio(fastq_files[0], params.down_sampling_size)
        logger.info("Down-sampling ratio is %d%%.", min(ratio, 100))
        before = _timing()
        with StageTimer("eref.count_reads", unit="reads") as span:
            with StageTimer("eref.table_create"):
                table = ShardedCountTable.create(mesh, params.k, params.least_depth)
            maxlen, batch = _row_len(params), read_batch_size(table.device)
            local = []
            for fq in my_files:
                for codes in read_code_batches(fq, batch, maxlen, ratio, params.k):
                    span.items += codes.shape[0]
                    with StageTimer("eref.pack", codes.shape[0], unit="rows"):
                        if codes.shape[0] < batch:
                            codes = np.pad(codes, ((0, batch - codes.shape[0]), (0, 0)),
                                           constant_values=4)
                        local.append(pack_codes_mask(codes))
            n_batches = gather_ragged(torch.tensor([len(local)], device=table.device), mesh)
            with StageTimer("eref.pack", batch, unit="rows"):
                pad = pack_codes_mask(np.full((batch, maxlen), 4, dtype=np.uint8))
            local += [pad] * (int(n_batches.max()) - len(local))
            for packed, mask in local:
                with StageTimer("eref.add_packed", batch, unit="rows"):
                    table.add_packed(torch.from_numpy(packed), torch.from_numpy(mask),
                                     index.perm, params.k, local=True)
            _count_sync(table)
        _record_collectives("eref.count_reads.collectives", before)
        hits = search_references(table, index, params)
        if mesh.rank == 0:
            write_ref_names(out_ref_names, hits)
    logger.info("eref (distributed): %d references reported", len(hits))
    return hits
