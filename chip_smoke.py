#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two main paths once on one CUDA card,
its host path from mapped reads to path FASTA, the whole pipeline
that composes them, from one config file to the final phage FASTA, the
scorer's training with checkpoint and resume, and the scorer, its
training, eref and the pipeline across devices.

    python3 chip_smoke.py

The first main path is the scoring stage, contig FASTA → ``node_scores.out``:
each batch's contigs as ragged ASCII bytes → transition-count features
(kernel K1, which drops the non-ACGT bytes on the card) → the GCN
scorer at its published width (``GCNConfig()``), whose SAGE rounds (K2)
and conv head (K3) are CUDA kernels, with the large products in cuBLAS.
The workload is the one the scorer's users run: batches of 512 random
10 kb contigs in bfloat16, weights drawn from a seeded generator.

Phases, each of which must pass:

1. the card's name and power limit, the torch and CUDA versions; the
   port's host C++ sources built with g++ (``native/_build.py``), or
   ``native: unavailable (<compiler message>)``, in which case the host
   phases must have taken their Python routes;
2. the kernels, built from ``palace_tpu_torch/csrc`` with nvcc for sm_90a,
   with the registers, shared memory and spills ptxas reports (none in K3's
   float32 ``conv_tf32_kernel`` and in K4's sharded entries,
   ``SHARDED_ENTRIES``), and K2's and K3's dynamic shared memory and blocks
   an SM in every dtype;
3. each kernel at the main path's shapes against its plain PyTorch
   version on the same inputs (K1 equal; K2 and K3 within
   ``ops.compare.TOLERANCES``), in float32, bfloat16 and float16, with
   its time, its bound, the plain version's time and, for K3, cuDNN's,
   cuBLAS's time for K2's largest product alone (bf16; float32 with TF32
   off and on), K2 float32's three bounds (bytes, its 3×TF32 products,
   all on the CUDA cores) and its error beside the CUDA-core route's it
   replaced, K3 float32's three bounds (its 3×TF32 products, all on the
   CUDA cores, bytes) and cuDNN float32 with TF32 off and on, and each of
   K3's three layers timed alone against its own bound; K3
   in float32, bfloat16 and float16 where its outputs are large, against
   the float64 sums within ``ops.compare.CONV_LARGE_OUTPUTS`` (an einsum
   and cuDNN counted beside it, and one mma chain a tile, which must fall
   outside: in float32 the 3×TF32 chain of ``tests/_tf32.py``, with one
   TF32 product counted too); K3 at the ragged shapes of the card tests
   (``RAGGED_CONV_SHAPES``) against its plain version in every dtype; K1
   on a batch of an assembly's lengths
   (``make_assembly_contigs``: one 1 Mbp contig, a 50 kb (AT)n, 9 kb and
   100-N gaps, log-normal lengths), equal to its plain version, with the tiles
   it ran and its time with one block a row beside it; K1 on rows of
   poly-A, (AT)n and (CAG)n beside random rows; K2 in float32, bfloat16 and
   float16 at a batch of 512 N(0, 1) inputs whose intermediates reach
   4..8, within ``ops.compare.SAGE_LARGE_INTERMEDIATES``, the default
   ``TOLERANCES`` counted beside it, and in float32 also against the
   float64 sums (``sage_sums64``);
4. the slice: ``score_sequences`` over 16 batches of 512 contigs in
   bfloat16, and in float32, each with every launch counter reset just
   before and read just after; then one batch in float32 and in bfloat16
   against the plain versions on the card, and a few contigs against the
   plain path on the CPU;
5. where the time goes: the host's step for a batch beside the 2-bit
   packing it replaced, and device time by kernel over 4 batches from
   torch.profiler, in bfloat16 and in float32;
6. the public names the port exports beside the scorer, on the slice's
   first batch, each with the launch counters reset just before and read
   just after: ``transition_features`` on the batch's ``seq_to_kmer_locs``
   padded (512 × 10,238 codes), ``features_from_codes`` and
   ``features_from_packed``, each one launch of K1's padded-codes entry
   (``kernels.transition_counts``), bit-equal to the byte entry and to the
   plain version; the codes entry on random codes with codes outside
   [0, 64) and n_locs of 0 and L, equal to its plain version;
   ``encode_batch`` and ``encode_sequences`` (the byte entry) bit-equal to
   ``features_from_bytes``; ``phage_probabilities`` at ``GCNConfig()`` in
   float32 (K2 once, K3 three times) within ``PROB_ATOL`` of
   ``score_codes``; the codes entry's time, bound and plain version's time;
7. the eref world of ``benchmarks/phaseb_scale.py:51-83``, replayed call
   for call: 5,000 references of 5-300 kb (357.8 Mbp, seed 7) and 200,000
   reads of 150 bp tiled from the first 100; the port's index build;
8. the eref slice, the second main path: Phase A (``count_reads_into_table``,
   k = 32, a 4 GiB count table, one ``count_codes`` a batch) and Phase B
   (``search_references``, one ``scan_chunk`` a chunk) with the launch
   counters reset just before and
   read just after; every hit a planted reference, and as many hits as
   the JAX package reported on this world (``benchmarks/phaseb_5kref.json``);
   Phase B's peak memory and its host parts (upload, plan, the chunks'
   launches and their offsets check, fetches, verdicts);
9. K4 fused on real chunks: ``scan_chunk`` equal to its plain version on
   every Phase B chunk; its time on the first chunk of each length bucket
   and one with pad rows, beside the parent's route (the torch hashing
   and lookup, then ``good_windows``), the plain version, its byte bound
   and the floor of its table reads; then ``good_windows`` alone on the
   counts and hashes of the same chunks, equal to its plain version;
10. the window and hash names: ``window.good_windows_batch`` on the
   counts and uint32 hashes of phase 9's chunks cut to a length that is not
   a multiple of 8, one ``good_windows`` launch a call, equal to its CPU
   route; ``window.good_windows`` on one reference row;
   ``compute_hashes_for_seq`` on a phagedb reference, the card's equal to
   the CPU's;
11. the per-reference scan, ``good_windows``' path: ``scan_reference`` over
   the planted references with the counters reset just before and read
   just after, the same verdicts as Phase B; then Phase A's kernel on the
   world's batches as the card stages them: ``count_codes`` over every
   batch equal to ``count_codes_plain`` and to the CPU's route
   (``pack_codes_mask``, ``add_packed``), the whole table byte for byte,
   its counters against the nonzero hashes, its time a batch on a fresh
   table, its bound, the plain version's and the CPU route's times, and
   what padding the short last batch costs; then Phase A with the native
   loader: the eref slice read its FASTQ with it and found the 67 hits, its
   batches equal the Python reader's, and Phase A's host seconds split into
   the reader, the staging in one pinned buffer and each batch's upload
   and ``count_codes``;
12. where the time goes: Phase A's host reader apart from a batch's upload
   and ``count_codes`` on the card; Phase B's device time by step and by
   kernel over a few chunks
   (torch.profiler), and its wall time per chunk;
13. the eref slice on a small world (k = 20) through ``run_search`` on the
   card and on the CPU: byte-identical ``ref_names.txt``;
14. the graph world (``make_graph_world``): a virome assembly of 5,000
   contigs and 1,000,000 BAM records with junction evidence, written with
   the port's ``write_bam``;
15. the graph path through the port's CLI: depth → graph → fastg2fa →
   matching → makefa, the native route taken, every planted junction of 5
   good split reads in the graph and none unplanted, the Python builder's
   graph of the same BAM equal to the native one, which solver the
   matching ran, and the seconds of each step;
16. the pipeline world (``make_pipeline_world``): a virome sample after
   SPAdes, 12 planted phages among 3,000 other contigs, its BAM, reads,
   gene hits, a 1,000-reference phagedb and a seeded checkpoint at
   ``GCNConfig()``'s width, made with the port's writers;
17. the pipeline: ``run_pipeline(cfg, device="cuda")`` with every launch
   counter reset just before and read just after: K1 and K2 launched once
   and K3 three times a scoring batch, ``scan_chunk`` once a chunk,
   ``good_windows`` never; ``node_scores.out`` in the assembly's order,
   64 contigs rescored on the CPU through the plain path in float32;
   exactly the planted references; every planted genome in the final
   FASTA; the seconds of each step and stage, the scorer's contigs/s,
   Phase A and B, and the peak device memory;
18. training, after the card is freed: 2,048 contigs of 10 kb with a
   spread of GC shares, labelled 1 above the median, their features
   through K1 (one launch); ``GCNConfig()`` in float32, batch 64,
   dropout 0.2; (a) one step on the card (TF32 switched on globally)
   and on the CPU, the losses within 1e-4 relative and each device's
   gradients held to a float64 step, the card's error at most twice the
   CPU's, the same step with TF32 and no guard outside; (b) ``fit`` for
   two epochs on 1,792 contigs with the launch counters reset just before
   and read just after: no kernel launched, the loss falls; (c) its
   checkpoint saved and restored bit-equal, and a resumed ``fit`` against
   the uninterrupted one under deterministic algorithms; (d) the trained
   parameters through ``score_sequences`` (K1-K3, counted) on the 256
   held-out contigs against the training module's eval forward, and the
   held-out accuracy;
19. where a training step's time goes: ms a step, contigs trained a
   second, and the device time by part (``step_split``), with the peak
   memory and the checkpoint's bytes and seconds;
20. the GCN across devices, one rank: ``parallel.distributed.initialize``
   with world size 1 (NCCL on the card), ``make_mesh``, then
   ``score_sequences(mesh=...)`` over 16 batches of 512 GC-spread 10 kb
   contigs at ``GCNConfig()`` in float32 and bfloat16 (the launch counters
   reset just before and read just after) against the same call without a
   mesh, and one ``train_step`` at batch 64 against the same step without
   one (the loss within 1e-5 relative; the split parameters' gradients as
   exact as the one-rank step's against a float64 step, at most
   ``GRAD_ERR_RATIO`` times its error, as in 16 (a));
21. the GCN across devices, two ranks sharing the one card under gloo
   with their tensors on the card (``torch.multiprocessing.spawn``, a
   ``file://`` store; NCCL will not put two ranks on one card), at
   (data, model) = (2, 1) and (1, 2): on every rank the same scoring
   within 2e-4 (float32) and 2e-2 (bfloat16) of phase 20's one-rank
   probabilities, K1, K2 and K3 launched, one ``train_step`` held to the
   one-rank step as in 18 with the updated shards within Adam's ±lr; under
   (1, 2) a checkpoint written by rank 0 and restored on one rank equal to
   the gathered state; each layout's contigs/s, each rank's peak device
   memory and the collectives' ms a batch, of processes sharing one card
   (not scaling);
22. eref across devices, one rank: a one-rank process group (NCCL on the
   card) and its mesh on phase 7's world, the reads split into two halves
   (``split_reads``); ``run_search(mesh=...)`` with the launch counters
   reset just before and read just after: phase 8's 67 hits and
   ``ref_names.txt``, ``scan_hits`` and ``window_hits`` once a chunk,
   ``hit_filter`` once, ``scan_chunk`` never; then ``hit_filter`` of the
   rank's shard against its plain version, timed with its bound and the
   share of its bits set; ``scan_hits`` and ``window_hits`` against their
   plain versions on the chunks of phase 9, ``window_hits`` against
   ``scan_chunk``, each timed beside ``scan_chunk`` with its bound; and
   ``scan_hits`` at the shard ranges of 2 and 4 ranks (rank 0's and the
   last rank's share, ``SHARD_WORLDS``), equal to its plain version, each
   timed against the bound of its own reads;
23. eref across devices, two ranks sharing the card under gloo at
   (data, model) = (2, 1): ``run_search(mesh=...)`` and
   ``run_search_distributed`` on every rank, phase 8's hits, each rank's
   shard equal to its block of a one-device table, ``ref_names.txt``
   written by rank 0 alone, ``scan_hits``/``window_hits`` launched once a
   chunk and ``hit_filter`` once; Phase A
   and B seconds, the collectives' ms and bytes, each rank's peak memory;
24. the pipeline across devices: ``run_pipeline(cfg, mesh=...)`` on a copy
   of phase 16's world, two ranks sharing the card under gloo at (2, 1):
   the final FASTA byte-identical to phase 17's, ``node_scores.out`` within
   2e-4 of it, K1-K3 and ``scan_hits``/``window_hits`` launched on both
   ranks, each step's seconds;
25. a ``kernels`` JSON line (each kernel at its main path's dtype, and the
    float32 routes of K2 and K3, ``sage_rounds/float32`` and
    ``conv_head/float32``, with their launches from the float32 slice, and
    K1's padded-codes entry, ``transition_counts/codes``, with its launches
    from phase 6),
    then, last, ``{"ok": true, "device": ...}``.

It exits nonzero, printing no result, without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import json
import re
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 512
CONTIG_LEN = 10_000
N_CONTIGS = 16 * BATCH
LONG_CONTIG = 1_000_000  # the longest contig of the assembly-lengths batch
PROB_ATOL = 2e-4        # float32 probabilities, kernels against plain versions
PROB_ATOL_BF16 = 2e-2   # bfloat16 probabilities (inputs and weights rounded to 8 bits)

# the eref world of benchmarks/phaseb_scale.py:51-83 and its k
EREF_SEED = 7
EREF_REFS = 5000
EREF_READS = 200_000
EREF_READ_LEN = 150
EREF_LEN_RANGE = (5_000, 300_000)
EREF_K = 32
#: hits the JAX package reported on this world (benchmarks/phaseb_5kref.json
#: "n_hits"); every step is integer work, so an exact port reports as many
EREF_JAX_HITS = 67
SMALL_K = 20            # the small world run on the card and on the CPU
#: the conv head's input where its outputs are large: N(0, 1) activations
#: and N(0, 0.1) weights put them near 40, beyond the magnitudes
#: ops.compare.TOLERANCES is stated for (ops.compare.CONV_LARGE_OUTPUTS)
ROUNDING_SHAPE = (3, 128, 4096)
#: the conv head's ragged shapes (tests/test_torch_cuda.py
#: test_card_conv_head_close_to_plain): L_out not a multiple of any tile and
#: rows not 16-byte aligned; the smallest, L_out = 1; a first layer of 64
RAGGED_CONV_SHAPES = ((2, 128, 300), (1, 128, 22), (1, 64, 1000))
PROFILE_CHUNKS = 4      # Phase B chunks under the profiler
# the graph path's world (make_graph_world): a virome sample's assembly
GRAPH_CONTIGS = 5000
GRAPH_RECORDS = 1_000_000
GRAPH_SEED = 11

# H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.float16: 989e12}
PEAK_TF32_OPS_PER_S = 495e12  # the tensor cores on TF32 operands (K2's, K3's float32 routes)
#: 1-byte reads at random addresses of a 4 GiB table, as the H100 80GB HBM3
#: at 700 W gives them (measured for K4's ``scan_hits``, PERF.md's kernel table)
RANDOM_READS_PER_S = 30.6e9
#: K2's float32 route before the tensor cores (the CUDA-core kernel that
#: ``sage_tf32_kernel`` replaced) on the inputs that
#: ``Smoke.kernels_at_main_shapes`` ("slice") and ``Smoke.sage_rounding``
#: ("large") give it: max |error| against the plain version and against the
#: float64 sums, from ``palace_tpu_torch/tools/k2_float32.py ab`` on that
#: tree (H100 80GB HBM3, 700.00 W)
CUDA_CORE_K2_FLOAT32_ERR = {
    "slice": {"plain": 1.430511474609375e-06, "float64": 2.28129917623221e-06},
    "large": {"plain": 1.430511474609375e-06, "float64": 2.007155865513255e-06}}

KERNELS = {  # name → (CUDA source, the Pallas call it replaces)
    "transition_counts": ("palace_tpu_torch/csrc/transition_counts.cu",
                          "palace_tpu/ops/pallas_kernels.py:154"),
    "sage_rounds": ("palace_tpu_torch/csrc/sage_rounds.cu",
                    "palace_tpu/ops/pallas_kernels.py:462"),
    "conv_head": ("palace_tpu_torch/csrc/conv_head.cu",
                  "palace_tpu/ops/pallas_kernels.py:324"),
    "good_windows": ("palace_tpu_torch/csrc/good_windows.cu",
                     "palace_tpu/ops/pallas_kernels.py:252"),
    "scan_chunk": ("palace_tpu_torch/csrc/good_windows.cu",
                   "palace_tpu/ops/pallas_kernels.py:252"),
    "scan_hits": ("palace_tpu_torch/csrc/good_windows.cu",
                  "palace_tpu/ops/pallas_kernels.py:252"),
    "window_hits": ("palace_tpu_torch/csrc/good_windows.cu",
                    "palace_tpu/ops/pallas_kernels.py:252"),
    "hit_filter": ("palace_tpu_torch/csrc/good_windows.cu",
                   "palace_tpu/ops/pallas_kernels.py:252"),
    # no Pallas call: the JAX package's Phase A counts with XLA's sort and scatter
    "count_codes": ("palace_tpu_torch/csrc/count_codes.cu",
                    "palace_tpu/ops/count_table.py:369"),
}
SCORING_KERNELS = ("transition_counts", "sage_rounds", "conv_head")
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}
LAYOUT = {True: "(B,C,L)", False: "(B,L,C)"}  # channel-major, channel-last


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card, from CUDA events around
    ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, ops: float, dtype: torch.dtype) -> tuple:
    """The least time the card could take: bytes over memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32_bound(nbytes: int, ops: float) -> tuple:
    """``bound`` for a 3×TF32 route: its products, three times the
    operations, at the TF32 rate, or the bytes, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * ops / PEAK_TF32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k1_bound(data, offsets, seq_lens, feats) -> tuple:
    """K1's bound on these rows: its inputs read and its features written
    once; its operations, the pairs counted, at the float32 rate (the data
    sheet has no integer rate)."""
    from palace_tpu_torch.ops.encoder import BASE_LUT, INVALID

    lut = torch.from_numpy(BASE_LUT).to(data.device)
    row = torch.repeat_interleave(torch.arange(seq_lens.numel(), device=data.device),
                                  offsets.diff())
    n_codes = torch.bincount(row[lut[data.long()] != INVALID], minlength=seq_lens.numel())
    pairs = float(sum(torch.clamp(n_codes - 5 - d, min=0).sum() for d in range(3)))
    return bound(nbytes(data, offsets, seq_lens, feats), pairs, torch.float32)


def k1_tiles(offsets, tile: int) -> int:
    """The tiles (blocks that count) K1 runs on these rows: a row of len
    bytes has max(1, ceil(len / tile))."""
    lens = offsets.diff()
    return int(torch.where(lens > tile, (lens + tile - 1) // tile, 1).sum())


#: Phase B's host parts in the port's GLOBAL_METRICS (search/eref.py)
HOST_PARTS = ("eref.upload", "eref.plan", "eref.scan", "eref.scan_check", "eref.scan_fetch",
              "eref.verdicts")
#: scan_chunk's integer operations a position: about 40 to hash, 10 to window
SCAN_OPS = 50


def host_parts() -> dict:
    """Milliseconds so far of Phase B's host parts (``HOST_PARTS``)."""
    from palace_tpu_torch.utils.timers import GLOBAL_METRICS

    stages = GLOBAL_METRICS.stages
    return {n: stages[n].seconds * 1e3 if n in stages else 0.0 for n in HOST_PARTS}


def host_parts_line(parts: dict) -> str:
    """``HOST_PARTS``' milliseconds by name: the upload, the plan, the
    chunks' launches (``eref.scan``, which holds the wrapper's synchronizing
    offsets check, ``eref.scan_check``), the fetches and the verdicts."""
    return ", ".join(f"{n} {parts[n]:.2f} ms" for n in HOST_PARTS)


def scan_bound(positions: int, rows: int, table_reads: int) -> tuple:
    """scan_chunk's bound: each input byte read once (packed codes and
    invalid bits, 0.375 B a position; the offsets, 24 B a row; a byte of
    table a read) and its flags written once (0.125 B a position); its
    integer operations (``SCAN_OPS`` a position) at the float32 rate, the
    data sheet having no int32 rate."""
    nbytes = positions * 3 // 8 + 24 * rows + table_reads + positions // 8
    return bound(nbytes, SCAN_OPS * positions, torch.float32)


def gather_floor_ms(table_reads: int) -> float:
    """The floor of scan_chunk's table reads: each at a random address of
    a table no cache holds, so a 32-byte sector from device memory."""
    return table_reads * 32 / HBM_BYTES_PER_S * 1e3


def picked_chunks(chunks: list) -> list:
    """The Phase B chunks K4 is timed on: the first of each length bucket,
    and one with pad rows."""
    picked, seen = [], set()
    for c in chunks:
        if c[0] not in seen:
            seen.add(c[0])
            picked.append(c)
    if not any(len(refs) < rows for _, refs, rows in picked):
        picked += [c for c in chunks if len(c[1]) < c[2]][:1]
    return picked


def make_assembly_contigs(n: int, seed: int) -> list:
    """``n`` contigs drawn as a metaSPAdes ``contigs.fasta`` holds them:
    one of ``LONG_CONTIG`` bases, one 50 kb low-complexity contig
    ((AT)n), two scaffolds with gaps longer than K1's 8 KiB chunk (9,000
    N then 5,000 bases; 40 kb with 9,000 n from byte 16,384, a tile
    edge), and ``n - 4`` of log-normal lengths (median 2 kb, sigma 1,
    clipped to 500-500,000); every tenth of those has a scaffold gap of
    100 N.  Sorted longest first, as metaSPAdes writes them."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    def bases(count):
        return bytes(lut[rng.integers(0, 4, int(count), dtype=np.uint8)]).decode()

    lengths = np.clip(rng.lognormal(np.log(2000), 1.0, n - 4), 500, 500_000).astype(int)
    seqs = [bases(LONG_CONTIG), "AT" * 25_000, "N" * 9000 + bases(5000),
            bases(16_384) + "n" * 9000 + bases(40_000 - 25_384)]
    for i, n_bases in enumerate(lengths):
        s = bases(n_bases)
        if i % 10 == 0:
            gap = int(rng.integers(0, n_bases - 100))
            s = s[:gap] + "N" * 100 + s[gap + 100:]
        seqs.append(s)
    seqs.sort(key=len, reverse=True)
    return [(f"NODE_{i + 1}_length_{len(s)}", s) for i, s in enumerate(seqs)]


def conv_smem_bytes(channels: int, in_channel_major: bool) -> int:
    """The 16-bit conv kernel's dynamic shared memory: the layer's weights
    [tap][out][channel + 8], a tile of 136 rows [position][channel + 8],
    and a second tile or, for a channel-major input, the raw tile."""
    pitch = channels + 8
    weights, tile = 8 * 64 * pitch * 2, 136 * pitch * 2
    return weights + tile + (channels * 136 * 2 if in_channel_major else tile)


def conv_f32_smem_bytes() -> int:
    """The float32 conv kernel's dynamic shared memory: two ring stages,
    each a slice's weights (8 taps × 2 k8 steps × 64 outputs × 8 channels,
    big and small) and 264 input rows of 32 words, then the next slice's
    input as copied, 16 channels × 264 floats."""
    return 4 * (2 * (2 * 8 * 2 * 64 * 8 + 264 * 32) + 16 * 264)


def sage_f32_smem_bytes() -> int:
    """The float32 SAGE kernel's dynamic shared memory: the row's 4096 × 3
    inputs, two 64-row tiles of big and small planes and one float32 tile,
    each [row][channel + 8] of 32-bit words, 14 float rows of 128 and the
    f-nodes' 64 × 3 inputs."""
    return 4 * (4096 * 3 + 5 * 64 * (128 + 8) + 14 * 128 + 64 * 3)


def sage_smem_bytes() -> int:
    """The 16-bit SAGE kernel's dynamic shared memory: a 128 × 128 weight
    and three 64-row tiles as [row][channel + 8], lift1 (64 × 128), all
    16-bit; 14 float rows of 128 and the f-nodes' 64 × 3 float inputs."""
    pitch = 128 + 8
    return 2 * (128 * pitch + 3 * 64 * pitch + 64 * 128) + 4 * (14 * 128 + 64 * 3)


def init_scale_conv_inputs(shape, dtype, device):
    """The conv head's input at the scale ``init_params`` gives its
    weights, U(±1/sqrt(C·8)), where the outputs stay of order 1: N(0, 1)
    activations, from seed 4."""
    B, C0, L = shape
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (B, C0, L)).astype(np.float32)).to(device, dtype)
    ws = [torch.from_numpy(rng.uniform(-1, 1, (64, c, 8)).astype(np.float32) / np.sqrt(c * 8))
          .to(device, dtype) for c in (C0, 64, 64)]
    bs = [torch.from_numpy(rng.uniform(-1, 1, 64).astype(np.float32) / np.sqrt(c * 8))
          .to(device, dtype) for c in (C0, 64, 64)]
    return x, ws, bs


def large_conv_inputs(shape, dtype, device):
    """The conv head's input where its outputs are large (near 40): N(0, 1)
    activations, N(0, 0.1) weights and biases, from seed 4."""
    B, C0, L = shape
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (B, C0, L)).astype(np.float32)).to(device, dtype)
    ws = [torch.from_numpy(rng.normal(0, 0.1, (64, c, 8)).astype(np.float32)).to(device, dtype)
          for c in (C0, 64, 64)]
    bs = [torch.from_numpy(rng.normal(0, 0.1, 64).astype(np.float32)).to(device, dtype)
          for _ in range(3)]
    return x, ws, bs


SAGE_ROUNDING_BATCH = 512  # a batch of the card test's N(0, 1) inputs


def large_sage_inputs(batch: int, dtype, device):
    """K2's inputs where its rounded intermediates reach 4..8: the
    parameters and N(0, 1) inputs of ``tests/test_torch_cuda.py``'s
    ``test_card_sage_rounds_close_to_plain`` (seed 3), at ``batch`` rows."""
    from palace_tpu_torch.models import gcn

    g = torch.Generator(device="cpu").manual_seed(3)
    p = gcn.init_params(g)
    p["ln.scale"] = 1 + 0.2 * torch.randn(128, generator=g)
    p["ln.bias"] = 0.2 * torch.randn(128, generator=g)
    xp = torch.randn(batch, 4096, 3, generator=g).to(device, dtype)
    xf = torch.randn(batch, 64, 3, generator=g).to(device, dtype)
    return xp, xf, gcn.sage_weight_stack(p, dtype).to(device)


def sage_peak(xp, xf, w) -> float:
    """The largest magnitude among K2's rounded intermediates, in float32:
    round 1's p- and f-node activations and their LayerNorm, round 2's lift
    and product, and the output."""
    from palace_tpu_torch.ops import kernels

    xp, xf, w = xp.float(), xf.float(), w.float()
    B, f = xp.shape[0], xf.shape[1]
    Wr1, Wl1, Wr2f, Wl2, Wl11, Wr11, b1, b2, b11, ln_s, ln_b = kernels._unstack(w, xp.shape[2])
    lifted1 = xf @ Wl1 + b1
    xp1 = torch.relu(lifted1[:, :, None] + (xp @ Wr1).reshape(B, f, -1, w.shape[1]))
    xf1 = torch.relu(xp1.mean(dim=2) @ Wl2 + b2 + xf @ Wr2f)
    xp1 = xp1.reshape(B, -1, w.shape[1])
    xp1n = kernels._layer_norm_f32(xp1, ln_s, ln_b)
    lifted2 = kernels._layer_norm_f32(xf1, ln_s, ln_b) @ Wl11 + b11
    prod = xp1n @ Wr11
    out = torch.relu(lifted2[:, :, None] + prod.reshape(B, f, -1, w.shape[1]))
    return max(float(t.abs().max()) for t in (lifted1, xp1, xf1, xp1n, lifted2, prod, out))


def sage_sums64(xp, xf, w) -> torch.Tensor:
    """K2's function (``kernels.sage_rounds_plain``'s chain) with every
    product, sum and LayerNorm in float64."""
    from palace_tpu_torch.ops import kernels

    xp, xf, w = xp.double(), xf.double(), w.double()
    B, pn, d3 = xp.shape
    f = xf.shape[1]
    rep = pn // f
    Wr1, Wl1, Wr2f, Wl2, Wl11, Wr11, b1, b2, b11, ln_s, ln_b = kernels._unstack(w, d3)

    def ln(x):
        mu = x.mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5) * ln_s + ln_b

    x_p1 = torch.relu((xf @ Wl1 + b1).repeat_interleave(rep, dim=1) + xp @ Wr1)
    x_f1 = torch.relu(x_p1.reshape(B, rep, f, -1).mean(dim=1) @ Wl2 + b2 + xf @ Wr2f)
    lifted2 = ln(x_f1) @ Wl11 + b11
    return torch.relu(lifted2.repeat_interleave(rep, dim=1) + ln(x_p1) @ Wr11)


def sage_f32_bounds(x_p, x_f, w, out) -> dict:
    """K2's float32 bounds in ms: the bytes (inputs read and output written
    once), the 3×TF32 route's 128-deep products (three times their
    operations at the TF32 rate), and all the operations on the CUDA cores
    at the float32 rate."""
    B, pn, d3 = x_p.shape
    f, gd = x_f.shape[1], w.shape[1]
    deep = 2.0 * B * gd * (2 * f * gd + pn * gd)
    ops = deep + 2.0 * B * gd * (pn * d3 + 2 * f * d3)
    return dict(bytes=nbytes(x_p, x_f, w, out) / HBM_BYTES_PER_S * 1e3,
                tf32=3 * deep / PEAK_TF32_OPS_PER_S * 1e3,
                cuda_cores=ops / PEAK_OPS_PER_S[torch.float32] * 1e3)


def conv_f32_bounds(x, weights, biases, y) -> dict:
    """K3's float32 bounds in ms: the 3×TF32 route's products (three times
    the operations at the TF32 rate), all the operations on the CUDA cores
    at the float32 rate, the function's bytes (input, weights and biases
    read, output written once) and the bytes of its three launches (each
    layer's input and weights read and output written once)."""
    B, L, ops, layers, x_bytes = x.shape[0], x.shape[2], 0.0, nbytes(*weights, *biases), nbytes(x)
    for w in weights:
        L -= w.shape[2] - 1
        ops += 2.0 * B * w.shape[0] * w.shape[1] * w.shape[2] * L
        out_bytes = B * w.shape[0] * L * x.element_size()
        layers, x_bytes = layers + x_bytes + out_bytes, out_bytes
    return dict(tf32=3 * ops / PEAK_TF32_OPS_PER_S * 1e3,
                cuda_cores=ops / PEAK_OPS_PER_S[torch.float32] * 1e3,
                bytes=nbytes(x, *weights, *biases, y) / HBM_BYTES_PER_S * 1e3,
                layer_bytes=layers / HBM_BYTES_PER_S * 1e3)


def tf32_emulation():
    """``tests/_tf32.py``: the 3×TF32 arithmetic of the kernels' float32
    routes emulated in plain torch (the conv head's one chain a tile and
    one TF32 product are the controls of ``Smoke.conv_rounding``)."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import _tf32

    return _tf32


def conv_sums(x, weights, biases, acc_dtype):
    """The conv head with every layer's sums taken in ``acc_dtype``, each
    layer rounded to the working dtype."""
    for w, b in zip(weights, biases):
        u = x.to(acc_dtype).unfold(2, w.shape[2], 1)  # (B, C, L_out, K)
        z = torch.einsum("bclk,ock->bol", u, w.to(acc_dtype)) + b.to(acc_dtype)[None, :, None]
        x = torch.relu(z).to(w.dtype)
    return x


def one_mma_chain(x, weights, biases):
    """The conv head summed as one chain of mma a tile: each 16 products
    exact, added into the float32 chain rounding toward zero."""
    for w, b in zip(weights, biases):
        C, L_out = x.shape[1], x.shape[2] - w.shape[2] + 1
        xd, wd, acc = x.double(), w.double(), None
        for c16 in range(C // 16):
            ch = slice(16 * c16, 16 * c16 + 16)
            for k in range(w.shape[2]):
                s = torch.einsum("bcl,oc->bol", xd[:, ch, k:k + L_out], wd[:, ch, k])
                s = s if acc is None else acc.double() + s
                acc = s.float()
                acc = torch.where(acc.double().abs() > s.abs(),
                                  torch.nextafter(acc, torch.zeros_like(acc)), acc)
        x = torch.relu(acc + b.float()[None, :, None]).to(w.dtype)
    return x


def kernel_name(mangled: str) -> str | None:
    """The name of a kernel in an anonymous namespace from its mangled
    name, ``_ZN<n><namespace><m><name>...``."""
    ns = re.match(r"_ZN(\d+)_GLOBAL__N", mangled)
    if not ns:
        return None
    rest = mangled[ns.start(1) + len(ns.group(1)) + int(ns.group(1)):]
    n = re.match(r"\d+", rest)
    return rest[n.end():n.end() + int(n.group())] if n else None


def ptxas_summary(log: str) -> list:
    """ptxas -v output → one line per compiled entry: its working dtype
    (and, for K3's tensor-core variants, the input channels and the input
    and output layouts), registers, shared memory and spills."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = ("bf16" if "bfloat16" in name else "f16" if "__half" in name
                     else "f32" if "IfE" in name else "-")
            if entry == "-":  # no dtype: the kernel's own name
                entry = kernel_name(name) or entry
            conv = re.search(r"Li(\d+)ELb([01])ELb([01])E", name)
            if conv:
                c, i, o = conv.groups()
                entry += f" C={c} {LAYOUT[i == '1']}->{LAYOUT[o == '1']}"
        elif entry and ("spill" in line or "Used" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return out


def make_contigs(n: int, length: int, seed: int, gc_spread: bool = False) -> list:
    """``n`` random ACGT contigs of ``length`` bases, named contig_<i>:
    uniform bases, or with ``gc_spread`` a GC share running from 0.15 to
    0.85 over the contigs, so that their features and scores differ."""
    rng = np.random.default_rng(seed)
    if gc_spread:
        gc = np.linspace(0.15, 0.85, n)[:, None]
        u = rng.random((n, length))
        # A below (1-gc)/2, C and G in the middle gc, T above (1+gc)/2
        base = ((u >= (1 - gc) / 2).astype(np.int8) + (u >= 0.5) + (u >= (1 + gc) / 2))
    else:
        base = rng.integers(0, 4, size=(n, length), dtype=np.int8)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [(f"contig_{i}", bytes(lut[row]).decode()) for i, row in enumerate(base)]


def make_eref_world(tmp: Path, n_refs: int, n_reads: int, len_range: tuple | None = None):
    """The phagedb and reads of benchmarks/phaseb_scale.py:51-83, with the
    same ``default_rng(EREF_SEED)`` draws in the same order: log-uniform
    reference lengths in ``len_range`` (EREF_LEN_RANGE when unset),
    uniform bases, then ``n_reads`` reads of EREF_READ_LEN bp tiled from
    the first ``n_refs // 50`` references, taken in the order of their
    sorted names.  Returns (db.fasta, reads.fastq, planted reference
    count)."""
    len_range = EREF_LEN_RANGE if len_range is None else len_range
    read_len = EREF_READ_LEN
    rng = np.random.default_rng(EREF_SEED)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    lengths = np.exp(rng.uniform(np.log(len_range[0]), np.log(len_range[1]),
                                 n_refs)).astype(np.int64)
    n_plantable = max(1, n_refs // 50)
    db, seqs = tmp / "db.fasta", {}
    with open(db, "w") as fh:
        for i, L in enumerate(lengths):
            seq = bytes(lut[rng.integers(0, 4, int(L), dtype=np.uint8)]).decode()
            fh.write(f">ref{i + 1}\n" + seq + "\n")
            if i < n_plantable:
                seqs[f"ref{i + 1}"] = seq
    planted = rng.integers(0, n_plantable, n_reads)
    want = {f"ref{i + 1}" for i in set(int(x) for x in planted)}
    keys = sorted(k for k in seqs if k in want)
    fq = tmp / "reads.fastq"
    with open(fq, "w") as f:
        for i in range(n_reads):
            s = seqs[keys[i % len(keys)]]
            st = int(rng.integers(0, max(1, len(s) - read_len)))
            f.write(f"@r{i}\n{s[st:st + read_len]}\n+\n{'I' * read_len}\n")
    return db, fq, len(want)


def _flip(o: str) -> str:
    return "-" if o == "+" else "+"


def canonical_junction(a: str, oa: str, b: str, ob: str) -> tuple:
    """A junction as the graph builder keys it: the smaller name first,
    the orientations flipped and swapped with the names."""
    return (a, oa, b, ob) if a <= b else (b, _flip(ob), a, _flip(oa))


def make_graph_world(tmp: Path, n_contigs: int = 5000, n_records: int = 1_000_000,
                     seed: int = SEED) -> dict:
    """A metaSPAdes assembly of a virome sample and its reads mapped back,
    as the graph stage takes them: ``n_contigs`` contigs of log-normal
    lengths (median 1.5 kb, sigma 0.8, clipped to 500-60,000) and coverage,
    chained in genomes of 1-8 contigs, half of them circular; a FASTG with
    both strands of each contig and 70 % of the junctions as links, and its
    ``.fai``; a coordinate-sorted BAM of ``n_records`` records written with
    the port's ``write_bam``: per junction 1-30 split reads across it (SA
    tags, NM 0-7) and 0-15 discordant pairs in FR layout where both ends
    are forward, then 150 bp reads, paired or not, over the contigs by
    length × coverage, with secondary, duplicate, unmapped, clipped and
    low-quality ones among them.  Returns the paths, the sizes and the
    junctions: ``strong`` (≥ 5 split reads of NM ≤ 5, which the graph must
    hold) and ``planted`` (every junction the graph may hold)."""
    from palace_tpu_torch.io.bam import (
        FLAG_DUP,
        FLAG_MREVERSE,
        FLAG_PAIRED,
        FLAG_REVERSE,
        FLAG_SECONDARY,
        FLAG_UNMAP,
        BamFile,
        BamRecord,
        write_bam,
    )
    from palace_tpu_torch.io.fasta import build_fai, reverse_complement

    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    lens = np.clip(rng.lognormal(np.log(1500), 0.8, n_contigs), 500, 60_000).astype(int)
    covs = np.round(rng.lognormal(np.log(8), 1.0, n_contigs), 1)
    names = [f"EDGE_{i + 1}_length_{L}_cov_{c}" for i, (L, c) in enumerate(zip(lens, covs))]
    junctions, i = [], 0
    while i < n_contigs:
        members = list(range(i, min(n_contigs, i + int(rng.integers(1, 9)))))
        orient = ["+" if o else "-" for o in rng.integers(0, 2, len(members))]
        links = list(zip(members, orient, members[1:], orient[1:]))
        if len(members) > 1 and rng.random() < 0.5:
            links.append((members[-1], orient[-1], members[0], orient[0]))
        junctions += links
        i += len(members)

    records, strong, planted = [], set(), set()
    in_fastg = rng.random(len(junctions)) < 0.7

    def end_pos(L):  # a 75 bp piece in the END region: pos1 > max(L - 300, L // 2)
        return int(rng.integers(max(L - 300, L // 2) + 1, L - 74 + 1))

    def start_pos(L):  # pos1 <= min(300, L // 2)
        return int(rng.integers(1, min(300, L // 2) + 1))

    for j, (a, oa, b, ob) in enumerate(junctions):
        planted.add(canonical_junction(names[a], oa, names[b], ob))
        nms = rng.choice(8, int(rng.integers(1, 31)), p=[.4, .2, .1, .1, .05, .05, .05, .05])
        if int((nms <= 5).sum()) >= 5:
            strong.add(canonical_junction(names[a], oa, names[b], ob))
        for k, nm in enumerate(nms):
            # the four layouts of tests/test_graph_golden_cpp.py, halves of 75
            pa = end_pos(lens[a]) if oa == "+" else start_pos(lens[a])
            pb = start_pos(lens[b]) if ob == "+" else end_pos(lens[b])
            cig = [(75, "M"), (75, "S")] if oa == "+" else [(75, "S"), (75, "M")]
            sa_cig = "75S75M" if ob == "+" else "75M75S"
            records.append(BamRecord(f"j{j}s{k}", 0 if oa == "+" else FLAG_REVERSE, a, pa - 1,
                                     60, cig, -1, -1, 0, 150,
                                     {"NM": int(nm), "SA": f"{names[b]},{pb},{ob},{sa_cig},60,"
                                                           f"{int(nm)};"}))
        if oa == "+" and ob == "+":
            for k in range(int(rng.integers(0, 16))):
                pa, pb = int(rng.integers(lens[a] - 299, lens[a] - 149)), start_pos(lens[b])
                records.append(BamRecord(f"j{j}p{k}", FLAG_PAIRED | FLAG_MREVERSE, a, pa - 1, 60,
                                         [(150, "M")], b, pb - 1, 0, 150, {"NM": 0}))
                records.append(BamRecord(f"j{j}p{k}", FLAG_PAIRED | FLAG_REVERSE, b, pb - 1, 60,
                                         [(150, "M")], a, pa - 1, 0, 150, {"NM": 0}))

    n_cov = max(0, n_records - len(records))
    weight = lens * covs
    tids = rng.choice(n_contigs, n_cov, p=weight / weight.sum())
    pos0 = (rng.random(n_cov) * np.maximum(lens[tids] - 150, 1)).astype(int)
    kind = rng.random(n_cov)
    nms = rng.choice(8, n_cov, p=[.5, .2, .1, .1, .04, .03, .02, .01])
    mapqs = rng.integers(0, 61, n_cov)
    for r in range(0, n_cov - 1, 2):
        t, p, k = int(tids[r]), int(pos0[r]), kind[r]
        tags = {"NM": int(nms[r])}
        if k < 0.5:  # a concordant pair on one contig
            mp = int(min(p + 200, max(lens[t] - 150, 0)))
            records.append(BamRecord(f"c{r}", FLAG_PAIRED | FLAG_MREVERSE, t, p, int(mapqs[r]),
                                     [(150, "M")], t, mp, 350, 150, tags))
            records.append(BamRecord(f"c{r}", FLAG_PAIRED | FLAG_REVERSE, t, mp, int(mapqs[r]),
                                     [(150, "M")], t, p, -350, 150, dict(tags)))
            continue
        flag = (FLAG_SECONDARY if k < 0.52 else FLAG_DUP if k < 0.53 else
                FLAG_REVERSE if k < 0.75 else 0)
        cig = [(150, "M")] if k < 0.9 else [(20, "S"), (100, "M"), (2, "D"), (30, "M")]
        for q in (r, r + 1):
            records.append(BamRecord(f"u{q}", flag, int(tids[q]), int(pos0[q]), int(mapqs[q]),
                                     cig, -1, -1, 0, 150, {"NM": int(nms[q])}))
    records.sort(key=lambda rec: (rec.tid, rec.pos))
    records += [BamRecord(f"x{q}", FLAG_UNMAP, -1, -1, 0, [], -1, -1, 0, 150, {})
                for q in range(max(0, n_records - len(records)))]

    fastg = tmp / "assembly_graph.fastg"
    out_links = {i: [] for i in range(n_contigs)}
    for (a, oa, b, ob), keep in zip(junctions, in_fastg):
        if keep:  # a link from a's strand oa to b's strand ob (io/fastg.py parse_fastg_pairs)
            out_links[a].append((oa, names[b] + ("" if ob == oa else "'")))
    with open(fastg, "w") as fh:
        for i, (name, L) in enumerate(zip(names, lens)):
            seq = bytes(lut[rng.integers(0, 4, int(L), dtype=np.uint8)]).decode()
            for strand, s in (("+", seq), ("-", reverse_complement(seq))):
                links = ",".join(t for o, t in out_links[i] if o == strand)
                head = name + ("'" if strand == "-" else "")
                fh.write(f">{head}{':' + links if links else ''};\n{s}\n")
    fai = tmp / "assembly_graph.fastg.fai"
    build_fai(fastg, fai)
    bam = tmp / "reads.sorted.bam"
    write_bam(bam, BamFile(references=list(zip(names, map(int, lens))), records=records))
    return dict(bam=bam, fastg=fastg, fai=fai, n_records=len(records), n_contigs=n_contigs,
                total_bp=int(lens.sum()), n_junctions=len(junctions), strong=strong,
                planted=planted)


def run_graph_path(main, world: dict, out: Path, single: bool = True) -> dict:
    """graph → depth → fastg2fa → matching → makefa through a CLI's ``main``
    (the port's; the tests also pass the JAX package's), as the pipeline
    runs them: the depth first, whose mean over covered positions is the
    graph's ``--avg-depth`` (palace:541-544); matching in the global graph's
    mode (``-s``) unless ``single`` is False; the linear and cycle paths
    into one FASTA (mode 0).  Returns the seconds of each step and the
    average depth."""
    secs = {}

    def step(name, argv):
        t0 = time.perf_counter()
        rc = main([str(a) for a in argv])
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"{name} exited {rc}")

    step("depth", ["depth", world["bam"], out / "depth.txt"])
    t0 = time.perf_counter()
    col = np.loadtxt(out / "depth.txt", usecols=2, dtype=np.int64, delimiter="\t", ndmin=1)
    avg = float(col.sum()) / col.size if col.size else 0.0
    secs["avg_depth"] = time.perf_counter() - t0
    step("graph", ["graph", world["bam"], world["fai"], out / "graph.txt", "--avg-depth", avg])
    step("fastg2fa", ["fastg2fa", world["fastg"], out / "nodes.fa"])
    step("matching", ["matching", "-g", out / "graph.txt", "-r", out / "linear.txt",
                      "-c", out / "cycle.txt", "-i", "10"] + (["-s"] if single else []))
    (out / "paths.txt").write_text((out / "linear.txt").read_text()
                                   + (out / "cycle.txt").read_text())
    step("makefa", ["makefa", out / "nodes.fa", out / "paths.txt", out / "paths.fa",
                    "--mode", "0"])
    return dict(seconds=secs, avg_depth=avg)


def graph_junctions(path: Path) -> set:
    """The (left, orient, right, orient) keys of a graph file's JUNC lines."""
    out = set()
    for line in path.read_text().splitlines():
        f = line.split()
        if f and f[0] == "JUNC":
            out.add(tuple(f[1:5]))
    return out


def make_small_eref_world(tmp: Path, seed: int = SEED):
    """40 random references of 3-20 kb; paired reads of 100 bp tiled three
    times (offsets 0, 3, 7, every 10 bp) from references 3, 10 and 31."""
    from palace_tpu_torch.io.fasta import reverse_complement, write_fasta

    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [(f"phage{i + 1}", bytes(lut[rng.integers(0, 4, int(n))]).decode())
            for i, n in enumerate(rng.integers(3000, 20000, 40))]
    write_fasta(tmp / "small_db.fasta", refs)
    reads = [refs[r][1][off + i: off + i + 100] for r in (2, 9, 30) for off in (0, 3, 7)
             for i in range(0, len(refs[r][1]) - off - 100, 10)]
    for name, rs in (("small_1.fastq", reads),
                     ("small_2.fastq", [reverse_complement(r) for r in reads])):
        with open(tmp / name, "w") as fh:
            for i, r in enumerate(rs):
                fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return tmp / "small_db.fasta", tmp / "small_1.fastq", tmp / "small_2.fastq"


PIPELINE_SEED = 13
PIPELINE_PHAGES = 12
PIPELINE_OTHERS = 3000
PIPELINE_DECOYS = 988
PIPELINE_PREFIX = "virome"
PIPELINE_KEYS: dict = {}  # config keys beside the demo's; none: every default
PIPELINE_RESCORED = 64   # contigs rescored on the CPU through the plain path
PHAGE_DEPTH, OTHER_DEPTH, BAM_DEPTH = 30, 5, 5
READ_LEN, FRAGMENT = 150, 350
SPLIT_READS = 6          # split reads a planted junction (MIN_COUNT is 5)


TRAIN_SEED = 17
TRAIN_CONTIGS = 2048
TRAIN_HELD_OUT = 256     # 1,792 to train on: 28 batches of 64 an epoch
TRAIN_BATCH = 64
TRAIN_EPOCHS = 2
TRAIN_LR = 1e-4
TRAIN_TIMED_STEPS = 10
TRAIN_PROFILED_STEPS = 3
TRAIN_LOSS_RTOL = 1e-4   # one step on the card against the CPU
GRAD_ERR_RATIO = 2.0     # the card's gradient error from float64 against the CPU's
RESUME_RTOL = 1e-5       # a resumed fit against the uninterrupted one
TRAIN_PARTS = ("gcn.lift", "gcn.sage", "gcn.conv", "gcn.fc")  # train_forward's ranges


def train_cfg():
    """The model the training phase trains: ``GCNConfig()`` at its
    published width, dropout 0.2."""
    from palace_tpu_torch.models.gcn import GCNConfig

    return GCNConfig()


def train_features(seqs: list, device: torch.device) -> torch.Tensor:
    """The contigs' features through K1 on ``device``, as the scorer makes
    them (``features_from_bytes`` of their ``byte_batch``)."""
    from palace_tpu_torch.ops.encoder import byte_batch, features_from_bytes

    return features_from_bytes(*[t.to(device) for t in byte_batch(seqs)])


def cuda_times_ms(fn, iters: int, warmup: int = 3) -> list:
    """Milliseconds of each of ``iters`` calls of ``fn`` on the card, from
    CUDA events around each, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def step_split(events, attr: str = "self_device_time_total") -> dict:
    """One training step's time by part, in ms, from torch.profiler's
    events: an op's own time (``attr``: its kernels' device time) goes to
    the ``TRAIN_PARTS`` range around it (``<part> fwd``); a backward op's
    to the range of the forward op whose ``sequence_nr`` its autograd node
    carries (``<part> bwd``); Adam's to ``adam``; the rest (the loss, the
    gradients' zeroing) to ``other fwd`` / ``other bwd``."""
    def part(e):
        while e is not None:
            if e.name in TRAIN_PARTS:
                return e.name
            if e.name.startswith("Optimizer.step"):
                return "adam"
            e = e.cpu_parent
        return None

    def node(e):
        while e is not None:
            if e.name.startswith("autograd::engine::evaluate_function"):
                return e
            e = e.cpu_parent
        return None

    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    forward = {}
    for e in cpu:
        if e.sequence_nr >= 0 and node(e) is None and part(e) is not None:
            forward.setdefault(e.sequence_nr, part(e))
    out: dict = {}
    for e in cpu:
        t = getattr(e, attr)
        if not t or e.name in TRAIN_PARTS:
            continue
        n = node(e)
        if n is not None:
            key = f"{forward.get(n.sequence_nr, 'other')} bwd"
        else:
            key = part(e) or "other"
            key = key if key == "adam" else f"{key} fwd"
        out[key] = out.get(key, 0.0) + t / 1e3
    return out


def set_tf32(on: bool) -> None:
    """The global TF32 flags of cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def reference_state_dict(params: dict, cfg) -> dict:
    """The port's parameters under the reference checkpoint's key names and
    layouts (``GCN_model_retrained.pt``): the inverse of
    ``models.gcn.params_from_numpy_state``."""
    t = {name: params[name].detach().cpu() for name in params}
    state = {}
    for name in ("pnode_d", "fnode_d", "d1", "d2"):
        state[f"{name}.weight"] = t[f"{name}.w"].T.contiguous()
        state[f"{name}.bias"] = t[f"{name}.b"]
    for i in range(cfg.num_layers):
        for tag in ("convs_1", "convs_2"):
            state[f"{tag}.{i}.lin_l.weight"] = t[f"{tag}.{i}.lin_l.w"].T.contiguous()
            state[f"{tag}.{i}.lin_l.bias"] = t[f"{tag}.{i}.lin_l.b"]
            state[f"{tag}.{i}.lin_r.weight"] = t[f"{tag}.{i}.lin_r.w"].T.contiguous()
    state["lns.0.weight"], state["lns.0.bias"] = t["ln.scale"], t["ln.bias"]
    for i in (1, 2, 3):
        state[f"conv{i}.weight"], state[f"conv{i}.bias"] = t[f"conv{i}.w"], t[f"conv{i}.b"]
    return state


def make_pipeline_world(tmp: Path, seed: int = PIPELINE_SEED, n_phages: int = PIPELINE_PHAGES,
                        n_others: int = PIPELINE_OTHERS, n_decoys: int = PIPELINE_DECOYS,
                        config_keys: dict | None = None) -> dict:
    """A virome sample after SPAdes, staged as the pipeline takes it
    (``scripts/make_demo.py``'s layout, made with the port's writers):

    * ``n_phages`` planted genomes, log-uniform 20-80 kb, every other one
      circular, each cut into 2-5 contigs; ``n_others`` non-phage contigs,
      log-normal lengths of median 2 kb (sigma 0.8, 500-60,000 bp), GC
      0.35-0.65 for a phage and 0.3-0.7 for another contig, in a shuffled
      assembly named ``EDGE_{i}_length_{L}_cov_{c}``;
    * ``02-assembly/``: ``contigs.fasta``, ``assembly_graph.fasta``, a FASTG
      whose links are the planted adjacencies, ``contigs.paths`` with a
      path a phage, and a sorted BAM: 150 bp reads at a uniform depth of
      ``BAM_DEPTH`` over every contig and ``SPLIT_READS`` split reads at
      each planted junction, circular closures included;
    * ``01-qc/``: paired reads of 150 bp from 350 bp fragments, the planted
      genomes at ``PHAGE_DEPTH``× and the other contigs at ``OTHER_DEPTH``×;
    * ``03-search/hit_seqs.out``: 8 gene hits a planted contig (the protein
      search is an external tool); no ``node_scores.out`` and no reference
      files: the scorer and eref make them;
    * a phagedb of the planted genomes and ``n_decoys`` decoys, log-uniform
      5-100 kb, shuffled; a protein database; a ``gcn_model`` checkpoint at
      ``models.gcn.DEFAULT_CONFIG``'s width with seeded weights (d1 and d2
      scaled ×3 and ×30, as the slice's check scales them), under the
      reference's key names;
    * ``config.txt`` with the demo's keys (``MIN_LEN=10000``, ``threads=8``,
      ``dev_fabricate_blast=1``) and ``config_keys``; every ``kmer_*`` and
      ``score_*`` key is left at its default unless ``config_keys`` sets it.

    Returns the paths, the sizes and the planted genomes."""
    from palace_tpu_torch.io.bam import FLAG_REVERSE, BamFile, BamRecord, write_bam
    from palace_tpu_torch.io.fasta import reverse_complement, write_fasta
    from palace_tpu_torch.models import gcn

    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    def seq(n, gc: float = 0.5) -> str:
        at = (1 - gc) / 2
        return bytes(lut[rng.choice(4, int(n), p=[at, gc / 2, gc / 2, at])]).decode()

    pieces, genomes = [], []  # pieces: (sequence, phage index or -1, cov)
    for i, g_len in enumerate(np.exp(rng.uniform(np.log(20_000), np.log(80_000), n_phages))):
        genome = seq(g_len, rng.uniform(0.35, 0.65))
        weights = rng.uniform(0.5, 1.5, int(rng.integers(2, 6)))
        bounds = np.round(np.concatenate([[0], np.cumsum(weights)]) / weights.sum()
                          * len(genome)).astype(int)
        genomes.append(dict(name=f"phage{i + 1}", genome=genome, circular=i % 2 == 0,
                            members=[]))
        pieces += [(genome[a:b], i, float(PHAGE_DEPTH)) for a, b in zip(bounds, bounds[1:])]
    lens = np.clip(rng.lognormal(np.log(2000), 0.8, n_others), 500, 60_000).astype(int)
    covs = np.round(rng.lognormal(np.log(OTHER_DEPTH), 0.5, n_others), 1)
    pieces += [(seq(L, gc), -1, float(c))
               for L, c, gc in zip(lens, covs, rng.uniform(0.3, 0.7, n_others))]
    contigs = {}
    for e, j in enumerate(rng.permutation(len(pieces))):
        s, owner, cov = pieces[j]
        name = f"EDGE_{e + 1}_length_{len(s)}_cov_{cov}"
        contigs[name] = s
        if owner >= 0:
            genomes[owner]["members"].append((j, name))
    junctions = []
    for g in genomes:  # members in genome order
        g["members"] = [name for _, name in sorted(g["members"])]
        m = g["members"]
        junctions += list(zip(m, m[1:])) + ([(m[-1], m[0])] if g["circular"] else [])

    out = tmp / "output"
    qc, asm, search = out / "01-qc", out / "02-assembly", out / "03-search"
    for d in (qc, asm, search):
        d.mkdir(parents=True, exist_ok=True)
    prefix = PIPELINE_PREFIX
    write_fasta(asm / "contigs.fasta", contigs.items())
    write_fasta(asm / "assembly_graph.fasta", contigs.items())
    links = {}
    for a, b in junctions:
        links.setdefault(a, []).append(b)
    with open(asm / "assembly_graph.fastg", "w") as fh:
        for name, s in contigs.items():
            head = f">{name}:{','.join(links[name])};" if name in links else f">{name};"
            fh.write(f"{head}\n{s}\n")
    with open(asm / "contigs.paths", "w") as fh:
        for n, g in enumerate(genomes, 1):
            fh.write(f"NODE_{n}_length_{len(g['genome'])}_cov_{PHAGE_DEPTH}\n"
                     + ",".join(f"{m.split('_')[1]}+" for m in g["members"]) + ";\n")

    tid = {name: i for i, name in enumerate(contigs)}
    records = []
    half = READ_LEN // 2
    for a, b in junctions:
        for k in range(SPLIT_READS):
            records.append(BamRecord(f"sr_{tid[a]}_{tid[b]}_{k}", 0, tid[a],
                                     len(contigs[a]) - half, 60, [(half, "M"), (half, "S")],
                                     -1, -1, 0, READ_LEN,
                                     {"NM": 0, "SA": f"{b},1,+,{half}S{half}M,60,0;"}))
    for name, s in contigs.items():
        n = len(s) * BAM_DEPTH // READ_LEN
        for k, (pos, rev) in enumerate(zip(rng.integers(0, len(s) - READ_LEN + 1, n),
                                           rng.random(n) < 0.5)):
            records.append(BamRecord(f"cov_{tid[name]}_{k}", FLAG_REVERSE if rev else 0,
                                     tid[name], int(pos), 60, [(READ_LEN, "M")], -1, -1, 0,
                                     READ_LEN, {"NM": 0}))
    records.sort(key=lambda r: (r.tid, r.pos))
    bam = asm / f"{prefix}_reads_pe_primary.sort.bam"
    write_bam(bam, BamFile(references=[(n, len(s)) for n, s in contigs.items()],
                           records=records))
    with open(search / "hit_seqs.out", "w") as fh:
        for g in genomes:
            fh.writelines(f"{m}\t8\n" for m in g["members"])

    fq = [[], []]
    sources = [(g["genome"] + (g["genome"][:FRAGMENT] if g["circular"] else ""), PHAGE_DEPTH)
               for g in genomes]
    planted = {m for g in genomes for m in g["members"]}
    sources += [(s, OTHER_DEPTH) for name, s in contigs.items() if name not in planted]
    qual = "I" * READ_LEN
    for src, depth in sources:
        n_pairs = len(src) * depth // (2 * READ_LEN)
        for start in rng.integers(0, len(src) - FRAGMENT + 1, n_pairs):
            frag = src[start:start + FRAGMENT]
            i = len(fq[0])
            fq[0].append(f"@p{i}/1\n{frag[:READ_LEN]}\n+\n{qual}\n")
            fq[1].append(f"@p{i}/2\n{reverse_complement(frag[-READ_LEN:])}\n+\n{qual}\n")
    fastqs = [qc / f"{prefix}_{m}_filter.fastq" for m in (1, 2)]
    for path, lines in zip(fastqs, fq):
        path.write_text("".join(lines))

    refs = [(g["name"], g["genome"]) for g in genomes]
    refs += [(f"decoy{j + 1}", seq(L)) for j, L in
             enumerate(np.exp(rng.uniform(np.log(5_000), np.log(100_000), n_decoys)))]
    refs = [refs[j] for j in rng.permutation(len(refs))]
    phagedb = tmp / "phagedb.fasta"
    write_fasta(phagedb, refs)
    protein_db = tmp / "protein_db"
    protein_db.mkdir(exist_ok=True)
    (protein_db / "proteins.fasta").write_text(">prot1\nMAAAKKK\n")
    model = tmp / "gcn_model.pt"
    cfg = gcn.DEFAULT_CONFIG
    params = gcn.init_params(torch.Generator().manual_seed(seed), cfg)
    # fan-in weights put every probability at about 0.507; scaled as in the
    # slice's check, they spread with the contigs' composition
    params["d1.w"], params["d2.w"] = params["d1.w"] * 3.0, params["d2.w"] * 30.0
    torch.save(reference_state_dict(params, cfg), model)

    keys = {"fastq1": fastqs[0], "fastq2": fastqs[1], "phagedb": phagedb,
            "protein_db": protein_db, "gcn_model": model, "out_dir": out, "prefix": prefix,
            "threads": 8, "MIN_LEN": 10000, "dev_fabricate_blast": 1, **(config_keys or {})}
    config = tmp / "config.txt"
    config.write_text("".join(f"{k}={v}\n" for k, v in keys.items()))
    return dict(config=config, out=out, fasta=asm / "assembly_graph.fasta", bam=bam,
                fastqs=fastqs, phagedb=phagedb, model=model, genomes=genomes,
                ref_names=[name for name, _ in refs], n_contigs=len(contigs),
                assembly_bp=sum(map(len, contigs.values())), n_records=len(records),
                n_pairs=len(fq[0]), n_junctions=len(junctions),
                phagedb_bp=sum(len(s) for _, s in refs))


def _rc(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGTacgt", "TGCAtgca"))


def reconstructed(final_fasta: Path, genomes: list) -> tuple:
    """Which planted genomes ``final_fasta`` holds, modulo its 50-N joints
    (tests/test_demo_reconstruction.py): a circular one up to rotation and
    reverse complement, a linear one equal or reverse-complemented; and how
    many records match no planted genome."""
    from palace_tpu_torch.io.fasta import iter_fasta

    bodies = [re.sub("N+", "", s) for _, s in iter_fasta(final_fasta)]

    def holds(body: str, g: dict) -> bool:
        want = g["genome"]
        if g["circular"]:
            return len(body) == len(want) and (body in want + want or _rc(body) in want + want)
        return body == want or _rc(body) == want

    found = [g["name"] for g in genomes if any(holds(b, g) for b in bodies)]
    others = sum(not any(holds(b, g) for g in genomes) for b in bodies)
    return found, others


# -- phases 20-21: the GCN across devices --------------------------------------
MESH_SEED = 19
MESH_RANKS = 2                # two processes sharing the one card (phase 21)
MESH_MODEL_PARALLEL = (1, 2)  # (data, model) = (2, 1), then (1, 2)
MESH_LOSS_RTOL = 1e-5         # a sharded step's loss against the one-rank step's
MESH_PARAM_ATOL = 1e-6        # updated shards, where Adam's sign does not flip
MESH_PARAM_SHARE = 0.01       # the share of elements allowed past it, each within 2·lr
MESH_TIMEOUT_S = 600
#: a picklable callable each rank of phase 21 runs first (a CPU test's seam)
MESH_SETUP = None
MESH_HELD = ("pnode_d.w", "d1.w")  # the two split parameters


def mesh_cfg():
    """The model of phases 20-21: ``GCNConfig()`` at its published width,
    dropout 0.2."""
    from palace_tpu_torch.models.gcn import GCNConfig

    return GCNConfig()


def mesh_job(device: str) -> dict:
    """What each rank of phases 20-21 rebuilds its world from, as this
    module holds it when the phase starts."""
    return dict(cfg=mesh_cfg(), n_contigs=N_CONTIGS, contig_len=CONTIG_LEN, batch=BATCH,
                train_batch=TRAIN_BATCH, lr=TRAIN_LR, seed=MESH_SEED,
                model_parallel=MESH_MODEL_PARALLEL, device=device, setup=MESH_SETUP)


def mesh_world(job: dict, device: torch.device) -> dict:
    """``n_contigs`` contigs with a spread of GC shares (the scored input),
    parameters from the seed with d1 and d2 scaled (×3, ×30) so that the
    probabilities spread, and one training batch of every
    (n_contigs / train_batch)-th contig through K1, labelled 1 above the
    median GC share: the same on every rank."""
    from palace_tpu_torch.models.gcn import init_params, model_inputs_from_features

    cfg = job["cfg"]
    contigs = make_contigs(job["n_contigs"], job["contig_len"], job["seed"], gc_spread=True)
    params = init_params(torch.Generator(device=device).manual_seed(job["seed"]), cfg)
    params["d1.w"], params["d2.w"] = params["d1.w"] * 3.0, params["d2.w"] * 30.0
    pick = [s for _, s in contigs[:: len(contigs) // job["train_batch"]][: job["train_batch"]]]
    gc = np.array([(s.count("G") + s.count("C")) / len(s) for s in pick])
    x_p, x_f = model_inputs_from_features(train_features(pick, device), cfg)
    y = torch.from_numpy((gc > np.median(gc)).astype(np.int64)).to(device)
    return dict(contigs=contigs, params=params, x_p=x_p, x_f=x_f, y=y)


def mesh_step(world: dict, job: dict, mesh=None, device=None):
    """One ``train_step`` at dropout ``cfg.drop_rate`` from the world's
    parameters (a generator seeded alike on every rank): on ``device``, or
    under ``mesh`` on this rank's data block.  Returns the loss and the
    state, whose split parameters hold their gradients."""
    from palace_tpu_torch.models.train import init_train_state, train_step
    from palace_tpu_torch.parallel.mesh import data_sharding

    cfg, lr = job["cfg"], job["lr"]
    state = init_train_state(world["params"], cfg, lr, device=device, mesh=mesh)
    dev = state.device
    batch = [world[k] for k in ("x_p", "x_f", "y")]
    if mesh is not None:
        batch = [data_sharding(t, mesh) for t in batch]
    gen = torch.Generator(device=dev).manual_seed(job["seed"] + 1)
    _, loss = train_step(state, *batch, gen, cfg, lr)
    return float(loss), state


def mesh_grads64(world: dict, job: dict, device: torch.device) -> dict:
    """The split parameters' gradients of the one-rank step in float64 (the
    same batch and dropout masks): what each float32 route is held to."""
    from palace_tpu_torch.models.gcn import TrainableGCN
    from palace_tpu_torch.models.train import value_and_grad

    cfg = job["cfg"]
    model = TrainableGCN(world["params"], cfg).to(device, torch.float64)
    gen = torch.Generator(device=device).manual_seed(job["seed"] + 1)
    _, grads = value_and_grad(model, world["x_p"].double(), world["x_f"].double(), world["y"],
                              cfg, gen)
    return {n: grads[n].detach().clone() for n in MESH_HELD}


def one_rank_reference(world: dict, job: dict, device: torch.device) -> dict:
    """The one-rank step's loss, updated split parameters and gradients,
    its float64 gradients, and how far its float32 gradients lie from them
    (the worst of the split parameters, over each one's largest magnitude)."""
    loss, state = mesh_step(world, job, device=device)
    params = state.model.params()
    ref = dict(loss=loss, params={n: params[n].detach().clone() for n in MESH_HELD},
               grads={n: params[n].grad.clone() for n in MESH_HELD})
    del state, params
    ref["grads64"] = mesh_grads64(world, job, device)
    ref["err64"] = max(float((ref["grads"][n].double() - g).abs().max() / g.abs().max())
                       for n, g in ref["grads64"].items())
    return ref


def shard_diffs(state, ref: dict) -> dict:
    """For each split parameter, against this rank's block of the one-rank
    step (``one_rank_reference``): its gradient shard's largest error over
    the whole float64 gradient's largest magnitude (``err64``) and over the
    float32 one's (``grad_err``), the updated shard's largest difference and
    the share of its elements past ``MESH_PARAM_ATOL``."""
    from palace_tpu_torch.parallel.mesh import local_shard

    params, out = state.model.params(), {}
    for name in MESH_HELD:
        spec = state.specs[name] if state.specs else ()

        def block(t):
            return local_shard(t, spec, state.mesh)

        g = params[name].grad
        g64 = (g.double() - block(ref["grads64"][name])).abs()
        g32 = (g - block(ref["grads"][name])).abs()
        d = (params[name].detach() - block(ref["params"][name])).abs()
        out[name] = dict(err64=float(g64.max() / ref["grads64"][name].abs().max()),
                         grad_err=float(g32.max() / ref["grads"][name].abs().max()),
                         param_diff=float(d.max()),
                         share=float((d > MESH_PARAM_ATOL).float().mean()),
                         shape=tuple(params[name].shape))
    return out


def mesh_rank(rank: int, world: int, store: str, out: str, job: dict) -> None:
    """One rank of phases 21, 23 and 24 (a process of
    ``torch.multiprocessing.spawn``): gloo with a ``file://`` store, its
    tensors on the job's device, its work ``job["work"]`` (phase 21's by
    default)."""
    import torch.distributed as dist

    from palace_tpu_torch.parallel import distributed

    if job["setup"] is not None:
        job["setup"]()
    distributed.initialize(f"file://{store}", world, rank, backend="gloo", device=job["device"])
    try:
        result = job.get("work", _mesh_rank_work)(rank, job, Path(out))
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out) / f"rank{rank}.pt")


def _mesh_rank_work(rank: int, job: dict, out: Path) -> dict:
    """Each layout of ``job["model_parallel"]``: the scorer in float32 and
    bfloat16 (launch counters reset just before and read just after) against
    the one-rank probabilities, contigs/s and the collectives' ms a batch;
    one training step against the one-rank step taken here first; under
    (1, ranks) a checkpoint saved and restored on one rank."""
    import gc as gcmod

    import torch.distributed as dist

    from palace_tpu_torch.models.checkpoint import (gather_train_state, restore_train_state,
                                                    save_train_state)
    from palace_tpu_torch.models.scoring import score_sequences
    from palace_tpu_torch.models.train import adam_moments, init_train_state
    from palace_tpu_torch.ops import kernels
    from palace_tpu_torch.parallel import collectives, make_mesh

    cfg, cuda = job["cfg"], job["device"] == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    world = mesh_world(job, dev)
    names = [n for n, _ in world["contigs"]]
    n_batches = -(-len(names) // job["batch"])
    ref = one_rank_reference(world, job, dev)
    gcmod.collect()
    result = {"rank": rank, "layouts": {}}
    for mp in job["model_parallel"]:
        mesh = make_mesh(model_parallel=mp, device=job["device"])
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        rec: dict = dict(coords=mesh.coords)
        for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
            kernels.reset_launches()
            got = score_sequences(world["params"], world["contigs"], cfg, job["batch"],
                                  dtype=dtype, mesh=mesh)
            sync()
            probs = np.array([p for _, p in got])
            rec[name] = dict(launches=dict(kernels.LAUNCHES), in_order=[n for n, _ in got] == names,
                             err=float(np.abs(probs - job["ref_probs"][name]).max()))
        sync()
        t0 = time.perf_counter()
        score_sequences(world["params"], world["contigs"], cfg, job["batch"],
                        dtype=torch.bfloat16, mesh=mesh)
        sync()
        rec["contigs_per_s"] = len(names) / (time.perf_counter() - t0)
        collectives.TIMING.reset()
        collectives.TIMING.enabled = True
        try:
            score_sequences(world["params"], world["contigs"], cfg, job["batch"],
                            dtype=torch.bfloat16, mesh=mesh)
        finally:
            collectives.TIMING.enabled = False
        rec["collective_ms_per_batch"] = collectives.TIMING.seconds * 1e3 / n_batches
        rec["collective_calls"] = collectives.TIMING.calls
        loss, state = mesh_step(world, job, mesh=mesh)
        rec.update(loss=loss, ref_loss=ref["loss"], ref_err64=ref["err64"],
                   split=shard_diffs(state, ref), specs={n: state.specs[n] for n in MESH_HELD})
        if mesh.mp == dist.get_world_size():
            save_train_state(out / "ckpt", state)
            whole = gather_train_state(state)
            if rank == 0:
                template = init_train_state({n: torch.zeros_like(t)
                                             for n, t in world["params"].items()},
                                            cfg, job["lr"], device=dev)
                back = restore_train_state(out / "ckpt", template)
                mu, nu, count = adam_moments(back)
                rec["checkpoint_equal"] = (
                    back.step == whole["step"] and count == whole["adam_step"]
                    and all(torch.equal(p, whole["params"][n])
                            and torch.equal(mu[n], whole["exp_avg"][n])
                            and torch.equal(nu[n], whole["exp_avg_sq"][n])
                            for n, p in back.model.params().items()))
                del template, back
            del whole
            dist.barrier()
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
        del state
        gcmod.collect()
        result["layouts"][(mesh.dp, mesh.mp)] = rec
    return result


def spawn_ranks(fn, world: int, job: dict, out: Path, timeout_s: float) -> list:
    """``world`` processes of ``fn(rank, world, store, out, job)`` through
    ``torch.multiprocessing.spawn`` with a ``file://`` store in ``out``; each
    one's ``rank<r>.pt``.  A rank that raises ends the others; past
    ``timeout_s`` every rank is ended and this raises."""
    import torch.multiprocessing as mp

    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.spawn(fn, args=(world, str(out / "store"), str(out), job), nprocs=world, join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


# -- phases 22-24: eref and the pipeline across devices -------------------------
ACROSS_RANKS = 2   # two processes sharing the one card (phases 23-24)
ACROSS_TIMEOUT_S = 600
#: scan_hits' integer operations a position (hashing, about 40); window_hits' (10)
SCAN_HITS_OPS, WINDOW_HITS_OPS = 40, 10


def split_reads(fq: Path) -> list:
    """The records of phase 8's reads.fastq alternately into r1.fastq and
    r2.fastq beside it (once): the pair ``run_search`` reads.  Their union
    is phase 8's reads, so their table is phase 8's and so are the hits;
    two copies of reads.fastq would count every read twice."""
    pair = [fq.with_name("r1.fastq"), fq.with_name("r2.fastq")]
    if not pair[1].exists():
        lines = fq.read_text().splitlines(keepends=True)
        recs = ["".join(lines[i:i + 4]) for i in range(0, len(lines), 4)]
        for path, part in zip(pair, (recs[0::2], recs[1::2])):
            path.write_text("".join(part))
    return pair


def scan_hits_bound(positions: int, rows: int, fbits: int, shard_reads: int) -> tuple:
    """scan_hits' bound, what its design must move through device memory:
    0.375 B a position in (codes and invalid bits), 24 B of offsets a row,
    0.375 B a position of hit bits out, the 2^fbits-bit hit filter read
    once, and a 32-byte sector for each shard read behind a set filter bit;
    ``SCAN_HITS_OPS`` a position at the float32 rate, the data sheet having
    no int32 rate.  The filter's probes, one for each in-range hash, are
    served by the L2 and are a term of their own (``probe_reads``), which
    the data sheet gives no rate to bound."""
    return bound(2 * (positions * 3 // 8) + 24 * rows + (1 << fbits) // 8 + 32 * shard_reads,
                 SCAN_HITS_OPS * positions, torch.float32)


def probe_reads(h: torch.Tensor, lo: int, size: int, filt) -> tuple:
    """(filter probes, shard reads) that scan_hits makes for the hashes
    ``h`` against the shard ``[lo, lo + size)`` and its hit filter ``filt``:
    a probe for each hash not 0 in the range, a shard read for each probe
    whose bit is set."""
    mine = (h != 0) & (h >= lo) & (h < lo + size)
    bit = (h[mine] - lo) & ((1 << filt.fbits) - 1)
    return int(mine.sum()), int(((filt.words[bit >> 5] >> (bit & 31)) & 1).sum())


#: the mesh sizes whose shard ranges phase 22 times scan_hits at
SHARD_WORLDS = (1, 2, 4)
#: K4's sharded Phase B in csrc/good_windows.cu, whose ptxas lines phase 2 checks
SHARDED_ENTRIES = ("hit_filter_kernel", "scan_hits_kernel", "window_hits_kernel")


def shard_shares(n: int) -> list:
    """(world, rank, lo, size) of rank 0's and the last rank's share of
    ``n`` hashes at each of ``SHARD_WORLDS``, split as
    ``count_table.ShardedCountTable`` splits them."""
    out = []
    for world in SHARD_WORLDS:
        size = -(-n // world)
        for rank in sorted({0, world - 1}):
            out.append((world, rank, rank * size, min(size, n - rank * size)))
    return out


def window_hits_bound(positions: int) -> tuple:
    """window_hits' bound: 0.375 B a position in, 0.125 B of flags out."""
    return bound(positions * 3 // 8 + positions // 8, WINDOW_HITS_OPS * positions,
                 torch.float32)


def copy_pipeline_world(world: dict, src: Path, dst: Path) -> Path:
    """Phase 16's world copied to ``dst`` before phase 17 writes into it,
    its config pointed at the copy; returns the copy's config."""
    import shutil

    shutil.copytree(src, dst)
    cfg = dst / Path(world["config"]).relative_to(src)
    cfg.write_text(cfg.read_text().replace(str(src), str(dst)))
    return cfg


def _eref_rank_work(rank: int, job: dict, out: Path) -> dict:
    """Phase 23 on one rank: ``run_search(mesh=...)`` and
    ``run_search_distributed`` at (2, 1), each with the launch counters and
    ``collectives.TIMING`` reset just before and read just after (TIMING
    synchronizes around each collective), its hits, Phase A and B seconds,
    the collectives' seconds and bytes, and the peak device memory; then
    each run's shard against its block of a one-device table of the same
    reads."""
    import torch.distributed as dist

    from palace_tpu_torch.config import KmerParams
    from palace_tpu_torch.ops import kernels
    from palace_tpu_torch.parallel import collectives, make_mesh
    from palace_tpu_torch.search import eref
    from palace_tpu_torch.search.index import load_index
    from palace_tpu_torch.utils.timers import GLOBAL_METRICS

    cuda = job["device"] == "cuda"
    index, params = load_index(job["db"], job["k"]), KmerParams(k=job["k"])
    mesh = make_mesh(device=job["device"])
    fqs = job["fastqs"]
    runs = {"run_search": lambda path: eref.run_search(*fqs, index, params, path, mesh=mesh),
            "run_search_distributed":
                lambda path: eref.run_search_distributed(fqs, index, params, path, mesh)}
    tables, real = [], eref.search_references

    def spy(table, *args):  # the sharded table each run counted
        tables.append(table)
        return real(table, *args)

    result = {"rank": rank, "index": mesh.index, "coords": mesh.coords, "runs": {}}
    shards = {}  # each run's shard, on the host so that the next run's peak is its own
    eref.search_references = spy
    try:
        for name, run in runs.items():
            GLOBAL_METRICS.stages.clear()
            kernels.reset_launches()
            collectives.TIMING.reset()
            collectives.TIMING.enabled = True
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            t0 = time.perf_counter()
            hits = run(out / f"ref_names.{name}.rank{rank}.txt")
            if cuda:
                torch.cuda.synchronize()
            collectives.TIMING.enabled = False
            st = GLOBAL_METRICS.stages
            result["runs"][name] = dict(
                hits=[h.line() for h in hits], wall_s=time.perf_counter() - t0,
                launches=dict(kernels.LAUNCHES), phase_a_s=st["eref.count_reads"].seconds,
                phase_b_s=st["eref.scan_refs"].seconds,
                collectives={p: (st[f"{s}.collectives"].seconds, st[f"{s}.collectives"].items)
                             for p, s in (("A", "eref.count_reads"), ("B", "eref.scan_refs"))},
                peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0)
            shards[name] = (tables[-1].lo, tables.pop().table.cpu())
    finally:
        eref.search_references = real
        collectives.TIMING.enabled = False
    whole = eref.count_reads_into_table(fqs, index, params, device=mesh.device).table
    for name, (lo, shard) in shards.items():
        block = whole[lo:lo + shard.numel()].cpu()
        result["runs"][name]["shard"] = (
            shard.numel(), bool(torch.equal(shard[:block.numel()], block)
                                and not shard[block.numel():].any()))
    return result


def _pipeline_rank_work(rank: int, job: dict, out: Path) -> dict:
    """Phase 24 on one rank: ``run_pipeline(cfg, mesh=...)`` at (2, 1) with
    the launch counters reset just before and read just after, its seconds
    by step and its peak device memory."""
    from palace_tpu_torch.config import PalaceConfig
    from palace_tpu_torch.ops import kernels
    from palace_tpu_torch.parallel import make_mesh
    from palace_tpu_torch.pipeline.driver import run_pipeline
    from palace_tpu_torch.utils.timers import GLOBAL_METRICS

    cuda = job["device"] == "cuda"
    mesh = make_mesh(device=job["device"])
    GLOBAL_METRICS.stages.clear()
    kernels.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = run_pipeline(PalaceConfig.from_file(job["config"]), mesh=mesh)
    if cuda:
        torch.cuda.synchronize()
    return dict(rank=rank, final=str(final), wall_s=time.perf_counter() - t0,
                launches=dict(kernels.LAUNCHES),
                seconds={k: v.seconds for k, v in GLOBAL_METRICS.stages.items()},
                peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0)


class Smoke:
    def __init__(self, device: str = "cuda"):
        self.dev = torch.device(device)
        self.failures: list = []
        self.records: dict = {}
        self.native_ok: bool | None = None

    def native_build(self) -> bool:
        """Build the port's host C++ sources (the FASTQ loader and
        ``palace_native``) with g++ and decide, from the result, whether the
        host phases must have taken the native routes or the Python ones."""
        from palace_tpu_torch.native import _build as native_build

        t0 = time.perf_counter()
        built = native_build.build_all()
        failed = {n: msg for n, (path, msg) in built.items() if path is None}
        self.native_ok = not failed
        if failed:
            say("native: unavailable (" + "; ".join(f"{n}: {m}" for n, m in failed.items())
                + "); the host phases take the Python routes")
        else:
            say(f"native: built {', '.join(p.name for p, _ in built.values())} in "
                f"{time.perf_counter() - t0:.1f} s (g++ {' '.join(native_build.CXX_FLAGS)} "
                f"{' '.join(native_build.LIBS)})")
        return self.native_ok

    def host_route(self) -> str:
        """The route the host phases must have taken: native or python."""
        if self.native_ok is None:
            self.native_build()
        return "native" if self.native_ok else "python"

    def check(self, ok: bool, what: str) -> None:
        say(("PASS " if ok else "FAIL ") + what)
        if not ok:
            self.failures.append(what)

    def phase(self, name: str, fn, *args):
        say(f"== {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # report the phase and go on to the next
            traceback.print_exc()
            self.failures.append(f"{name}: raised")
            return None
        say(f"   ({time.perf_counter() - t0:.1f} s)")
        return True if out is None else out

    # -- phase 2 -----------------------------------------------------------
    def build(self):
        from palace_tpu_torch.ops import _build

        t0 = time.perf_counter()
        libs = _build.build_all()
        say(f"built {len(libs)} kernels in {time.perf_counter() - t0:.1f} s "
            f"({' '.join(_build.NVCC_FLAGS)})")
        for lib in sorted(set(libs.values())):  # kernels of one source share a library
            name = next(n for n, path in libs.items() if path == lib)
            for line in ptxas_summary(_build.PTXAS_LOG[name]):
                say(f"  {_build.KERNELS[name][0]} {line}")
        self.check(_build.kernels_built(), "every kernel built for sm_90a")
        say(f"  sage_rounds bf16/f16 dynamic shared memory (csrc/sage_rounds.cu's layout): "
            f"{sage_smem_bytes()} B, 2 blocks an SM; float32 (sage_tf32_kernel) "
            f"{sage_f32_smem_bytes()} B, 1 block an SM")
        say("  conv_head bf16/f16 dynamic shared memory (csrc/conv_head.cu's layout): "
            + ", ".join(f"C={c} {LAYOUT[cm]} input {conv_smem_bytes(c, cm)} B, "
                        f"{1 if c == 128 else 2} block(s) an SM"
                        for c, cm in ((128, True), (64, True), (64, False)))
            + f"; float32 (conv_tf32_kernel) {conv_f32_smem_bytes()} B, 1 block an SM")
        tf32 = [line for line in ptxas_summary(_build.PTXAS_LOG["conv_head"])
                if line.startswith("conv_tf32_kernel") and "spill" in line]
        self.check(len(tf32) == 1 and re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                                                tf32[0]) is not None,
                   f"conv_tf32_kernel (K3 float32) spills nothing: {tf32}")
        sharded = [line for line in ptxas_summary(_build.PTXAS_LOG["scan_hits"])
                   if line.split(":")[0] in SHARDED_ENTRIES and "spill" in line]
        self.check(len(sharded) == len(SHARDED_ENTRIES) and all(
            re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line) for line in sharded),
                   f"K4's sharded entries spill nothing: {sharded}")

    # -- phase 3 -----------------------------------------------------------
    def kernels_at_main_shapes(self, params, contigs):
        from palace_tpu_torch.models import gcn
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.compare import TOLERANCES, compare
        from palace_tpu_torch.ops.encoder import byte_batch

        dev = self.dev
        batch = [t.to(dev) for t in byte_batch([s for _, s in contigs[:BATCH]])]

        # K1: integer counts, so equal
        feats = kernels.transition_features_bytes(*batch)
        plain = kernels.transition_features_bytes_plain(*batch)
        torch.cuda.synchronize()
        self.check(torch.equal(feats, plain),
                   f"K1 transition_counts equals its plain version on {BATCH} rows of "
                   f"{batch[0].numel()} bytes")
        self.records["transition_counts"] = dict(
            dtype="ASCII in, float32 out", max_abs_err=float((feats - plain).abs().max()),
            ms=cuda_ms(lambda: kernels.transition_features_bytes(*batch), 20),
            plain_ms=cuda_ms(lambda: kernels.transition_features_bytes_plain(*batch), 3),
            bound=k1_bound(*batch, feats), library_ms=None)

        for dt in (torch.float32, torch.bfloat16, torch.float16):
            p = {k: v.to(dt) for k, v in params.items()}
            x_p, x_f = gcn.lift_inputs(p, *gcn.model_inputs_from_features(feats.to(dt)))
            x_p, x_f = x_p.contiguous(), x_f.contiguous()
            w = gcn.sage_weight_stack(p, dt)
            tol = TOLERANCES[dt]

            # K2
            got = kernels.sage_rounds(x_p, x_f, w)
            res = compare(got, kernels.sage_rounds_plain(x_p, x_f, w), tol)
            torch.cuda.synchronize()
            self.check(res["ok"], f"K2 sage_rounds {DT_NAME[dt]} within {tol}: {res}")
            B, pn, d3 = x_p.shape
            f, gd = x_f.shape[1], w.shape[1]
            # the products of both rounds, per row: pnode and fnode sides
            ops = 2.0 * B * gd * (pn * d3 + 2 * f * d3 + 2 * f * gd + pn * gd)
            sage_rec = dict(
                dtype=DT_NAME[dt], max_abs_err=res["max_abs_err"], steps=res["steps"],
                ms=cuda_ms(lambda: kernels.sage_rounds(x_p, x_f, w), 10),
                plain_ms=cuda_ms(lambda: kernels.sage_rounds_plain(x_p, x_f, w), 3),
                bound=bound(nbytes(x_p, x_f, w, got), ops, dt), library_ms=None)
            # not K2's function: one of its products, which the port never
            # calls, timed as a yardstick for the kernel's tensor-core part
            a, wr11 = got.reshape(B * pn, gd), w[3 * d3 + 2 * gd:3 * d3 + 3 * gd]
            if dt == torch.bfloat16:
                ms = cuda_ms(lambda: torch.matmul(a, wr11), 10)
                say(f"  cuBLAS torch.matmul {tuple(a.shape)} x {tuple(wr11.shape)} bfloat16, "
                    f"K2's pass-B product alone (not K2's function): {ms:.4f} ms")
            if dt == torch.float32:
                yard = {}
                for tf32 in (False, True):
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    yard[tf32] = cuda_ms(lambda: torch.matmul(a, wr11), 10)
                torch.backends.cuda.matmul.allow_tf32 = False
                bounds = sage_f32_bounds(x_p, x_f, w, got)
                sage_rec.update(bounds=bounds, cublas_ms=yard[False], cublas_tf32_ms=yard[True],
                                bound=(max(bounds["tf32"], bounds["bytes"]),
                                       "operations" if bounds["tf32"] >= bounds["bytes"]
                                       else "bytes"))
                say(f"  cuBLAS torch.matmul {tuple(a.shape)} x {tuple(wr11.shape)} float32, "
                    f"K2's pass-B product alone (not K2's function): TF32 off {yard[False]:.4f} "
                    f"ms, TF32 on {yard[True]:.4f} ms (one TF32 product)")
                share = f"{100 * bounds['tf32'] / sage_rec['ms']:.1f}%" if sage_rec["ms"] else "-"
                say(f"  K2 float32 (3xTF32) {sage_rec['ms']:.4f} ms; bounds: bytes "
                    f"{bounds['bytes']:.4f} ms, 3xTF32 {bounds['tf32']:.4f} ms (read against "
                    f"this: {share}), all on the CUDA "
                    f"cores {bounds['cuda_cores']:.4f} ms; max |error| against the plain "
                    f"version {res['max_abs_err']:.4g} (the CUDA-core route it replaced, on "
                    f"these inputs: {CUDA_CORE_K2_FLOAT32_ERR['slice']['plain']:.4g})")

            # K3, on K2's output in the raw channel-scramble view
            x = got.reshape(B, gd, pn)
            cw = [p[f"conv{i}.w"] for i in (1, 2, 3)]
            cb = [p[f"conv{i}.b"] for i in (1, 2, 3)]
            y = kernels.conv_head(x, cw, cb)
            res = compare(y, kernels.conv_head_plain(x, cw, cb), tol)
            torch.cuda.synchronize()
            self.check(res["ok"] and y.is_contiguous(),
                       f"K3 conv_head {DT_NAME[dt]} {tuple(y.shape)} within {tol}: {res}")
            ops, L = 0.0, pn
            for wi in cw:
                L -= wi.shape[2] - 1
                ops += 2.0 * B * wi.shape[0] * wi.shape[1] * wi.shape[2] * L

            def cudnn():  # the library yardstick: cuDNN in the working dtype
                z = x
                for wi, bi in zip(cw, cb):
                    z = torch.relu(torch.nn.functional.conv1d(z, wi, bi))
                return z

            conv_rec = dict(
                dtype=DT_NAME[dt], max_abs_err=res["max_abs_err"], steps=res["steps"],
                ms=cuda_ms(lambda: kernels.conv_head(x, cw, cb), 5),
                plain_ms=cuda_ms(lambda: kernels.conv_head_plain(x, cw, cb), 3),
                bound=bound(nbytes(x, *cw, *cb, y), ops, dt),
                library_ms=cuda_ms(cudnn, 5), layers=self.conv_layers(x, cw, cb, dt))
            if dt == torch.float32:  # read against the 3×TF32 products, as K2's float32 row
                torch.backends.cudnn.allow_tf32 = True
                conv_rec["library_tf32_ms"] = cuda_ms(cudnn, 5)
                torch.backends.cudnn.allow_tf32 = False
                bounds = conv_f32_bounds(x, cw, cb, y)
                conv_rec.update(bounds=bounds, bound=tf32_bound(nbytes(x, *cw, *cb, y), ops))
                ms = conv_rec["ms"]
                share = f"{100 * bounds['tf32'] / ms:.1f}%" if ms else "-"
                say(f"  K3 float32 (3xTF32) {ms:.4f} ms; bounds: 3xTF32 {bounds['tf32']:.4f} ms "
                    f"(read against this: {share}), all on the CUDA cores "
                    f"{bounds['cuda_cores']:.4f} ms, bytes {bounds['bytes']:.4f} ms (the three "
                    f"launches' {bounds['layer_bytes']:.4f} ms); cuDNN float32 TF32 off "
                    f"{conv_rec['library_ms']:.4f} ms, TF32 allowed "
                    f"{conv_rec['library_tf32_ms']:.4f} ms (not float32's function)")
            for name, rec in (("sage_rounds", sage_rec), ("conv_head", conv_rec)):
                self.records[name if dt == torch.bfloat16 else f"{name}/{DT_NAME[dt]}"] = rec
            del got, x, y
            torch.cuda.empty_cache()
        for name, rec in self.records.items():
            b, by = rec["bound"]
            lib = "-" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
            say(f"  {name:<20} {rec['dtype']:<26} kernel {rec['ms']:.4f} ms  "
                f"plain {rec['plain_ms']:.4f} ms  library {lib} ms  "
                f"bound {b:.4f} ms ({by})  max_abs_err {rec['max_abs_err']:.3g}")

    def k1_on_assembly_lengths(self):
        """K1 on one batch of ``make_assembly_contigs``: equal to its plain
        version, its time and bound, the tiles it ran, and the same rows
        with one block a row (a tile longer than any row) beside it."""
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.encoder import byte_batch

        contigs = make_assembly_contigs(BATCH, SEED + 3)
        batch = [t.to(self.dev) for t in byte_batch([s for _, s in contigs])]
        got = kernels.transition_features_bytes(*batch)
        want = kernels.transition_features_bytes_plain(*batch)
        torch.cuda.synchronize()
        lens = batch[1].diff()
        self.check(torch.equal(got, want),
                   f"K1 equals its plain version on {len(contigs)} contigs of "
                   f"{int(lens.min())}-{int(lens.max())} bytes (median {int(lens.median())}), "
                   f"{batch[0].numel()} bytes in all")
        ms = cuda_ms(lambda: kernels.transition_features_bytes(*batch), 20)
        tile, kernels.TILE_BYTES = kernels.TILE_BYTES, int(lens.max()) + 1  # one block a row
        try:
            row_ms = cuda_ms(lambda: kernels.transition_features_bytes(*batch), 5)
        finally:
            kernels.TILE_BYTES = tile
        plain_ms = cuda_ms(lambda: kernels.transition_features_bytes_plain(*batch), 3)
        b, by = k1_bound(*batch, got)
        tiles = k1_tiles(batch[1], kernels.TILE_BYTES)
        say(f"  K1 {ms:.4f} ms over {tiles} tiles of {kernels.TILE_BYTES} B "
            f"({k1_tiles(batch[1][:2] - batch[1][0], kernels.TILE_BYTES)} for the longest "
            f"contig); one block a row {row_ms:.4f} ms; plain {plain_ms:.4f} ms; "
            f"bound {b:.4f} ms ({by}); library: none")
        self.records["transition_counts_assembly"] = dict(
            ms=ms, one_block_a_row_ms=row_ms, plain_ms=plain_ms, bound_ms=b, tiles=tiles,
            bytes=batch[0].numel())

    def k1_low_complexity(self):
        """K1 on ``BATCH`` rows of ``CONTIG_LEN`` bases of one repeat each,
        where a warp's positions fall into one to three bins, beside
        random rows: equal to its plain version, and its time."""
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.encoder import byte_batch

        rng = np.random.default_rng(SEED + 4)
        random_row = bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, CONTIG_LEN)]).decode()
        times = {}
        for name, row in (("random", random_row), ("poly-A", "A" * CONTIG_LEN),
                          ("(AT)n", ("AT" * CONTIG_LEN)[:CONTIG_LEN]),
                          ("(CAG)n", ("CAG" * CONTIG_LEN)[:CONTIG_LEN])):
            batch = [t.to(self.dev) for t in byte_batch([row] * BATCH)]
            got = kernels.transition_features_bytes(*batch)
            ok = torch.equal(got, kernels.transition_features_bytes_plain(*batch))
            torch.cuda.synchronize()
            self.check(ok, f"K1 equals its plain version on {BATCH} rows of {name}")
            times[name] = cuda_ms(lambda: kernels.transition_features_bytes(*batch), 20)
        say(f"  K1 on {BATCH} rows of {CONTIG_LEN} bases: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in times.items()))
        self.records["transition_counts_low_complexity"] = times

    def conv_layers(self, x, cw, cb, dt) -> list:
        """Each layer of K3 alone, in the layouts ``conv_head`` runs it
        (``kernels.conv_layouts``), with its own bound: in float32 its
        3×TF32 products' (``tf32_bound``), all on the CUDA cores beside it."""
        from palace_tpu_torch.ops import kernels

        out = []
        for i, (w, b, (in_cm, out_cm)) in enumerate(zip(cw, cb, kernels.conv_layouts(3, dt))):
            def run(x=x, w=w, b=b, in_cm=in_cm, out_cm=out_cm):
                return kernels.conv_layer(x, w, b, in_cm, out_cm)

            y = run()
            n_out = y.shape[2] if out_cm else y.shape[1]
            ops = 2.0 * x.shape[0] * w.shape[0] * w.shape[1] * w.shape[2] * n_out
            ms = cuda_ms(run, 5)
            rec = {}
            if dt == torch.float32:
                rec["cuda_cores_ms"] = ops / PEAK_OPS_PER_S[dt] * 1e3
                b_ms, by = tf32_bound(nbytes(x, w, b, y), ops)
                by_what = f"{by}, 3xTF32; all on the CUDA cores {rec['cuda_cores_ms']:.4f} ms"
            else:
                b_ms, by = bound(nbytes(x, w, b, y), ops, dt)
                by_what = by
            rate = f"{ops / ms / 1e9:.1f} TFLOP/s, {100 * b_ms / ms:.1f}% of the bound" if ms else ""
            say(f"    K3 layer {i + 1} {DT_NAME[dt]} {w.shape[1]}->{w.shape[0]} "
                f"{LAYOUT[in_cm]}->{LAYOUT[out_cm]}: {ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({by_what}) {rate}")
            out.append(dict(ms=ms, bound_ms=b_ms, bound_by=by, **rec))
            x = y
        return out

    def conv_rounding(self):
        """K3 where its outputs are large, against the float64 sums, within
        ``compare.CONV_LARGE_OUTPUTS``; a float32 einsum over the taps, the
        plain version (cuDNN in float32) and one mma chain a tile counted
        beside it, the last of which must fall outside: in bf16/f16 the chain
        of 16-deep products, in float32 the 3×TF32 chain (``tests/_tf32.py``),
        with one TF32 product counted too."""
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.compare import CONV_LARGE_OUTPUTS, compare

        tf32 = tf32_emulation()
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x, ws, bs = large_conv_inputs(ROUNDING_SHAPE, dt, self.dev)
            exact, tol = conv_sums(x, ws, bs, torch.float64), CONV_LARGE_OUTPUTS[dt]
            ys = [("kernel", lambda: kernels.conv_head(x, ws, bs)),
                  ("float32 einsum", lambda: conv_sums(x, ws, bs, torch.float32)),
                  ("plain (cuDNN float32)", lambda: kernels.conv_head_plain(x, ws, bs))]
            if dt == torch.float32:
                chain = "one 3xTF32 chain a tile"
                ys += [(chain, lambda: tf32.conv_tf32(x, ws, bs, chain_per_slice=False)),
                       ("one TF32 product", lambda: tf32.conv_tf32(x, ws, bs, tf32.ONE_TF32))]
            else:
                chain = "one mma chain a tile"
                ys.append((chain, lambda: one_mma_chain(x, ws, bs)))
            res = {name: compare(y(), exact, tol) for name, y in ys}
            say(f"  K3 {DT_NAME[dt]} at {ROUNDING_SHAPE}, outputs up to "
                f"{float(exact.float().abs().max()):.1f}; against float64, elements beyond "
                f"{tol.tol} (rounding steps) and max |error|: " + "; ".join(
                    f"{name} {r['steps']}, {r['max_abs_err']:.4g}" for name, r in res.items()))
            self.check(res["kernel"]["ok"], f"K3 {DT_NAME[dt]} at large outputs within {tol} "
                       f"of float64: {res['kernel']}")
            self.check(not res[chain]["ok"], f"{chain} falls outside it: {res[chain]}")
            if dt == torch.float32:
                self.records["conv_rounding_float32"] = res

    def conv_ragged(self):
        """K3 at ``RAGGED_CONV_SHAPES`` against its plain version within
        ``TOLERANCES``, in every dtype, three launches a head."""
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.compare import TOLERANCES, compare

        for dt in (torch.float32, torch.bfloat16, torch.float16):
            for shape in RAGGED_CONV_SHAPES:
                x, ws, bs = init_scale_conv_inputs(shape, dt, self.dev)
                before = kernels.LAUNCHES["conv_head"]
                got = kernels.conv_head(x, ws, bs)
                launched = kernels.LAUNCHES["conv_head"] - before
                res = compare(got, kernels.conv_head_plain(x, ws, bs), TOLERANCES[dt])
                self.check(res["ok"] and got.shape == (shape[0], 64, shape[2] - 21)
                           and launched == (3 if self.dev.type == "cuda" else 0),
                           f"K3 {DT_NAME[dt]} at {shape} within {TOLERANCES[dt]} of its plain "
                           f"version ({launched} launches): {res}")

    def sage_rounding(self):
        """K2 where its rounded intermediates reach 4..8, against its plain
        version within ``compare.SAGE_LARGE_INTERMEDIATES``, one ulp at
        that magnitude; the default ``TOLERANCES`` counted beside it.  In
        float32 (the tolerance is the default's, no steps) also against the
        float64 sums (``sage_sums64``), the plain version counted beside it."""
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.compare import SAGE_LARGE_INTERMEDIATES, TOLERANCES, compare

        for dt in (torch.float32, torch.bfloat16, torch.float16):
            xp, xf, w = large_sage_inputs(SAGE_ROUNDING_BATCH, dt, self.dev)
            peak = sage_peak(xp, xf, w)
            got, want = kernels.sage_rounds(xp, xf, w), kernels.sage_rounds_plain(xp, xf, w)
            res = {name: compare(got, want, tol) for name, tol in (
                ("default", TOLERANCES[dt]), ("4..8", SAGE_LARGE_INTERMEDIATES[dt]))}
            say(f"  K2 {DT_NAME[dt]} at batch {SAGE_ROUNDING_BATCH} of N(0, 1) inputs, "
                f"intermediates up to {peak:.3f}; against the plain version: " + "; ".join(
                    f"{name} {r['ok']} ({r['steps']} of {got.numel()} elements stepped, max "
                    f"|error| {r['max_abs_err']:.6g})" for name, r in res.items()))
            self.check(4 <= peak < 8, f"K2 {DT_NAME[dt]}: the intermediates reach 4..8 "
                                      f"({peak:.3f})")
            self.check(res["4..8"]["ok"], f"K2 {DT_NAME[dt]} within "
                                          f"{SAGE_LARGE_INTERMEDIATES[dt]}: {res['4..8']}")
            if dt == torch.float32:
                exact = sage_sums64(xp, xf, w)
                vs64 = {name: compare(y, exact, TOLERANCES[dt])
                        for name, y in (("kernel", got), ("plain", want))}
                del exact
                say("  K2 float32 against the float64 sums: " + "; ".join(
                    f"{name} {r['steps']} elements beyond {TOLERANCES[dt].tol}, max |error| "
                    f"{r['max_abs_err']:.6g}" for name, r in vs64.items())
                    + " (the CUDA-core route it replaced, on these inputs: plain "
                    f"{CUDA_CORE_K2_FLOAT32_ERR['large']['plain']:.6g}, float64 "
                    f"{CUDA_CORE_K2_FLOAT32_ERR['large']['float64']:.6g})")
                self.records["sage_rounding_float32"] = dict(
                    plain=res["default"], float64=vs64["kernel"], plain_float64=vs64["plain"])
            del got, want

    # -- phase 4 -----------------------------------------------------------
    def slice(self, params, contigs):
        from palace_tpu_torch.models.scoring import score_sequences
        from palace_tpu_torch.ops import kernels

        bf16, dev = torch.bfloat16, self.dev
        score_sequences(params, contigs[:BATCH], batch_size=BATCH, dtype=bf16, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        scores = score_sequences(params, contigs, batch_size=BATCH, dtype=bf16, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        n_batches = -(-len(contigs) // BATCH)
        say(f"  main path: {len(scores)} contigs in {n_batches} batches of {BATCH}, "
            f"bfloat16: {secs:.3f} s, {len(scores) / secs:.1f} contigs/s, "
            f"peak memory {peak / 2**30:.2f} GiB, launches {launches}")
        self.records["slice"] = dict(contigs_per_s=len(scores) / secs, seconds=secs,
                                     peak_bytes=peak, launches=launches)
        for name in SCORING_KERNELS:
            self.check(launches[name] > 0, f"main path launched {name} ({launches[name]} times)")
        probs = np.array([p for _, p in scores])
        self.check([n for n, _ in scores] == [n for n, _ in contigs]
                   and bool(np.isfinite(probs).all())
                   and bool(((probs >= 0) & (probs <= 1)).all()),
                   f"{len(scores)} named probabilities in input order, finite, in [0, 1]")
        for _ in range(2):  # the spread of the same run
            t0 = time.perf_counter()
            score_sequences(params, contigs, batch_size=BATCH, dtype=bf16, device=dev)
            torch.cuda.synchronize()
            say(f"  repeat: {len(contigs) / (time.perf_counter() - t0):.1f} contigs/s")
        # float32, the configurations' default dtype (no cast)
        score_sequences(params, contigs[:BATCH], batch_size=BATCH, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        scores = score_sequences(params, contigs, batch_size=BATCH, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        say(f"  float32: {len(contigs)} contigs in {secs:.3f} s, "
            f"{len(contigs) / secs:.1f} contigs/s, launches {launches}")
        self.records["slice_float32"] = dict(contigs_per_s=len(contigs) / secs, seconds=secs,
                                             launches=launches)
        for name in SCORING_KERNELS:
            self.check(launches[name] > 0,
                       f"main path in float32 launched {name} ({launches[name]} times)")
        probs = np.array([p for _, p in scores])
        self.check(bool(np.isfinite(probs).all()) and len(scores) == len(contigs),
                   f"{len(scores)} float32 probabilities, finite")

    def where_the_time_goes(self, params, contigs, n_batches: int = 4):
        """The host's step for one batch (``_host_batch``: the byte batch in
        pinned memory) beside the JAX package's 2-bit packing of the same
        batch, and the device time by kernel over ``n_batches`` batches of
        the main path in bfloat16 and in float32 (torch.profiler)."""
        from palace_tpu_torch.models.scoring import _host_batch
        from palace_tpu_torch.ops.encoder import pack_contigs

        seqs = [s for _, s in contigs[:BATCH]]
        host_ms, pack_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            _host_batch(seqs, self.dev)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            pack_contigs(seqs)
            pack_ms.append((time.perf_counter() - t0) * 1e3)
        say(f"  host step a batch of {BATCH} contigs (byte batch, pinned): "
            f"{' / '.join(f'{ms:.2f}' for ms in host_ms)} ms; the 2-bit packing it replaced "
            f"(pack_contigs, same batch): {' / '.join(f'{ms:.2f}' for ms in pack_ms)} ms")
        self.records["host_step"] = dict(host_ms=host_ms, pack_contigs_ms=pack_ms)
        for dt in (torch.bfloat16, None):
            self.device_split(params, contigs[:n_batches * BATCH], n_batches, dt)

    def device_split(self, params, part, n_batches: int, dtype):
        from torch.profiler import ProfilerActivity, profile

        from palace_tpu_torch.models.scoring import score_sequences

        name = DT_NAME[dtype or torch.float32]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            score_sequences(params, part, batch_size=BATCH, dtype=dtype, device=self.dev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms, calls = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
        busy_ms = sum(ms for ms, _ in by_name.values())
        if not by_name:
            say(f"  device time by kernel, {name}: not measured (the profiler saw no device "
                f"events)")
            return
        say(f"  profile of {n_batches} batches, {name}: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
            f"{wall_ms / n_batches:.2f} ms per batch")
        for kname, (ms, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            say(f"    {ms / n_batches:9.3f} ms/batch  {calls:4d} calls  {kname[:90]}")
        self.records[f"device_split_{name}"] = dict(busy_ms=busy_ms / n_batches,
                                                    wall_ms=wall_ms / n_batches)

    def slice_against_plain(self, params):
        """One batch through the kernels against the plain versions on the
        card, and a few contigs against the plain path on the CPU.  d1 and d2
        are scaled and the contigs' GC share varies, so the probabilities
        spread (fan-in weights put them all at about 0.507)."""
        from palace_tpu_torch.models.gcn import GCNScorer
        from palace_tpu_torch.models.scoring import score_sequences
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.encoder import byte_batch

        p = dict(params, **{"d1.w": params["d1.w"] * 3.0, "d2.w": params["d2.w"] * 30.0})
        batch, dev = make_contigs(BATCH, CONTIG_LEN, SEED + 2, gc_spread=True), self.dev
        for dt, atol in ((None, PROB_ATOL), (torch.bfloat16, PROB_ATOL_BF16)):
            got = np.array([v for _, v in score_sequences(p, batch, batch_size=BATCH,
                                                            dtype=dt, device=dev)])
            model = GCNScorer(p).to(dev)
            model = model.to(dt) if dt is not None else model
            rows = [t.to(dev) for t in byte_batch([s for _, s in batch])]
            want = model.score_features(kernels.transition_features_bytes_plain(*rows),
                                        plain=True).float().cpu().numpy()
            err = float(np.abs(got - want).max())
            name = DT_NAME[dt or torch.float32]
            self.check(err <= atol and np.ptp(want) > 0.05,
                       f"slice {name} through kernels vs plain versions on the card: "
                       f"max |dp| {err:.3g} <= {atol}, probabilities spread {np.ptp(want):.3f}")
            self.records[f"slice_err_{name}"] = err

        rng = np.random.default_rng(SEED + 1)
        small = [("edge_" + str(i), s) for i, s in enumerate(
            ["", "ACG", "ACGTNNACGT" * 40, "acgt" * 300, "N" * 50 + "GATTACA" * 200]
            + ["".join(rng.choice(list("ACGT"), size=3000, p=q))
               for q in ([.1, .4, .4, .1], [.4, .1, .1, .4], [.25] * 4)])]
        got = np.array([v for _, v in score_sequences(p, small, batch_size=8, device=dev)])
        cpu = {k: v.cpu() for k, v in p.items()}
        want = np.array([v for _, v in score_sequences(cpu, small, batch_size=8, device="cpu")])
        err = float(np.abs(got - want).max())
        self.check(err <= PROB_ATOL and np.ptp(want) > 0.05,
                   f"{len(small)} contigs on the card vs the plain path on the CPU, float32: "
                   f"max |dp| {err:.3g} <= {PROB_ATOL}, spread {np.ptp(want):.3f}")
        self.records["cpu_err_float32"] = err

    def launched(self, what: str, launches: dict, want: dict) -> None:
        """Check that a run launched each named kernel as often as ``want``
        says (the counters read just after it)."""
        for name, n in want.items():
            self.check(launches[name] == n, f"{what} launched {name} {n} time(s) "
                                            f"({launches[name]} launches)")

    def counted(self, fn):
        """``fn()`` with the launch counters reset just before it and read
        just after: (its result, the launches)."""
        from palace_tpu_torch.ops import kernels

        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(kernels.LAUNCHES)

    # -- phase 6: the public names of the scorer's path ----------------------
    def public_names(self, params, contigs):
        """The names the port exports beside the scorer, on the slice's first
        batch: ``transition_features`` on its ``seq_to_kmer_locs`` padded,
        ``features_from_codes`` and ``features_from_packed``, each one
        launch of K1's padded-codes entry, bit-equal to the byte entry and
        to the plain version; the codes entry on random codes with codes
        outside [0, 64) and n_locs of 0 and L; ``encode_batch`` and
        ``encode_sequences`` (the byte entry); ``phage_probabilities`` at
        ``GCNConfig()`` in float32 (K2 once, K3 three times) within
        ``PROB_ATOL`` of ``score_codes``; and the codes entry's time."""
        from palace_tpu_torch.models import phage_probabilities
        from palace_tpu_torch.models.scoring import score_codes
        from palace_tpu_torch.ops import encoder, kernels

        dev, seqs = self.dev, [s for _, s in contigs[:BATCH]]
        want = encoder.features_from_bytes(*(t.to(dev) for t in encoder.byte_batch(seqs)))
        codes, n_codes, lens = encoder.seqs_to_code_batch(seqs)
        L = codes.shape[1] - 2  # the width of locs_from_codes
        padded = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs):
            row = encoder.seq_to_kmer_locs(s)[0]
            padded[i, :len(row)] = row
        n_locs = np.maximum(n_codes - 2, 0).astype(np.int32)
        locs_d, n_d = torch.from_numpy(padded).to(dev), torch.from_numpy(n_locs).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)
        plain = encoder.scale_by_length(
            kernels.transition_counts_plain(locs_d, n_d).reshape(len(seqs), -1), lens_d)
        self.check(torch.equal(plain, want), "the codes entry's plain version equals the byte "
                                             f"entry on {len(seqs)} contigs")
        runs = {"transition_features": lambda: encoder.transition_features(locs_d, n_d, lens_d),
                "features_from_codes": lambda: encoder.features_from_codes(codes, n_codes, lens,
                                                                           dev),
                "features_from_packed": lambda: encoder.features_from_packed(
                    *encoder.pack_contigs(seqs), device=dev)}
        total = dict.fromkeys(kernels.LAUNCHES, 0)
        for name, run in runs.items():
            got, launches = self.counted(run)
            total = {k: total[k] + launches[k] for k in total}
            self.launched(f"public names: {name}", launches, {"transition_counts_codes": 1})
            self.check(got.device == want.device and torch.equal(got, want),
                       f"{name} on {tuple(padded.shape)} codes bit-equal to the byte entry and "
                       f"to its plain version")

        rng = np.random.default_rng(SEED + 3)  # random codes, not 3-mer chains
        rand = rng.integers(0, 64, (len(seqs), L), dtype=np.int32)
        bad = rng.random(rand.shape) < 0.01
        rand[bad] = rng.choice(np.array([-1, -7, 64, 70, 1 << 30], np.int32), int(bad.sum()))
        n_rand = rng.integers(0, L + 1, len(seqs)).astype(np.int32)
        n_rand[0], n_rand[-1] = 0, L
        rand_d, n_rand_d = torch.from_numpy(rand).to(dev), torch.from_numpy(n_rand).to(dev)
        got = kernels.transition_counts(rand_d, n_rand_d)
        self.check(torch.equal(got, kernels.transition_counts_plain(rand_d, n_rand_d)),
                   f"the codes entry equals its plain version on random codes, {int(bad.sum())} "
                   f"outside [0, 64), n_locs of 0 and L")

        got, launches = self.counted(lambda: encoder.encode_batch(seqs, dev))
        self.launched("public names: encode_batch", launches, {"transition_counts": 1})
        self.check(torch.equal(got, want), "encode_batch bit-equal to features_from_bytes")
        got, launches = self.counted(lambda: encoder.encode_sequences(seqs, 64, dev))
        self.launched("public names: encode_sequences", launches,
                      {"transition_counts": -(-len(seqs) // 64)})
        self.check(isinstance(got, np.ndarray) and np.array_equal(got, want.cpu().numpy()),
                   f"encode_sequences over {len(seqs)} contigs in batches of 64 equal to it")

        probs, launches = self.counted(lambda: phage_probabilities(params, want))
        self.launched("public names: phage_probabilities", launches,
                      {"sage_rounds": 1, "conv_head": 3})
        ref = score_codes(params, seqs, device=dev)
        err = float((probs - ref).abs().max())
        self.check(probs.shape == (len(seqs),) and bool(torch.isfinite(probs).all())
                   and err <= PROB_ATOL,
                   f"phage_probabilities at GCNConfig() in float32 within {PROB_ATOL} of "
                   f"score_codes: max |dp| {err:.3g}")

        def codes_entry():
            return kernels.transition_counts(locs_d, n_d)

        def codes_plain():
            return kernels.transition_counts_plain(locs_d, n_d)

        counts = codes_entry()
        pairs = float(sum(torch.clamp(n_d.long() - 3 - d, min=0).sum() for d in range(3)))
        rec = dict(dtype="int32 codes in, float32 out",
                   max_abs_err=float((counts - codes_plain()).abs().max()),
                   ms=cuda_ms(codes_entry, 20), plain_ms=cuda_ms(codes_plain, 3),
                   bound=bound(nbytes(locs_d, n_d, counts), pairs, torch.float32),
                   library_ms=None)
        self.records["transition_counts/codes"] = rec
        self.records["public_names"] = dict(launches=total, phage_err=err)
        say(f"  K1 codes entry on {tuple(padded.shape)} codes: kernel {rec['ms']:.4f} ms, "
            f"bound {rec['bound'][0]:.4f} ms ({rec['bound'][1]}), plain {rec['plain_ms']:.4f} ms, "
            f"library: none; launches on the three entries {total['transition_counts_codes']}")

    # -- phases 7-13: the eref slice ----------------------------------------
    def eref_world(self, tmp: Path):
        from palace_tpu_torch.search.index import build_index

        t0 = time.perf_counter()
        db, fq, n_planted = make_eref_world(tmp, EREF_REFS, EREF_READS)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = build_index(db, k=EREF_K, save=False)
        build_s = time.perf_counter() - t0
        total = int(index.lengths.sum())
        say(f"  world: {index.n_refs} refs of {int(index.lengths.min())}-"
            f"{int(index.lengths.max())} bp, {total} bp, {EREF_READS} reads of "
            f"{EREF_READ_LEN} bp from {n_planted} planted refs (made in {gen_s:.1f} s)")
        say(f"  host index build: {build_s:.3f} s, {total / build_s / 1e6:.2f} Mbp/s, "
            f"{index.packed.nbytes + index.maskbits.nbytes} bytes packed")
        self.records["eref_index"] = dict(build_s=build_s, total_bp=total)
        return index, fq, n_planted

    def eref_slice(self, world):
        """The second main path: Phase A and Phase B on the card, counters
        reset just before and read just after; Phase A launches
        ``count_codes`` once a batch.  Returns the table and the hits."""
        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.search.eref import (
            READERS,
            count_reads_into_table,
            plan_chunks,
            search_references,
            write_ref_names,
        )
        from palace_tpu_torch.utils.timers import GLOBAL_METRICS

        def phase_a_counts():  # batches, then count_codes' updates and skips at cap
            got = GLOBAL_METRICS.summary()
            return (got.get("eref.add_packed", {}).get("calls", 0),
                    *(got.get(n, {}).get("items", 0)
                      for n in ("eref.count_updates", "eref.count_at_cap")))

        index, fq, n_planted = world
        params = KmerParams(k=EREF_K)
        readers = dict(READERS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = phase_a_counts()
        kernels.reset_launches()
        t0 = time.perf_counter()
        table = count_reads_into_table([fq], index, params, device=self.dev)
        torch.cuda.synchronize()
        a_s = time.perf_counter() - t0
        n_batches, updates, at_cap = (b - a for a, b in zip(counts, phase_a_counts()))
        peak_a = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = host_parts()
        t0 = time.perf_counter()
        hits = search_references(table, index, params)
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
        parts = {n: ms - before[n] for n, ms in host_parts().items()}
        launches = dict(kernels.LAUNCHES)
        peak_b = torch.cuda.max_memory_allocated()
        peak = max(peak_a, peak_b)
        chunks = plan_chunks(index)
        n_chunks = len(chunks)
        total = int(index.lengths.sum())
        readers = {n: READERS[n] - readers[n] for n in READERS}
        say(f"  Phase A: {EREF_READS} reads in {a_s:.3f} s, {EREF_READS / a_s:.1f} reads/s "
            f"(table of 2^{EREF_K} bytes; FASTQ files read: {readers}; {n_batches} batches; "
            f"count_codes' updates by CAS {updates}, skipped at cap {at_cap})")
        say(f"  Phase B: {total} positions in {n_chunks} chunks, {b_s:.3f} s, "
            f"{total / b_s / 1e6:.2f} Mpos/s; peak memory {peak / 2**30:.2f} GiB; "
            f"launches {launches}")
        say(f"  Phase B alone: peak memory {peak_b / 2**30:.3f} GiB (Phase A {peak_a / 2**30:.3f}); "
            f"host clock: {host_parts_line(parts)}")
        scanned = sum(rows * target for target, _, rows in chunks)
        valid = sum(max(0, int(index.lengths[r]) - EREF_K + 1) for _, refs, _ in chunks
                    for r in refs)
        b_ms, by = scan_bound(scanned, sum(rows for _, _, rows in chunks), 3 * valid)
        say(f"  scan_chunk's bound over this Phase B: {scanned} positions scanned (buckets and "
            f"pad rows included), {valid} k-mers of ACGT: {b_ms:.4f} ms ({by}); the floor of "
            f"its table reads, a 32-byte sector each: {gather_floor_ms(3 * valid):.4f} ms")
        names = Path(fq).with_name("ref_names.one_device.txt")
        write_ref_names(names, hits)
        self.records["eref"] = dict(phase_a_s=a_s, phase_b_s=b_s, peak_bytes=peak,
                                    phase_b_peak_bytes=peak_b, host_ms=parts,
                                    n_chunks=n_chunks, launches=launches, n_hits=len(hits),
                                    readers=readers, ref_names=names.read_bytes(),
                                    n_batches=n_batches, updates=updates, at_cap=at_cap)
        self.check(launches["scan_chunk"] == n_chunks and n_chunks > 0,
                   f"eref main path launched scan_chunk once a chunk "
                   f"({launches['scan_chunk']} launches, {n_chunks} chunks)")
        self.check(launches["count_codes"] == n_batches and n_batches > 0,
                   f"eref main path launched count_codes once a batch "
                   f"({launches['count_codes']} launches, {n_batches} batches)")
        n_plantable = max(1, EREF_REFS // 50)
        self.check(len(hits) > 0 and all(1 <= h.ref_index <= n_plantable for h in hits),
                   f"{len(hits)} hits, every one a planted reference (ref_index 1..{n_plantable})")
        self.check(len(hits) == EREF_JAX_HITS,
                   f"{len(hits)} hits on the card, {EREF_JAX_HITS} from the JAX package "
                   f"on the same world (benchmarks/phaseb_5kref.json)")
        for _ in range(2):  # the spread of Phase B
            t0 = time.perf_counter()
            again = search_references(table, index, params)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            say(f"  Phase B repeat: {secs:.3f} s, {total / secs / 1e6:.2f} Mpos/s, "
                f"same hits: {[h.line() for h in again] == [h.line() for h in hits]}")
        return table, hits

    def phase_a_native(self, world):
        """Phase A with the native loader: the eref slice's Phase A read its
        FASTQ with it (with the Python reader where it could not be built)
        and found the JAX package's hits; on the same file, the loader's
        batches equal the Python reader's, and Phase A's host seconds split
        as the card's route takes them: the reader, the staging of each
        batch in one pinned buffer (a short batch's missing rows set to
        code 4), and each batch's upload and ``count_codes`` launch, on a
        fresh table, to a synchronize."""
        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.ops.count_table import CountTable
        from palace_tpu_torch.search import eref

        index, fq, _ = world
        route, rec = self.host_route(), self.records["eref"]
        self.check(rec["readers"] == {"native": int(route == "native"),
                                      "python": int(route == "python")},
                   f"the eref slice's Phase A read its FASTQ with the {route} reader "
                   f"({rec['readers']})")
        self.check(rec["n_hits"] == EREF_JAX_HITS,
                   f"with it, {rec['n_hits']} hits, {EREF_JAX_HITS} from the JAX package")
        params = KmerParams(k=EREF_K)
        maxlen = eref._row_len(params)
        batch = eref.read_batch_size(self.dev)
        t0 = time.perf_counter()
        ratio = eref.compute_downsample_ratio(fq, params.down_sampling_size)
        ratio_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batches = list(eref.read_code_batches(fq, batch, maxlen, ratio, EREF_K))
        reader_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        python = list(eref._py_read_batches(fq, batch, maxlen, ratio, EREF_K))
        python_s = time.perf_counter() - t0
        self.check(len(batches) == len(python)
                   and all(np.array_equal(a, b) for a, b in zip(batches, python)),
                   f"the {route} reader's {len(batches)} batches equal the Python reader's")
        del python
        staging = torch.empty((batch, maxlen), dtype=torch.uint8,
                              pin_memory=self.dev.type == "cuda")
        staged = staging.numpy()
        scratch = CountTable.create(EREF_K, device=self.dev)
        stage_s = add_s = 0.0
        torch.cuda.synchronize()
        for codes in batches:
            n = codes.shape[0]
            t0 = time.perf_counter()
            staged[:n] = codes
            staged[n:] = 4
            t1 = time.perf_counter()
            scratch.add_codes(staging.to(self.dev, non_blocking=True), index.perm, EREF_K)
            torch.cuda.synchronize()
            stage_s, add_s = stage_s + t1 - t0, add_s + time.perf_counter() - t1
        del scratch
        reads = sum(c.shape[0] for c in batches)
        total = ratio_s + reader_s + stage_s + add_s
        say(f"  Phase A's parts, {reads} rows in {len(batches)} batches of {batch}: down-sampling "
            f"ratio {ratio_s:.3f} s, {route} reader {reader_s:.3f} s (the Python reader "
            f"{python_s:.3f} s), staging {stage_s:.3f} s, upload and count_codes to a "
            f"synchronize {add_s:.3f} s; {total:.3f} s in all, {reads / total:.1f} reads/s")
        self.records["phase_a_native"] = dict(route=route, ratio_s=ratio_s, reader_s=reader_s,
                                              python_reader_s=python_s, staging_s=stage_s,
                                              add_codes_s=add_s, batches=len(batches))

    def phase_a_split(self, world):
        """Phase A's host and device parts apart: the FASTQ reader on the
        host clock, one full batch's upload and ``count_codes`` on a fresh
        table on the card."""
        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.ops.count_table import CountTable
        from palace_tpu_torch.search import eref

        index, fq, _ = world
        params = KmerParams(k=EREF_K)
        t0 = time.perf_counter()
        ratio = eref.compute_downsample_ratio(fq, params.down_sampling_size)
        ratio_s = time.perf_counter() - t0
        batch = eref.read_batch_size(self.dev)
        t0 = time.perf_counter()
        rows = list(eref.read_code_batches(fq, batch, eref._row_len(params), ratio, EREF_K))
        read_s = time.perf_counter() - t0
        first = torch.from_numpy(rows[0])
        ms = []
        for _ in range(3):
            scratch = CountTable.create(EREF_K, device=self.dev)
            ms.append(cuda_ms(lambda: scratch.add_codes(first.to(self.dev), index.perm, EREF_K),
                              1, warmup=0))
            del scratch
        ms = float(np.median(ms))
        say(f"  host: down-sampling ratio {ratio_s:.3f} s, reading {len(rows)} batches of "
            f"{batch} rows {read_s:.3f} s; card: {ms:.3f} ms a batch's upload and count_codes "
            f"({len(rows) * ms / 1e3:.3f} s for all)")
        self.records["phase_a_split"] = dict(ratio_s=ratio_s, read_s=read_s, batch_ms=ms,
                                             batches=len(rows))

    def count_codes_on_real_batches(self, world):
        """Phase A's kernel on the eref world's batches as the card stages
        them (the reader's rows, a short last batch padded with code 4):
        ``count_codes`` over every batch equal to ``count_codes_plain`` and
        to the CPU's route (``pack_codes_mask``, ``add_packed``), the whole
        table byte for byte, slot 0 included; its time a batch on a fresh
        table by CUDA events, beside the plain version's and the CPU
        route's (host clock, to a synchronize); its bound, the codes read
        once and the floor of its table reads, one a nonzero hash at the
        card's ``RANDOM_READS_PER_S``; on the card, its counters against
        the nonzero hashes; and what padding the short batch costs: the
        host's fill, and the whole batch's upload and launch against its
        rows' alone."""
        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.count_table import CountTable
        from palace_tpu_torch.ops.kmer import kmer_hashes_masked, pack_codes_mask
        from palace_tpu_torch.search import eref

        index, fq, _ = world
        params = KmerParams(k=EREF_K)
        k, cap, perm = EREF_K, params.least_depth, index.perm
        maxlen, batch = eref._row_len(params), eref.read_batch_size(self.dev)
        ratio = eref.compute_downsample_ratio(fq, params.down_sampling_size)
        rows = list(eref.read_code_batches(fq, batch, maxlen, ratio, k))
        host = [np.pad(c, ((0, batch - c.shape[0]), (0, 0)), constant_values=4) for c in rows]
        on_card = [torch.from_numpy(c).to(self.dev) for c in host]
        nonzero = sum(int((kmer_hashes_masked(c, perm, k) != 0).sum()) for c in on_card)

        def fresh():
            return torch.zeros(1 << k, dtype=torch.uint8, device=self.dev)

        def count_all(table, fn=kernels.count_codes, counters=None):
            for c in on_card:
                fn(table, c, perm, k, cap, *([counters] if counters is not None else []))

        table, plain = fresh(), fresh()
        counters = torch.zeros(2, dtype=torch.int64, device=self.dev)
        count_all(table, counters=counters)
        count_all(plain, kernels.count_codes_plain)
        same_plain = torch.equal(table, plain)
        del plain
        other = CountTable.create(k, cap, device=self.dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in host:
            packed, mask = pack_codes_mask(c)
            other.add_packed(torch.from_numpy(packed), torch.from_numpy(mask), perm, k)
        torch.cuda.synchronize()
        other_ms = (time.perf_counter() - t0) * 1e3 / len(host)
        same_other = torch.equal(table, other.table)
        slot0 = int(table[0])
        del other, table
        self.check(same_plain and same_other,
                   f"count_codes on the reader's {len(rows)} batches of {batch} rows of {maxlen} "
                   f"(the last {rows[-1].shape[0]} rows and its pad): the whole table equal to "
                   f"count_codes_plain's ({same_plain}) and to pack_codes_mask + add_packed's "
                   f"({same_other}), slot 0 ({slot0}) included")
        updates, at_cap = counters.tolist()
        if self.dev.type == "cuda":
            self.check(updates + at_cap == nonzero,
                       f"count_codes' counters: {updates} updates by CAS and {at_cap} skipped "
                       f"at cap, {nonzero} nonzero hashes")

        ms = []
        for _ in range(3):
            scratch = fresh()
            ms.append(cuda_ms(lambda: count_all(scratch), 1, warmup=0) / len(on_card))
            del scratch
        scratch = fresh()
        plain_ms = cuda_ms(lambda: count_all(scratch, kernels.count_codes_plain), 1,
                           warmup=0) / len(on_card)
        code_bytes = sum(c.numel() for c in on_card)
        b = max((code_bytes / HBM_BYTES_PER_S * 1e3 / len(on_card), "bytes"),
                (nonzero / RANDOM_READS_PER_S * 1e3 / len(on_card), "table reads"))

        # the short batch's pad: the host's fill, and its upload and launch whole or not
        n = rows[-1].shape[0]
        staging = torch.empty((batch, maxlen), dtype=torch.uint8,
                              pin_memory=self.dev.type == "cuda")
        staging.numpy()[:n] = rows[-1]
        fills = []
        for _ in range(5):
            t0 = time.perf_counter()
            staging.numpy()[n:] = 4
            fills.append((time.perf_counter() - t0) * 1e3)
        pad = dict(rows=n, fill_ms=float(np.median(fills)))
        for name, part in (("whole_ms", staging), ("rows_ms", staging[:n])):
            pad[name] = cuda_ms(lambda: kernels.count_codes(
                scratch, part.to(self.dev, non_blocking=True), perm, k, cap), 5)
        del scratch
        self.records["count_codes"] = dict(
            dtype="uint8 codes in, uint8 counts", max_abs_err=0.0 if same_plain else float("inf"),
            ms=float(np.median(ms)), ms_runs=ms, plain_ms=plain_ms, bound=b, library_ms=None,
            other_route_ms=other_ms, batches=len(rows), nonzero=nonzero, updates=updates,
            at_cap=at_cap, pad=pad)
        say(f"  count_codes: kernel {', '.join(f'{x:.4f}' for x in ms)} ms a batch (fresh table), "
            f"bound {b[0]:.4f} ms ({b[1]}), plain {plain_ms:.4f} ms, pack_codes_mask + "
            f"add_packed {other_ms:.3f} ms on the host clock; library: none")
        say(f"  the short batch of {n} rows: its pad filled on the host in {pad['fill_ms']:.4f} "
            f"ms; upload and count_codes {pad['whole_ms']:.4f} ms padded, {pad['rows_ms']:.4f} "
            f"ms its rows alone")

    def scan_chunk_on_real_chunks(self, world, table):
        """K4 fused on real Phase B chunks: ``scan_chunk`` equal to its plain
        version on every chunk; then, over the first chunk of each length
        bucket and one with pad rows, its time (torch.profiler's device time
        of the kernel, and the wrapper's, whose offsets check synchronizes)
        beside the parent's route (``chunk_inputs``, then ``good_windows``)
        and the plain version, its byte bound and the floor of its table
        reads, and its registers and spills."""
        from torch.profiler import ProfilerActivity, profile

        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.ops import _build, kernels
        from palace_tpu_torch.ops.window import window_thresholds
        from palace_tpu_torch.search.eref import DeviceDB, chunk_inputs, chunk_offsets, plan_chunks

        index = world[0]
        params = KmerParams(k=EREF_K)
        one_min, three_min = window_thresholds(params.window, params.hit_ratio,
                                               params.perfect_hit_ratio)
        db = DeviceDB(index, self.dev)
        chunks = plan_chunks(index)
        offs = [torch.from_numpy(chunk_offsets(index, refs, rows)).to(self.dev)
                for _, refs, rows in chunks]
        scan_args = (index.perm, index.k)
        window_args = (params.window, one_min, three_min, params.least_depth)

        def fused(i):
            return kernels.scan_chunk(db.packed, db.mask, offs[i], table.table, *scan_args,
                                      chunks[i][0], *window_args)

        def plain(i):
            return kernels.scan_chunk_plain(db.packed, db.mask, offs[i], table.table,
                                            *scan_args, chunks[i][0], *window_args)

        def parent(i):
            target, refs, rows = chunks[i]
            counts, hashes = chunk_inputs(db, table, target, refs, rows)
            return kernels.good_windows(counts, hashes, *window_args)

        err, unequal = 0, []
        for i in range(len(chunks)):
            got, want = fused(i), plain(i)
            if not torch.equal(got, want):
                unequal.append(i)
                err = max(err, int((got.int() - want.int()).abs().max()))
        torch.cuda.synchronize()
        positions = sum(rows * target for target, _, rows in chunks)
        self.check(not unequal, f"K4 fused scan_chunk equals its plain version on every one of "
                                f"the {len(chunks)} Phase B chunks ({positions} positions); "
                                f"unequal: {unequal[:8]}")

        picked = [chunks.index(c) for c in picked_chunks(chunks)]
        reps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for i in picked:
                    fused(i)
            torch.cuda.synchronize()
        kernel_us = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "scan_chunk_kernel" in e.name]
        tot = dict(wrapper_ms=0.0, parent_ms=0.0, plain_ms=0.0, floor=0.0, positions=0, reads=0)
        for i in picked:
            target, refs, rows = chunks[i]
            _, hashes = kernels.scan_counts_plain(db.packed, db.mask, offs[i], table.table,
                                                  *scan_args, target)
            reads = int((hashes != 0).sum())
            del hashes
            ms = cuda_ms(lambda: fused(i), 20)
            parent_ms = cuda_ms(lambda: parent(i), 3)
            plain_ms = cuda_ms(lambda: plain(i), 3)
            b, _ = scan_bound(rows * target, rows, reads)
            floor = gather_floor_ms(reads)
            say(f"    chunk {rows:4d} × {target:7d}: wrapper {ms:.4f} ms  parent's route "
                f"{parent_ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b:.4f} ms  table-read "
                f"floor {floor:.4f} ms ({reads} reads)")
            for key, v in (("wrapper_ms", ms), ("parent_ms", parent_ms), ("plain_ms", plain_ms),
                           ("floor", floor), ("positions", rows * target), ("reads", reads)):
                tot[key] += v
        b, by = scan_bound(tot["positions"], sum(chunks[i][2] for i in picked), tot["reads"])
        kernel_ms = sum(kernel_us) / 1e3 / reps if kernel_us else None
        regs = [line for line in ptxas_summary(_build.PTXAS_LOG.get("scan_chunk", ""))
                if line.startswith("scan_chunk_kernel")]
        say(f"  scan_chunk over {len(picked)} chunks, {tot['positions']} positions, "
            f"{tot['reads']} table reads: kernel "
            + (f"{kernel_ms:.4f} ms (profiler, {len(kernel_us)} launches / {reps})"
               if kernel_ms is not None else "not measured (the profiler saw no device events)")
            + f", wrapper {tot['wrapper_ms']:.4f} ms, parent's route {tot['parent_ms']:.4f} ms, "
            f"plain {tot['plain_ms']:.4f} ms, bound {b:.4f} ms ({by}), table-read floor "
            f"{tot['floor']:.4f} ms; ptxas: {'; '.join(regs) or 'no log'}")
        self.records["scan_chunk"] = dict(
            dtype="packed phagedb in, uint8 flags out", max_abs_err=float(err),
            ms=kernel_ms if kernel_ms is not None else tot["wrapper_ms"],
            wrapper_ms=tot["wrapper_ms"], parent_ms=tot["parent_ms"], plain_ms=tot["plain_ms"],
            bound=(b, by), table_read_floor_ms=tot["floor"], library_ms=None,
            chunks=len(picked), all_chunks=len(chunks))

    def k4_at_main_shapes(self, world, table):
        """K4 on the counts and hashes of real Phase B chunks: the first
        chunk of each length bucket, and a chunk with pad rows."""
        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.window import window_thresholds
        from palace_tpu_torch.search.eref import DeviceDB, chunk_inputs, plan_chunks

        index = world[0]
        params = KmerParams(k=EREF_K)
        one_min, three_min = window_thresholds(params.window, params.hit_ratio,
                                               params.perfect_hit_ratio)
        picked = picked_chunks(plan_chunks(index))
        self.check(any(len(refs) < rows for _, refs, rows in picked),
                   "the checked chunks include one with pad rows")
        db = DeviceDB(index, self.dev)
        tot = dict(ms=0.0, plain_ms=0.0, bound=0.0, positions=0, err=0)
        for target, refs, rows in picked:
            counts, hashes = chunk_inputs(db, table, target, refs, rows)

            def k4():
                return kernels.good_windows(counts, hashes, params.window, one_min, three_min)

            def plain():
                return kernels.good_windows_plain(counts, hashes, params.window, one_min,
                                                  three_min)

            got, want = k4(), plain()
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            self.check(torch.equal(got, want),
                       f"K4 good_windows equals its plain version on a chunk of {len(refs)} "
                       f"refs + {rows - len(refs)} pad rows × {target} positions")
            ms, plain_ms = cuda_ms(k4, 20), cuda_ms(plain, 3)
            # bytes: counts and hashes read once, the bits written once; the
            # integer work (about 12 operations a position) is counted at the
            # float32 CUDA-core rate, the data sheet having no int32 rate
            b, _ = bound(nbytes(counts, hashes, got), 12.0 * counts.shape[0] * target,
                         torch.float32)
            say(f"    chunk {rows:4d} × {target:7d}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {b:.4f} ms")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound"] += b
            tot["positions"] += rows * target
            tot["err"] = max(tot["err"], err)
            del counts, hashes, got, want
        say(f"  K4 over {len(picked)} chunks, {tot['positions']} positions: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound {tot['bound']:.4f} ms "
            f"(bytes)")
        self.records["good_windows"] = dict(
            dtype="uint8 counts, int64 hashes", max_abs_err=float(tot["err"]), ms=tot["ms"],
            plain_ms=tot["plain_ms"], bound=(tot["bound"], "bytes"), library_ms=None,
            chunks=len(picked))

    def window_names(self, world, table):
        """``window.good_windows_batch`` on the counts and uint32 hashes of
        phase 9's chunks, cut to a length that is not a multiple of 8, against
        its CPU route, one ``good_windows`` launch a call; ``window.good_windows``
        on one reference row; ``compute_hashes_for_seq`` on a phagedb reference
        on the card against the CPU."""
        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.io.fasta import iter_fasta
        from palace_tpu_torch.ops import window
        from palace_tpu_torch.search.eref import DeviceDB, chunk_inputs, plan_chunks
        from palace_tpu_torch.search.index import compute_hashes_for_seq

        index = world[0]
        params = KmerParams(k=EREF_K)
        args = window.window_thresholds(params.window, params.hit_ratio,
                                        params.perfect_hit_ratio) + (params.least_depth,)
        db = DeviceDB(index, self.dev)
        t0 = time.perf_counter()
        picked = picked_chunks(plan_chunks(index))
        for target, refs, rows in picked:
            counts, hashes = chunk_inputs(db, table, target, refs, rows)
            L = target - 3
            c = counts[:, :L].cpu().numpy()
            h = hashes[:, :L].cpu().numpy().astype(np.uint32)
            got, launches = self.counted(
                lambda: window.good_windows_batch(c, h, params.window, *args, device=self.dev))
            self.launched(f"window names: good_windows_batch on {rows} × {L}", launches,
                          {"good_windows": 1})
            want = window.good_windows_batch(c, h, params.window, *args, device="cpu")
            self.check(got.device.type == self.dev.type and torch.equal(got.cpu(), want),
                       f"good_windows_batch on {rows} rows × {L} positions, uint32 hashes, "
                       f"equal to its CPU route ({int(want.sum())} good)")
        n = min(int(index.lengths[refs[0]]), L)  # the last chunk's first reference
        one, launches = self.counted(lambda: window.good_windows(
            counts[0, :n], hashes[0, :n], params.window, *args))
        self.launched("window names: good_windows", launches, {"good_windows": 1})
        self.check(torch.equal(one.cpu(), window.good_windows_batch(
            c[:1, :n], h[:1, :n], params.window, *args, device="cpu")[0]),
                   f"good_windows on one reference row of {n} positions")
        name, seq = next(iter_fasta(world[1].parent / "db.fasta"))
        card = compute_hashes_for_seq(seq, index.perm, index.k, device=self.dev)
        cpu = compute_hashes_for_seq(seq, index.perm, index.k, device="cpu")
        self.check(card.dtype == np.uint32 and np.array_equal(card, cpu),
                   f"compute_hashes_for_seq on {name} ({len(seq)} bp) on the card equals "
                   f"the CPU's")
        say(f"  window names over {len(picked)} chunks and one reference: "
            f"{time.perf_counter() - t0:.1f} s")

    def per_reference_scan(self, world, table, hits):
        """``good_windows``' own path: ``scan_reference`` over each planted
        reference's counts and hashes (``chunk_inputs`` of a chunk of one),
        with the counters reset just before and read just after; its
        verdicts are Phase B's."""
        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.window import bucket_len, scan_reference
        from palace_tpu_torch.search.eref import DeviceDB, chunk_inputs

        index = world[0]
        params = KmerParams(k=EREF_K)
        db = DeviceDB(index, self.dev)
        n = max(1, EREF_REFS // 50)  # the planted references
        inputs = []
        for r in range(n):
            L = int(index.lengths[r])
            counts, hashes = chunk_inputs(db, table, bucket_len(L), [r], 1)
            inputs.append((r, L, counts[0, :L], hashes[0, :L]))
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = [scan_reference(c, h, r + 1, L, params.window, params.hit_ratio,
                              params.perfect_hit_ratio, params.min_cover_ratio,
                              params.least_depth, device=self.dev) for r, L, c, h in inputs]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        lines = [g.line() for g in got if g is not None]
        self.records["per_reference"] = dict(launches=launches, refs=n, n_hits=len(lines))
        say(f"  scan_reference over {n} references: {len(lines)} hits; launches {launches}")
        self.check(lines == [h.line() for h in hits if h.ref_index <= n],
                   f"scan_reference's {len(lines)} verdicts are Phase B's on refs 1..{n}")
        self.check(launches["good_windows"] == n,
                   f"per-reference path launched good_windows once a reference "
                   f"({launches['good_windows']} launches, {n} references)")

    def phase_b_profile(self, world, table):
        """Phase B's time apart: one whole ``search_references`` under
        torch.profiler, its device time by kernel and in the ``eref.scan``
        span beside the host's parts, ``HOST_PARTS`` (the port's
        GLOBAL_METRICS); then the wall and device time a chunk of the
        fused route over the largest chunks."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.window import window_thresholds
        from palace_tpu_torch.search.eref import (
            DeviceDB,
            chunk_offsets,
            plan_chunks,
            search_references,
        )

        index = world[0]
        params = KmerParams(k=EREF_K)

        def device_ms(prof):
            """Device time by step (the eref.* spans) and by kernel."""
            spans, by_kernel = {}, {}
            for e in prof.key_averages():
                dev_us = getattr(e, "device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(e, "cuda_time_total", 0.0)
                if e.key.startswith("eref."):
                    spans[e.key] = dev_us / 1e3
            for e in prof.events():
                # the spans also show on the device's timeline: count kernels only
                if (e.device_type == torch.autograd.DeviceType.CUDA
                        and not e.name.startswith("eref.")):
                    ms, calls = by_kernel.get(e.name, (0.0, 0))
                    by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
            return spans, by_kernel

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        before = host_parts()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            search_references(table, index, params)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        parts = {n: ms - before[n] for n, ms in host_parts().items()}
        spans, by_kernel = device_ms(prof)
        if not by_kernel:
            say("  device time: not measured (the profiler saw no device events)")
            return
        busy = sum(ms for ms, _ in by_kernel.values())
        say(f"  one Phase B under the profiler: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / wall_ms:.1f}%), eref.scan span {spans.get('eref.scan', 0.0):.2f} "
            f"ms; host clock: {host_parts_line(parts)}; by kernel (ms, calls):")
        for name, (ms, calls) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]:
            say(f"    {ms:9.3f}  {calls:5d}  {name[:90]}")
        self.records["phase_b_split"] = dict(wall_ms=wall_ms, busy_ms=busy, spans=spans,
                                             host_ms=parts)

        one_min, three_min = window_thresholds(params.window, params.hit_ratio,
                                               params.perfect_hit_ratio)
        chunks = sorted(plan_chunks(index), key=lambda c: -c[2] * c[0])[:PROFILE_CHUNKS]
        db = DeviceDB(index, self.dev)
        offs = [torch.from_numpy(chunk_offsets(index, refs, rows)).to(self.dev)
                for _, refs, rows in chunks]

        def run():
            bits = []
            for (target, _, _), o in zip(chunks, offs):
                with record_function("eref.scan"):
                    bits.append(kernels.scan_chunk(db.packed, db.mask, o, table.table,
                                                   index.perm, index.k, target, params.window,
                                                   one_min, three_min, params.least_depth))
            return [b.cpu() for b in bits]

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=activities) as prof:
            run()
            torch.cuda.synchronize()
        spans, by_kernel = device_ms(prof)
        positions = sum(rows * target for target, _, rows in chunks)
        busy = sum(ms for ms, _ in by_kernel.values())
        say(f"  {len(chunks)} chunks, {positions} positions: wall {wall_ms:.2f} ms unprofiled, "
            f"{wall_ms / len(chunks):.3f} ms a chunk; device busy {busy / len(chunks):.3f} ms a "
            f"chunk, eref.scan span {spans.get('eref.scan', 0.0) / len(chunks):.3f} ms a chunk")
        for name, (ms, calls) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]:
            say(f"    {ms / len(chunks):9.3f}  {calls:5d}  {name[:90]}")
        self.records["phase_b_profile"] = dict(spans=spans, busy_ms=busy, chunks=len(chunks),
                                               wall_ms=wall_ms)

    # -- phases 14-15: the graph path (host) ---------------------------------
    def graph_world(self, tmp: Path) -> dict:
        t0 = time.perf_counter()
        world = make_graph_world(tmp, GRAPH_CONTIGS, GRAPH_RECORDS, GRAPH_SEED)
        secs = time.perf_counter() - t0
        size = world["bam"].stat().st_size
        say(f"  world: {world['n_records']} BAM records ({size} bytes of BAM) over "
            f"{world['n_contigs']} contigs of {world['total_bp']} bp; {world['n_junctions']} "
            f"junctions, {len(world['strong'])} with at least 5 split reads of NM <= 5; "
            f"made with the port's write_bam in {secs:.1f} s")
        self.records["graph_world"] = dict(n_records=world["n_records"], bam_bytes=size,
                                           n_contigs=world["n_contigs"],
                                           total_bp=world["total_bp"],
                                           n_junctions=world["n_junctions"], seconds=secs)
        return world

    def graph_path(self, world: dict, tmp: Path):
        """depth → graph → fastg2fa → matching → makefa through the port's
        CLI (``run_graph_path``): the stages took the native program (or the
        Python one where it could not be built); the graph holds every
        junction with 5 good split reads and no junction that was not
        planted; the Python builder writes the same graph from the same BAM;
        and which solver the matching ran."""
        from palace_tpu_torch import cli
        from palace_tpu_torch.graph import native
        from palace_tpu_torch.matching import solver

        out = tmp / "graph_path"
        out.mkdir()
        route = self.host_route()
        runs, solvers = dict(native.RUNS), dict(solver.SOLVERS)
        res = run_graph_path(cli.main, world, out)
        runs = {n: native.RUNS[n] - runs[n] for n in runs}
        solvers = {n: solver.SOLVERS[n] - solvers[n] for n in solvers}
        secs, n = res["seconds"], world["n_records"]
        self.check(runs[f"graph.{route}"] == 1 and runs[f"depth.{route}"] == 1,
                   f"graph and depth took the {route} route ({runs})")
        say("  " + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
            + f"; {route} graph {n / secs['graph']:.0f} records/s, depth "
            f"{n / secs['depth']:.0f} records/s; average depth {res['avg_depth']:.4f}")
        try:
            import networkx
            nx_version = networkx.__version__
        except ImportError:
            nx_version = None
        say(f"  matching: {solvers['exact']} components by the exact blossom matcher "
            f"(networkx {nx_version or 'absent'}), {solvers['handshake']} by the handshake")
        junctions = graph_junctions(out / "graph.txt")
        segs = (out / "graph.txt").read_text().count("SEG ")
        self.check(segs == world["n_contigs"] and world["strong"] <= junctions <= world["planted"],
                   f"graph: {segs} SEG lines, {len(junctions)} JUNC lines: all "
                   f"{len(world['strong'])} junctions of 5 good split reads, none unplanted")
        paths = [l for l in (out / "paths.txt").read_text().splitlines()
                 if l.strip() and not l.startswith(("iter", "self"))]
        fasta = (out / "paths.fa").read_text().split(">")[1:]
        self.check(len(fasta) == len(paths) > 0 and all(r.split("\n")[1] for r in fasta),
                   f"makefa: {len(fasta)} path sequences, one a path of the matching")
        t0 = time.perf_counter()
        native.build_graph(world["bam"], world["fai"], out / "graph.python.txt",
                           res["avg_depth"], prefer_native=False)
        py_s = time.perf_counter() - t0
        same = (out / "graph.python.txt").read_bytes() == (out / "graph.txt").read_bytes()
        self.check(same, f"the Python builder's graph of the same {n} records equals the "
                         f"{route} one's: {py_s:.3f} s, {n / py_s:.0f} records/s")
        self.records["graph_path"] = dict(route=route, seconds=secs, python_graph_s=py_s,
                                          solvers=solvers, networkx=nx_version,
                                          junctions=len(junctions), paths=len(fasta))

    # -- phases 16-17: the pipeline -----------------------------------------
    def pipeline_world(self, tmp: Path) -> dict:
        t0 = time.perf_counter()
        world = make_pipeline_world(tmp, PIPELINE_SEED, PIPELINE_PHAGES, PIPELINE_OTHERS,
                                    PIPELINE_DECOYS, PIPELINE_KEYS)
        secs = time.perf_counter() - t0
        genomes = world["genomes"]
        files = (world["fasta"], world["bam"], *world["fastqs"], world["phagedb"], world["model"])
        sizes = {f.name: f.stat().st_size for f in files}
        say(f"  world: {len(genomes)} planted phages ({sum(g['circular'] for g in genomes)} "
            f"circular, {sum(len(g['genome']) for g in genomes)} bp) in an assembly of "
            f"{world['n_contigs']} contigs, {world['assembly_bp']} bp, "
            f"{world['n_junctions']} planted junctions; {world['n_records']} BAM records; "
            f"{world['n_pairs']} read pairs of {READ_LEN} bp; a phagedb of "
            f"{len(world['ref_names'])} references, {world['phagedb_bp']} bp; "
            f"made in {secs:.1f} s")
        say("  bytes: " + ", ".join(f"{name} {n}" for name, n in sizes.items()))
        self.records["pipeline_world"] = dict(
            seconds=secs, bytes=sizes, **{k: world[k] for k in (
                "n_contigs", "assembly_bp", "n_records", "n_pairs", "n_junctions", "phagedb_bp")})
        return world

    def pipeline(self, world: dict):
        """``run_pipeline(cfg, device=...)`` on the pipeline world, every
        launch counter reset just before and read just after: the scorer
        launched K1 and K2 once and K3 three times a batch and eref
        ``scan_chunk`` once a chunk of ``plan_chunks``, ``good_windows``
        never; ``node_scores.out`` names every contig in order, and
        ``PIPELINE_RESCORED`` of them drawn with the seed agree with the
        plain path on the CPU in float32; the references are exactly the
        planted ones; the final FASTA holds every planted genome."""
        import gc

        from palace_tpu_torch.config import PalaceConfig
        from palace_tpu_torch.io.fasta import iter_fasta
        from palace_tpu_torch.models import gcn
        from palace_tpu_torch.models.scoring import score_sequences
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.pipeline.driver import run_pipeline
        from palace_tpu_torch.search.eref import plan_chunks
        from palace_tpu_torch.search.index import load_index
        from palace_tpu_torch.utils.timers import GLOBAL_METRICS

        cfg = PalaceConfig.from_file(world["config"])
        cuda = self.dev.type == "cuda"
        gc.collect()  # the earlier phases' tables and models
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        GLOBAL_METRICS.stages.clear()
        kernels.reset_launches()
        t0 = time.perf_counter()
        final = run_pipeline(cfg, device=self.dev)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        out = cfg.output_files()
        metrics = json.loads((Path(cfg.out_dir) / f"{cfg.prefix}_metrics.json").read_text())
        steps = {k: v["seconds"] for k, v in metrics.items() if k.startswith("step")}
        stages = {k[len("stage:"):]: v["seconds"] for k, v in metrics.items()
                  if k.startswith("stage:")}
        score, count = metrics["gcn.score"], metrics["eref.count_reads"]
        scan = metrics["eref.scan_refs"]
        say(f"  run_pipeline on {self.dev.type}: {wall:.3f} s; "
            + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(steps.items())))
        say("  its stages (StageRunner): "
            + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
        say(f"  scorer {score['items']:.0f} contigs in {score['seconds']:.3f} s, "
            f"{score['throughput']:.1f} contigs/s ({cfg.score.dtype}, batch {cfg.score.batch_size}); "
            f"eref index build {metrics.get('eref.index_build', {}).get('seconds', 0.0):.3f} s, "
            f"Phase A {count['seconds']:.3f} s ({count['items']:.0f} reads), Phase B "
            f"{scan['seconds']:.3f} s; peak device memory {peak / 2**30:.2f} GiB; "
            f"launches {launches}")

        names = [n for n, _ in iter_fasta(world["fasta"])]
        n_batches = -(-len(names) // cfg.score.batch_size)
        n_chunks = len(plan_chunks(load_index(cfg.phagedb, cfg.kmer.k)))
        for name, n in (("transition_counts", n_batches), ("sage_rounds", n_batches),
                        ("conv_head", 3 * n_batches), ("scan_chunk", n_chunks),
                        ("good_windows", 0)):
            self.check(launches[name] == n, f"pipeline launched {name} {n} times "
                                            f"(got {launches[name]})")

        rows = [line.split("\t") for line in out["node_score"].read_text().splitlines()]
        probs = np.array([float(p) for _, p in rows])
        self.check([n for n, _ in rows] == names and bool(np.isfinite(probs).all())
                   and bool(((probs >= 0) & (probs <= 1)).all()),
                   f"node_scores.out names the {len(names)} records of assembly_graph.fasta in "
                   f"order; probabilities finite, in [0, 1], spread {np.ptp(probs):.3f}")
        pick = np.sort(np.random.default_rng(PIPELINE_SEED).choice(
            len(names), min(PIPELINE_RESCORED, len(names)), replace=False))
        seqs = dict(iter_fasta(world["fasta"]))
        params = gcn.load_torch_state_dict(cfg.gcn_model, gcn.DEFAULT_CONFIG)
        want = np.array([p for _, p in score_sequences(
            params, [(names[i], seqs[names[i]]) for i in pick], gcn.DEFAULT_CONFIG,
            batch_size=len(pick), device="cpu")])
        err = float(np.abs(probs[pick] - want).max())
        self.check(err <= PROB_ATOL, f"{len(pick)} contigs drawn with the seed, rescored on the "
                                     f"CPU through the plain path in float32: max |dp| "
                                     f"{err:.3g} <= {PROB_ATOL}")

        hits = [int(line.split("\t")[1]) for line in out["ref_names"].read_text().splitlines()]
        reported = sorted(world["ref_names"][i - 1] for i in hits)
        planted = sorted(g["name"] for g in world["genomes"])
        self.check(reported == planted, f"{out['ref_names'].name} names exactly the "
                                        f"{len(planted)} planted references ({reported})")
        found, others = reconstructed(final, world["genomes"])
        n_circ = sum(g["circular"] for g in world["genomes"])
        self.check(len(found) == len(planted),
                   f"{final.name} holds {len(found)} of the {len(planted)} planted genomes "
                   f"({n_circ} circular up to rotation and reverse complement, "
                   f"{len(planted) - n_circ} linear), modulo the 50-N joints")
        say(f"  {others} other record(s) in {final.name}: non-phage contigs the "
            f"random-weight scores let through")
        self.records["pipeline"] = dict(
            wall_s=wall, steps=steps, stages=stages, launches=launches, peak_bytes=peak,
            n_batches=n_batches, n_chunks=n_chunks, contigs_per_s=score["throughput"],
            score_s=score["seconds"],
            phase_a_s=count["seconds"], phase_b_s=scan["seconds"], rescore_err=err,
            found=found, others=others, final_bytes=final.read_bytes(),
            scores=([n for n, _ in rows], probs))

    # -- phases 18-19: training -------------------------------------------
    def train_world(self) -> dict:
        """``make_contigs(2048, 10 kb, gc_spread)``, labelled 1 above the
        median GC share; their features through K1 on the card with the
        launch counters reset just before and read just after; a seeded
        split of 1,792 to train on and 256 held out."""
        from palace_tpu_torch.ops import kernels

        contigs = make_contigs(TRAIN_CONTIGS, CONTIG_LEN, TRAIN_SEED, gc_spread=True)
        gc = np.array([(s.count("G") + s.count("C")) / len(s) for _, s in contigs])
        labels = torch.from_numpy((gc > np.median(gc)).astype(np.int64))
        kernels.reset_launches()
        feats = train_features([s for _, s in contigs], self.dev)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        self.check(launches["transition_counts"] == 1,
                   f"training features of {len(contigs)} contigs through K1: launched "
                   f"transition_counts once (got {launches['transition_counts']})")
        perm = np.random.default_rng(TRAIN_SEED).permutation(len(contigs))
        held, train = np.sort(perm[:TRAIN_HELD_OUT]), perm[TRAIN_HELD_OUT:]
        say(f"  {len(contigs)} contigs of {CONTIG_LEN} bp, {int(labels.sum())} labelled 1 "
            f"(GC above the median {np.median(gc):.4f}); features {tuple(feats.shape)} "
            f"{feats.dtype}; {len(train)} to train on, {len(held)} held out")
        return dict(contigs=contigs, labels=labels, feats=feats,
                    train=torch.from_numpy(train), held=held)

    def train_step_against_cpu(self, world: dict):
        """Check a: one step at batch 64, dropout off, same parameters and
        batch, on the card (float32, TF32 switched on globally: the training
        path must keep float32) and on the CPU (float32): the losses within
        ``TRAIN_LOSS_RTOL``; each gradient tensor, over its own largest
        magnitude, held to a float64 step on the card.  The card's worst
        error may be at most ``GRAD_ERR_RATIO`` times the CPU's: its step
        is as exact as the CPU's.  At the published width and these
        features float32 itself lies ~4e-3 from float64 on either device,
        so a fixed 1e-4 between two float32 runs cannot hold; the same
        step with TF32 and no guard must fall outside."""
        import dataclasses

        from palace_tpu_torch.models.gcn import (TrainableGCN, init_params,
                                                 model_inputs_from_features)
        from palace_tpu_torch.models.train import loss_fn, value_and_grad

        cfg = dataclasses.replace(train_cfg(), drop_rate=0.0)
        params = init_params(torch.Generator(device=self.dev).manual_seed(TRAIN_SEED), cfg)
        idx = world["train"][:TRAIN_BATCH]
        xb, yb = world["feats"][idx.to(self.dev)], world["labels"][idx]
        cpu = torch.device("cpu")

        def step(dev, dtype, tf32=False, guard=True):
            model = TrainableGCN(params, cfg).to(dev, dtype)
            x_p, x_f = model_inputs_from_features(xb.to(dev, dtype), cfg)
            set_tf32(tf32)
            try:
                if guard:
                    loss, grads = value_and_grad(model, x_p, x_f, yb.to(dev), cfg)
                else:  # value_and_grad without full_float32
                    loss = loss_fn(model.params(), x_p, x_f, yb.to(dev), cfg)
                    loss.backward()
                    loss = loss.detach()
                    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                             for n, p in model.params().items()}
            finally:
                set_tf32(False)
            return float(loss), {n: g.detach().double().cpu() for n, g in grads.items()}

        def errs(grads, ref):
            """max |g - ref| / max |ref| of each tensor."""
            out = {}
            for name, want in ref.items():
                scale = float(want.abs().max())
                d = float((grads[name] - want).abs().max())
                out[name] = d / scale if scale else (d and float("inf"))
            return out

        def err(grads, ref):
            return max(errs(grads, ref).values())

        loss64, ref = step(self.dev, torch.float64)
        loss_c, card = step(self.dev, torch.float32, tf32=True)
        loss_h, host = step(cpu, torch.float32)
        _, bare = step(self.dev, torch.float32, tf32=True, guard=False)
        rel = abs(loss_c - loss_h) / abs(loss_h)
        self.check(rel <= TRAIN_LOSS_RTOL, f"one step at batch {TRAIN_BATCH}, dropout off, TF32 "
                                           f"on globally: loss {loss_c:.7f} on the card, "
                                           f"{loss_h:.7f} on the CPU ({loss64:.7f} in float64), "
                                           f"{rel:.3g} relative <= {TRAIN_LOSS_RTOL}")
        e_card, e_cpu, e_bare = err(card, ref), err(host, ref), err(bare, ref)
        e_pair = err(card, host)
        say(f"  gradients over their largest magnitude, worst of {len(ref)} tensors: card "
            f"float32 {e_card:.3g} from float64, CPU float32 {e_cpu:.3g}, card from CPU "
            f"{e_pair:.3g}; with TF32 and no guard {e_bare:.3g}")
        for name, e in (("card", errs(card, ref)), ("CPU", errs(host, ref))):
            say(f"    {name} float32, the largest by tensor: " + ", ".join(
                f"{n} {v:.3g}" for n, v in sorted(e.items(), key=lambda kv: -kv[1])[:6]))
        self.check(e_card <= GRAD_ERR_RATIO * e_cpu,
                   f"the card's float32 gradients are as exact as the CPU's: {e_card:.3g} <= "
                   f"{GRAD_ERR_RATIO} x {e_cpu:.3g}")
        self.check(e_bare > GRAD_ERR_RATIO * e_cpu,
                   f"TF32 without the guard falls outside: {e_bare:.3g} > {GRAD_ERR_RATIO} x "
                   f"{e_cpu:.3g}")
        self.records["train_step_cpu"] = dict(loss_rel=rel, grad_err_card=e_card,
                                              grad_err_cpu=e_cpu, grad_err_pair=e_pair,
                                              grad_err_tf32=e_bare)

    def train_learns(self, world: dict, tmp: Path) -> dict:
        """Check b: ``fit`` for two epochs on the card, the launch counters
        reset just before and read just after (the training path launches no
        kernel: JAX's trains through XLA, not Pallas); the mean loss falls
        from epoch 1 to 2 and nothing is NaN.  Then check c: the state saved
        and restored bit-equal, and a resumed ``fit`` against the
        uninterrupted one from the same state."""
        from palace_tpu_torch.models.checkpoint import (checkpoint_path, restore_train_state,
                                                        save_train_state)
        from palace_tpu_torch.models.gcn import init_params
        from palace_tpu_torch.models.train import adam_moments, fit, init_train_state
        from palace_tpu_torch.ops import kernels

        cfg, dev, cuda = train_cfg(), self.dev, self.dev.type == "cuda"
        feats, labels = world["feats"][world["train"].to(dev)], world["labels"][world["train"]]
        n_steps = TRAIN_EPOCHS * -(-len(labels) // TRAIN_BATCH)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, losses = fit(feats, labels, cfg, epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
                            learning_rate=TRAIN_LR, seed=TRAIN_SEED, device=dev)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        n_params = sum(p.numel() for p in state.model.parameters())
        say(f"  fit: {state.step} steps of {TRAIN_BATCH} ({TRAIN_EPOCHS} epochs of {len(labels)}), "
            f"{cfg} ({n_params} parameters), lr {TRAIN_LR}: {wall:.3f} s with the "
            f"initialisation, {n_steps * TRAIN_BATCH / wall:.1f} contigs/s; epoch losses "
            f"{losses}; peak device memory {peak / 2**30:.3f} GiB; launches {launches}")
        self.check(not any(launches.values()), f"the training path launched no kernel "
                                              f"({launches})")
        finite = all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
        fit_steps = state.step
        self.check(fit_steps == n_steps and losses[-1] < losses[0] and finite
                   and bool(np.isfinite(losses).all()),
                   f"{fit_steps} steps; mean loss falls from epoch 1 to {TRAIN_EPOCHS} "
                   f"({losses[0]:.6f} -> {losses[-1]:.6f}); losses and parameters finite")

        # check c: the round trip, then a resumed fit against the uninterrupted one
        ckpt = tmp / "ckpt"
        t0 = time.perf_counter()
        save_train_state(ckpt, state)
        save_s = time.perf_counter() - t0
        nbytes_ckpt = checkpoint_path(ckpt, state.step).stat().st_size
        template = init_train_state(init_params(torch.Generator(device=dev).manual_seed(
            TRAIN_SEED + 1), cfg), cfg, TRAIN_LR, dev)
        t0 = time.perf_counter()
        restored = restore_train_state(ckpt, template)
        if cuda:
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        (mu, nu, count), (mu2, nu2, count2) = adam_moments(state), adam_moments(restored)
        equal = (restored.step == state.step and count == count2 and all(
            torch.equal(p, restored.model.params()[n]) and torch.equal(mu[n], mu2[n])
            and torch.equal(nu[n], nu2[n]) for n, p in state.model.params().items()))
        say(f"  checkpoint: {nbytes_ckpt} bytes, saved in {save_s:.3f} s, restored in "
            f"{restore_s:.3f} s")
        self.check(equal, f"checkpoint of step {state.step} saved and restored on the card: "
                          f"parameters, Adam's moments and step, the train step bit-equal")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            _, cont = fit(feats, labels, cfg, epochs=1, batch_size=TRAIN_BATCH,
                          learning_rate=TRAIN_LR, seed=TRAIN_SEED + 2, init_state=state,
                          device=dev)
            resumed, res = fit(feats, labels, cfg, epochs=1, batch_size=TRAIN_BATCH,
                               learning_rate=TRAIN_LR, seed=TRAIN_SEED + 2, ckpt_dir=ckpt,
                               init_state=template, device=dev)
        finally:
            torch.use_deterministic_algorithms(False)
        rel = abs(res[0] - cont[0]) / abs(cont[0])
        same = all(torch.equal(p, resumed.model.params()[n])
                   for n, p in state.model.params().items())
        self.check(resumed.step == state.step == n_steps + n_steps // TRAIN_EPOCHS
                   and rel <= RESUME_RTOL,
                   f"fit resumed from the checkpoint continues to step {resumed.step} (the "
                   f"uninterrupted run: {state.step}); its epoch loss {res[0]:.7f} against "
                   f"{cont[0]:.7f}, {rel:.3g} relative <= {RESUME_RTOL} (deterministic "
                   f"algorithms; parameters {'bit-equal' if same else 'not bit-equal'})")
        self.records["train"] = dict(
            wall_s=wall, steps=fit_steps, losses=losses, peak_bytes=peak, launches=launches,
            n_params=n_params, ckpt_bytes=nbytes_ckpt, save_s=save_s, restore_s=restore_s,
            resume_rel=rel, resume_bit_equal=same)
        del template, resumed
        return state

    def trained_through_kernels(self, world: dict, state):
        """Check d: the trained parameters in ``GCNScorer`` score the held-out
        contigs through ``score_sequences`` on the card (K1-K3, the counters
        reset just before and read just after), against the training
        module's eval forward on their K1 features; the held-out accuracy."""
        from palace_tpu_torch.models.gcn import model_inputs_from_features
        from palace_tpu_torch.models.scoring import score_sequences
        from palace_tpu_torch.ops import kernels

        cfg, dev = train_cfg(), self.dev
        held = [world["contigs"][i] for i in world["held"]]
        kernels.reset_launches()
        got = np.array([p for _, p in score_sequences(state.model.params(), held, cfg,
                                                        batch_size=TRAIN_BATCH, device=dev)])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        n_batches = -(-len(held) // TRAIN_BATCH)
        for name, n in (("transition_counts", n_batches), ("sage_rounds", n_batches),
                        ("conv_head", 3 * n_batches)):
            self.check(launches[name] == n, f"scoring the held-out contigs launched {name} "
                                            f"{n} times (got {launches[name]})")
        with torch.no_grad():
            x_p, x_f = model_inputs_from_features(
                world["feats"][torch.from_numpy(world["held"]).to(dev)], cfg)
            want = state.model(x_p, x_f)[:, 1].cpu().numpy()
        err = float(np.abs(got - want).max())
        labels = world["labels"][torch.from_numpy(world["held"])].numpy()
        acc = float(((got > 0.5) == labels).mean())
        self.check(err <= PROB_ATOL, f"trained parameters through K1-K3 (score_sequences) "
                                     f"against the training module's eval forward on "
                                     f"{len(held)} held-out contigs: max |dp| {err:.3g} <= "
                                     f"{PROB_ATOL}")
        say(f"  held-out accuracy {acc:.4f} (P > 0.5 against GC above the median; not "
            f"checked), probabilities {got.min():.4f}..{got.max():.4f}")
        self.records["train_scored"] = dict(err=err, accuracy=acc, launches=launches)

    def train_numbers(self, world: dict, state):
        """ms a step (CUDA events, the median of ``TRAIN_TIMED_STEPS`` after
        warm-up), contigs trained a second, and a step's device time by part
        from torch.profiler, over ``TRAIN_PROFILED_STEPS`` steps after one."""
        from torch.profiler import ProfilerActivity, profile

        from palace_tpu_torch.models.gcn import model_inputs_from_features
        from palace_tpu_torch.models.train import train_step

        cfg, dev = train_cfg(), self.dev
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 3)
        idx = world["train"][:TRAIN_BATCH].to(dev)
        x_p, x_f = model_inputs_from_features(world["feats"][idx], cfg)
        y = world["labels"][world["train"][:TRAIN_BATCH]].to(dev)

        def step():
            train_step(state, x_p, x_f, y, gen, cfg, TRAIN_LR)

        times = cuda_times_ms(step, TRAIN_TIMED_STEPS)
        ms = float(np.median(times))
        say(f"  train_step at batch {TRAIN_BATCH}, {DT_NAME[torch.float32]}: median {ms:.3f} ms "
            f"({' / '.join(f'{t:.3f}' for t in times)}), {TRAIN_BATCH / ms * 1e3:.1f} "
            f"contigs trained a second")
        steps = torch.profiler.schedule(wait=0, warmup=1, active=TRAIN_PROFILED_STEPS, repeat=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=steps) as prof:
            for _ in range(1 + TRAIN_PROFILED_STEPS):
                step()
                prof.step()
            if dev.type == "cuda":
                torch.cuda.synchronize()
        split = {k: v / TRAIN_PROFILED_STEPS for k, v in step_split(prof.events()).items()}
        busy = sum(split.values())
        # the device's own events, not the ranges' annotations on its timeline
        kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and not e.is_user_annotation) / 1e3 / TRAIN_PROFILED_STEPS
        if not busy:
            say("  one step by part: not measured (the profiler saw no device time)")
        else:
            say(f"  a step by part (torch.profiler, device ms, the mean of "
                f"{TRAIN_PROFILED_STEPS} steps; {busy:.3f} ms attributed of "
                f"{kernel_ms:.3f} ms of device events): "
                + ", ".join(f"{k} {v:.3f}" for k, v in sorted(split.items(),
                                                               key=lambda kv: -kv[1])))
        self.records["train_step"] = dict(ms=ms, times=times, split=split, busy_ms=busy,
                                          kernel_ms=kernel_ms,
                                          contigs_per_s=TRAIN_BATCH / ms * 1e3)

    # -- phases 20-21: the GCN across devices ------------------------------
    def mesh_one_rank(self, tmp: Path) -> dict:
        """Phase 20: a one-rank process group (NCCL on a card, gloo on the
        CPU) and its (1, 1) mesh: ``score_sequences(mesh=...)`` on the mesh
        world in float32 and bfloat16 (the launch counters reset just before
        and read just after) against the same call without a mesh, and one
        ``train_step`` against the same step without one.  Returns the
        probabilities without a mesh, which phase 21 holds its ranks to."""
        import torch.distributed as dist

        from palace_tpu_torch.models.scoring import score_sequences
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.parallel import distributed, make_mesh

        job, dev, cuda = mesh_job(self.dev.type), self.dev, self.dev.type == "cuda"
        world = mesh_world(job, dev)
        n_batches = -(-len(world["contigs"]) // BATCH)
        distributed.initialize(f"file://{tmp / 'one_rank_store'}", 1, 0, device=dev.type)
        try:
            mesh = make_mesh(device=dev.type)
            say(f"  one rank, backend {dist.get_backend()}, (data, model) = ({mesh.dp}, "
                f"{mesh.mp}) on {mesh.device}; {len(world['contigs'])} contigs of "
                f"{CONTIG_LEN} bp (GC spread), batch {BATCH}")
            refs = {}
            for name, dtype, atol in (("float32", None, PROB_ATOL),
                                      ("bfloat16", torch.bfloat16, PROB_ATOL_BF16)):
                want = np.array([p for _, p in score_sequences(
                    world["params"], world["contigs"], job["cfg"], BATCH, dtype=dtype,
                    device=dev)])
                kernels.reset_launches()
                got = np.array([p for _, p in score_sequences(
                    world["params"], world["contigs"], job["cfg"], BATCH, dtype=dtype,
                    mesh=mesh)])
                if cuda:
                    torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)
                err = float(np.abs(got - want).max())
                self.check(err <= atol and np.ptp(want) > 0.05,
                           f"one rank, {name}: score_sequences(mesh=...) against no mesh, max "
                           f"|dp| {err:.3g} <= {atol}, probabilities spread {np.ptp(want):.3f}")
                self._check_scoring_launches(launches, n_batches, f"one rank, {name}")
                refs[name] = want
            ref = one_rank_reference(world, job, dev)
            loss, state = mesh_step(world, job, mesh=mesh)
            self._check_step("one rank", loss, ref["loss"], ref["err64"],
                             shard_diffs(state, ref), job["lr"])
            del state, ref
        finally:
            dist.destroy_process_group()
        return refs

    def _check_scoring_launches(self, launches: dict, n_batches: int, what: str) -> None:
        want = {"transition_counts": n_batches, "sage_rounds": n_batches,
                "conv_head": 3 * n_batches}
        self.check(all(launches[k] == n for k, n in want.items()),
                   f"{what}: launched K1, K2, K3 {want} a scoring (got "
                   f"{ {k: launches[k] for k in want} })")

    def _check_step(self, what: str, loss: float, ref_loss: float, ref_err64: float,
                    split: dict, lr: float) -> None:
        """A sharded step against the one-rank step: the loss within
        ``MESH_LOSS_RTOL``; the split parameters' gradients as exact as the
        one-rank step's, from the same float64 step (at most
        ``GRAD_ERR_RATIO`` times its error, check a's criterion: float32 at
        this width lies ~1e-3 from float64 in either package, so two float32
        routes that add in another order can lie as far apart); the updated
        shards within ``MESH_PARAM_ATOL`` but for ``MESH_PARAM_SHARE`` of the
        elements, each within 2·lr (Adam moves an element ±lr whatever the
        size of its gradient)."""
        rel = abs(loss - ref_loss) / abs(ref_loss)
        self.check(rel <= MESH_LOSS_RTOL, f"{what}: train_step loss {loss:.7f} against the "
                                          f"one-rank {ref_loss:.7f}, {rel:.3g} relative <= "
                                          f"{MESH_LOSS_RTOL}")
        worst = max(d["err64"] for d in split.values())
        self.check(worst <= GRAD_ERR_RATIO * ref_err64,
                   f"{what}: the split parameters' gradients {worst:.3g} of their largest "
                   f"magnitude from the float64 step, the one-rank step's {ref_err64:.3g} "
                   f"(<= {GRAD_ERR_RATIO} x)")
        for name, d in split.items():
            self.check(d["share"] <= MESH_PARAM_SHARE
                       and d["param_diff"] <= 2 * lr + MESH_PARAM_ATOL,
                       f"{what}: {name} shard {d['shape']}: gradient {d['grad_err']:.3g} of its "
                       f"largest magnitude from the one-rank step's; updated, {d['share']:.3g} "
                       f"of the elements past {MESH_PARAM_ATOL} (<= {MESH_PARAM_SHARE}), the "
                       f"largest {d['param_diff']:.3g} (<= 2·lr)")

    def mesh_two_ranks(self, refs: dict, tmp: Path) -> None:
        """Phase 21: ``MESH_RANKS`` processes on the one card under gloo
        with its tensors on the card (NCCL will not put two ranks on one
        card), each layout of ``MESH_MODEL_PARALLEL``: the scorer against
        phase 20's one-rank probabilities, K1-K3 launched on every rank,
        one ``train_step`` against the one-rank step, and under (1, ranks)
        a checkpoint restored on one rank equal to the gathered state.  Its
        contigs/s and memory are of processes that share one card: not
        scaling."""
        job = dict(mesh_job(self.dev.type), ref_probs=refs)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ranks = spawn_ranks(mesh_rank, MESH_RANKS, job, tmp / "ranks", MESH_TIMEOUT_S)
        n_batches = -(-job["n_contigs"] // job["batch"])
        self.records["mesh"] = {}
        for layout in ranks[0]["layouts"]:
            recs = [r["layouts"][layout] for r in ranks]
            what = f"(data, model) = {layout}"
            for r, rec in enumerate(recs):
                for name, atol in (("float32", PROB_ATOL), ("bfloat16", PROB_ATOL_BF16)):
                    self.check(rec[name]["err"] <= atol and rec[name]["in_order"],
                               f"{what}, rank {r} {rec['coords']}, {name}: every contig in "
                               f"input order, max |dp| {rec[name]['err']:.3g} from one rank "
                               f"<= {atol}")
                    self._check_scoring_launches(rec[name]["launches"], n_batches,
                                                 f"{what}, rank {r}, {name}")
                say(f"  {what}, rank {r}: launches (bf16) "
                    f"{ {k: rec['bfloat16']['launches'][k] for k in SCORING_KERNELS} }")
                self._check_step(f"{what}, rank {r}", rec["loss"], rec["ref_loss"],
                                 rec["ref_err64"], rec["split"], job["lr"])
            if "checkpoint_equal" in recs[0]:
                self.check(recs[0]["checkpoint_equal"],
                           f"{what}: the checkpoint rank 0 wrote, restored on one rank, equals "
                           f"the gathered state (parameters, Adam's moments and steps)")
            say(f"  {what} ({MESH_RANKS} processes sharing one card, not scaling): bf16 "
                + ", ".join(f"rank {r} {rec['contigs_per_s']:.1f} contigs/s, peak "
                            f"{rec['peak_bytes'] / 2**30:.3f} GiB, collectives "
                            f"{rec['collective_ms_per_batch']:.3f} ms a batch "
                            f"({rec['collective_calls']} calls)"
                            for r, rec in enumerate(recs)))
            self.records["mesh"][layout] = recs

    def eref_against_cpu(self, tmp: Path):
        """``run_search`` on a small world (k = 20) on the card and on the
        CPU's plain path: byte-identical ``ref_names.txt``."""
        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.search.eref import run_search
        from palace_tpu_torch.search.index import build_index

        db, fq1, fq2 = make_small_eref_world(tmp)
        index = build_index(db, k=SMALL_K, save=False)
        params = KmerParams(k=SMALL_K)
        outs = {}
        for dev in (self.dev, torch.device("cpu")):
            out = tmp / f"ref_names.{dev.type}.txt"
            hits = run_search(fq1, fq2, index, params, out, device=dev)
            outs[dev.type] = (out.read_bytes(), len(hits))
        (card, n), (cpu, _) = outs[self.dev.type], outs["cpu"]
        say("  " + card.decode().replace("\n", "\n  ").rstrip())
        self.check(card == cpu and n > 0,
                   f"small world (k={SMALL_K}, {index.n_refs} refs): {n} hits, ref_names.txt "
                   f"on the card byte-identical to the CPU's")


    # -- phases 22-24: eref and the pipeline across devices --------------------
    def eref_mesh_one_rank(self, world, tmp: Path) -> None:
        """Phase 22: a one-rank process group (NCCL on a card, gloo on the
        CPU) and its mesh on phase 7's world: ``run_search(mesh=...)`` with
        the launch counters reset just before and read just after, against
        phase 8's hits and ``ref_names.txt``; then ``scan_hits`` and
        ``window_hits`` against their plain versions on real chunks, timed
        beside ``scan_chunk``.  Saves the index for phase 23's ranks."""
        import torch.distributed as dist

        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.parallel import distributed, make_mesh
        from palace_tpu_torch.search.eref import (count_reads_into_table, plan_chunks,
                                                  run_search)
        from palace_tpu_torch.search.index import save_index

        index, fq, _ = world
        fqs, params = split_reads(Path(fq)), KmerParams(k=EREF_K)
        save_index(Path(fq).with_name("db.fasta"), index)
        cuda, n_chunks = self.dev.type == "cuda", len(plan_chunks(index))
        out = tmp / "ref_names.one_rank.txt"
        distributed.initialize(f"file://{tmp / 'eref_one_rank_store'}", 1, 0, device=self.dev.type)
        try:
            mesh = make_mesh(device=self.dev.type)
            say(f"  one rank, backend {dist.get_backend()}, (data, model) = ({mesh.dp}, "
                f"{mesh.mp}) on {mesh.device}; the reads of phase 8 as {fqs[0].name} + "
                f"{fqs[1].name}")
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            hits = run_search(*fqs, index, params, out, mesh=mesh)
            if cuda:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            say(f"  run_search(mesh=...): {secs:.3f} s, peak {peak / 2**30:.3f} GiB, "
                f"launches {launches}")
            self.check(len(hits) == EREF_JAX_HITS and out.read_bytes()
                       == self.records["eref"]["ref_names"],
                       f"one rank: {len(hits)} hits ({EREF_JAX_HITS} from the JAX package), "
                       f"ref_names.txt byte-identical to phase 8's")
            self.check(launches["scan_hits"] == launches["window_hits"] == n_chunks
                       and launches["scan_chunk"] == 0 and launches["hit_filter"] == 1,
                       f"one rank: launched scan_hits and window_hits once a chunk and "
                       f"scan_chunk never ({launches['scan_hits']}, {launches['window_hits']}, "
                       f"{launches['scan_chunk']}; {n_chunks} chunks), hit_filter once a Phase B "
                       f"({launches['hit_filter']})")
            self.records["eref_mesh"] = dict(seconds=secs, launches=launches, peak_bytes=peak)
            table = count_reads_into_table(fqs, index, params, mesh=mesh)
            self.sharded_kernels(index, table)
        finally:
            dist.destroy_process_group()

    def sharded_kernels(self, index, table) -> None:
        """``scan_hits`` and ``window_hits`` against their plain versions on
        the first chunk of each length bucket and one with pad rows, and
        ``window_hits`` of one rank's planes against ``scan_chunk`` on the
        same table; the device time of each kernel on those chunks
        (torch.profiler, and CUDA events around the wrappers, whose offsets
        check synchronizes), its bound and its plain version's time; then
        ``scan_hits`` at the shard ranges of 2 and 4 ranks (``SHARD_WORLDS``,
        rank 0's and the last rank's share, each a slice of the table), equal
        to its plain version, timed against the bound of its own reads."""
        from palace_tpu_torch.config import KmerParams
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.window import window_thresholds
        from palace_tpu_torch.search.eref import DeviceDB, chunk_offsets, plan_chunks

        params = KmerParams(k=EREF_K)
        win = (params.window, *window_thresholds(params.window, params.hit_ratio,
                                                 params.perfect_hit_ratio))
        db, picked = DeviceDB(index, self.dev), picked_chunks(plan_chunks(index))
        scan = (index.perm, index.k)
        shares = shard_shares(1 << index.k)
        filt = self.hit_filter_phase(table.table, params.least_depth)
        share_filt = {s: kernels.hit_filter(table.table[s[2] - table.lo:s[2] - table.lo + s[3]],
                                            params.least_depth) for s in shares if s[0] > 1}
        calls = []
        for target, refs, rows in picked:
            offs = torch.from_numpy(chunk_offsets(index, refs, rows)).to(self.dev)
            args = (db.packed, db.mask, offs, table.table, table.lo, *scan, target,
                    params.least_depth)
            planes = kernels.scan_hits(*args, filt)
            calls.append(dict(
                target=target, refs=refs, rows=rows, offs=offs, planes=planes,
                hits=lambda a=args: kernels.scan_hits(*a, filt),
                hits_plain=lambda a=args: kernels.scan_hits_plain(*a),
                win=lambda p=planes: kernels.window_hits(p, *win),
                win_plain=lambda p=planes: kernels.window_hits_plain(p, *win),
                chunk=lambda o=offs, t=target: kernels.scan_chunk(
                    db.packed, db.mask, o, table.table, *scan, t, *win, params.least_depth)))
        err, tot, share_reads = 0, {}, {s: (0, 0) for s in share_filt}
        for c in calls:
            want, flags = c["hits_plain"](), c["win"]()
            same = (torch.equal(c["planes"], want), torch.equal(flags, c["win_plain"]()),
                    torch.equal(flags, c["chunk"]()))
            err = max(err, int((c["planes"].int() - want.int()).abs().max()))
            self.check(all(same), f"scan_hits, window_hits equal their plain versions and "
                                  f"window_hits the fused scan_chunk on a chunk of "
                                  f"{len(c['refs'])} refs + {c['rows'] - len(c['refs'])} pad "
                                  f"rows × {c['target']} positions: {same}")
            h = kernels.scan_hashes_plain(db.packed, db.mask, c["offs"], *scan, c["target"])
            for s, sf in share_filt.items():  # each share's filter probes and shard reads
                share_reads[s] = tuple(a + b for a, b in zip(
                    share_reads[s], probe_reads(h, s[2], s[3], sf)))
            reads, shard_reads = probe_reads(h, table.lo, table.table.numel(), filt)
            del h, want
            part = dict(positions=c["rows"] * c["target"], rows=c["rows"], reads=reads,
                        shard_reads=shard_reads,
                        **{f"{n}_ms": cuda_ms(c[n], 20) for n in ("hits", "win", "chunk")},
                        **{f"{n}_ms": cuda_ms(c[n], 3) for n in ("hits_plain", "win_plain")})
            say(f"    chunk {c['rows']:4d} × {c['target']:7d}: scan_hits {part['hits_ms']:.4f} "
                f"ms (plain {part['hits_plain_ms']:.4f}), window_hits {part['win_ms']:.4f} ms "
                f"(plain {part['win_plain_ms']:.4f}), scan_chunk {part['chunk_ms']:.4f} ms; "
                f"{reads} in-range hashes, {shard_reads} of them behind a set filter bit")
            for key, v in part.items():
                tot[key] = tot.get(key, 0) + v
        kernel_ms = self.profiled_ms(
            [f for c in calls for f in (c["hits"], c["win"], c["chunk"])],
            ("scan_hits", "window_hits", "scan_chunk"))
        profiled = kernel_ms is not None
        kernel_ms = kernel_ms or {}
        hb = scan_hits_bound(tot["positions"], tot["rows"], filt.fbits, tot["shard_reads"])
        wb = window_hits_bound(tot["positions"])
        say(f"  over {len(calls)} chunks, {tot['positions']} positions, {tot['reads']} in-range "
            f"hashes (filter probes, {tot['reads'] * 32 / 1e9:.3f} GB at a 32-byte sector "
            f"through the L2, a term the bound leaves out), {tot['shard_reads']} shard reads: "
            + ("kernel time (profiler) " + ", ".join(
                f"{n} {ms:.4f} ms" for n, ms in kernel_ms.items()) if profiled else
                "kernel time not measured (the profiler saw no device events)")
            + f"; CUDA events around the wrappers: scan_hits {tot['hits_ms']:.4f} ms, "
            f"window_hits {tot['win_ms']:.4f} ms, scan_chunk {tot['chunk_ms']:.4f} ms; bounds: "
            f"scan_hits {hb[0]:.4f} ms ({hb[1]}), window_hits {wb[0]:.4f} ms ({wb[1]}); plain: "
            f"scan_hits {tot['hits_plain_ms']:.4f} ms, window_hits {tot['win_plain_ms']:.4f} ms")
        for name, key, b in (("scan_hits", "hits", hb), ("window_hits", "win", wb)):
            self.records[name] = dict(
                dtype="packed phagedb + a table shard in, hit bit-planes out"
                if name == "scan_hits" else "hit bit-planes in, uint8 flags out",
                max_abs_err=float(err), ms=kernel_ms[name] if profiled else tot[f"{key}_ms"],
                wrapper_ms=tot[f"{key}_ms"], plain_ms=tot[f"{key}_plain_ms"], bound=b,
                library_ms=None, chunks=len(calls),
                scan_chunk_ms=kernel_ms["scan_chunk"] if profiled else tot["chunk_ms"])
        self.records["scan_hits"].update(positions=tot["positions"], rows=tot["rows"],
                                         probes=tot["reads"], shard_reads=tot["shard_reads"])

        # scan_hits at each share of 2 and 4 ranks, a slice of the whole table
        for world, rank, lo, size in shares:
            if world == 1:
                continue
            shard = table.table[lo - table.lo:lo - table.lo + size]
            sf = share_filt[(world, rank, lo, size)]
            runs = [lambda c=c: kernels.scan_hits(db.packed, db.mask, c["offs"], shard, lo, *scan,
                                                  c["target"], params.least_depth, sf)
                    for c in calls]
            same = all(torch.equal(run(), kernels.scan_hits_plain(
                db.packed, db.mask, c["offs"], shard, lo, *scan, c["target"],
                params.least_depth)) for run, c in zip(runs, calls))
            ms = self.profiled_ms(runs, ("scan_hits",))
            events = sum(cuda_ms(run, 20) for run in runs)
            reads, shard_reads = share_reads[(world, rank, lo, size)]
            b = scan_hits_bound(tot["positions"], tot["rows"], sf.fbits, shard_reads)
            self.check(same, f"scan_hits at world {world}, rank {rank} (hashes [{lo}, "
                             f"{lo + size})) equals its plain version on the {len(calls)} chunks")
            say(f"  scan_hits, world {world} rank {rank}: {reads} in-range hashes, "
                f"{shard_reads} shard reads, "
                + (f"{ms['scan_hits']:.4f} ms (profiler)" if ms else "kernel time not measured")
                + f", {events:.4f} ms (CUDA events around the wrappers); bound {b[0]:.4f} ms "
                f"({b[1]}: a 32-byte sector a shard read, the probes left to the L2)")
            self.records.setdefault("scan_hits_shares", {})[f"{world}/{rank}"] = dict(
                reads=reads, shard_reads=shard_reads, fbits=sf.fbits,
                ms=ms["scan_hits"] if ms else None, wrapper_ms=events, bound=b)

    def hit_filter_phase(self, shard, least_depth: int):
        """``hit_filter`` of the one rank's shard, the whole table, against
        its plain version: its time (CUDA events; the memset and the kernel,
        no synchronize in the wrapper), its bound (the shard read once, the
        bitmap written once), the plain version's time and the share of set
        bits.  Returns the filter."""
        from palace_tpu_torch.ops import kernels

        filt = kernels.hit_filter(shard, least_depth)
        plain = kernels.hit_filter_plain(shard, least_depth)
        same = torch.equal(filt.words, plain.words) and filt.fbits == plain.fbits
        self.check(same, f"hit_filter equals its plain version on the {shard.numel()}-slot "
                         f"shard (2^{filt.fbits} bits)")
        del plain
        ms = cuda_ms(lambda: kernels.hit_filter(shard, least_depth), 5)
        plain_ms = cuda_ms(lambda: kernels.hit_filter_plain(shard, least_depth), 2)
        ones = torch.tensor([bin(i).count("1") for i in range(256)], device=shard.device)
        set_share = int(ones[filt.words.view(torch.uint8).long()].sum()) / (1 << filt.fbits)
        b = bound(shard.numel() + (1 << filt.fbits) // 8, shard.numel(), torch.float32)
        say(f"  hit_filter: {ms:.4f} ms for {shard.numel()} slots into 2^{filt.fbits} bits "
            f"({set_share:.4%} set), bound {b[0]:.4f} ms ({b[1]}), plain {plain_ms:.4f} ms")
        self.records["hit_filter"] = dict(
            dtype="a uint8 table shard in, a bitmap of the slots counting least_depth out",
            max_abs_err=0.0 if same else float("inf"), ms=ms, plain_ms=plain_ms, bound=b,
            library_ms=None, set_share=set_share)
        return filt

    def profiled_ms(self, runs: list, names: tuple, reps: int = 3) -> dict | None:
        """Device ms a pass over ``runs`` of each kernel in ``names`` from
        torch.profiler, over ``reps`` passes; None where the profiler saw no
        device events."""
        from torch.profiler import ProfilerActivity, profile

        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for run in runs:
                    run()
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
        ms = {n: sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and f"{n}_kernel" in e.name) / 1e3 / reps for n in names}
        return ms if any(ms.values()) else None

    def eref_mesh_two_ranks(self, world, tmp: Path) -> None:
        """Phase 23: ``ACROSS_RANKS`` processes on the one card under gloo with
        their tensors on the card, at (2, 1): ``run_search(mesh=...)`` and
        ``run_search_distributed`` on every rank, each rank's hits and its
        shard held to phase 8's, ``ref_names.txt`` written by rank 0 alone,
        ``scan_hits`` and ``window_hits`` launched once a chunk on every
        rank; Phase A and B seconds, the collectives' ms and bytes and each
        rank's peak memory, of processes sharing one card (not scaling)."""
        from palace_tpu_torch.search.eref import plan_chunks

        index, fq, _ = world
        n_chunks, want = len(plan_chunks(index)), self.records["eref"]["ref_names"]
        job = dict(work=_eref_rank_work, db=str(Path(fq).with_name("db.fasta")), k=EREF_K,
                   fastqs=[str(f) for f in split_reads(Path(fq))], device=self.dev.type,
                   setup=MESH_SETUP)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        out = tmp / "eref_ranks"
        ranks = spawn_ranks(mesh_rank, ACROSS_RANKS, job, out, ACROSS_TIMEOUT_S)
        lines = want.decode().splitlines()
        for name in ranks[0]["runs"]:
            for r in ranks:
                rec = r["runs"][name]
                what = f"{name}, rank {r['rank']} {r['coords']}"
                self.check(rec["hits"] == lines and len(rec["hits"]) == EREF_JAX_HITS,
                           f"{what}: {len(rec['hits'])} hits, phase 8's")
                self.check(rec["shard"][1], f"{what}: its shard of {rec['shard'][0]} bytes "
                                            f"equals its block of a one-device table")
                la = rec["launches"]
                self.check(la["scan_hits"] == la["window_hits"] == n_chunks
                           and la["scan_chunk"] == 0 and la["hit_filter"] == 1,
                           f"{what}: launched scan_hits and window_hits once a chunk, scan_chunk "
                           f"never ({la['scan_hits']}, {la['window_hits']}, {la['scan_chunk']}; "
                           f"{n_chunks} chunks), hit_filter once a Phase B ({la['hit_filter']})")
                (a_s, a_b), (b_s, b_b) = rec["collectives"]["A"], rec["collectives"]["B"]
                say(f"  {what}: {rec['wall_s']:.3f} s; Phase A {rec['phase_a_s']:.3f} s "
                    f"(collectives {a_s * 1e3:.1f} ms, {a_b:.0f} bytes), Phase B "
                    f"{rec['phase_b_s']:.3f} s (collectives {b_s * 1e3:.1f} ms, {b_b:.0f} "
                    f"bytes); peak {rec['peak_bytes'] / 2**30:.3f} GiB")
            files = sorted(p.name for p in out.glob(f"ref_names.{name}.rank*.txt"))
            self.check(files == [f"ref_names.{name}.rank0.txt"]
                       and (out / files[0]).read_bytes() == want,
                       f"{name}: ref_names.txt written by rank 0 alone ({files}), "
                       f"byte-identical to phase 8's")
        self.records["eref_two_ranks"] = ranks

    def pipeline_mesh(self, config: Path, tmp: Path) -> None:
        """Phase 24: ``run_pipeline(cfg, mesh=...)`` on a copy of phase 16's
        world, ``ACROSS_RANKS`` processes on the one card under gloo at
        (2, 1): the final FASTA byte-identical to phase 17's,
        ``node_scores.out`` within ``PROB_ATOL`` of it, K1-K3 launched a
        scoring batch and ``scan_hits``/``window_hits`` a chunk on every
        rank; each step's seconds."""
        from palace_tpu_torch.config import PalaceConfig

        ref = self.records["pipeline"]
        job = dict(work=_pipeline_rank_work, config=str(config), device=self.dev.type,
                   setup=MESH_SETUP)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ranks = spawn_ranks(mesh_rank, ACROSS_RANKS, job, tmp / "pipeline_ranks",
                            ACROSS_TIMEOUT_S)
        out = PalaceConfig.from_file(config).output_files()
        final = out["final_fasta"]
        self.check(all(r["final"] == str(final) for r in ranks)
                   and final.read_bytes() == ref["final_bytes"],
                   f"{final.name} across {ACROSS_RANKS} ranks byte-identical to phase 17's")
        rows = [line.split("\t") for line in out["node_score"].read_text().splitlines()]
        names, probs = [n for n, _ in rows], np.array([float(p) for _, p in rows])
        err = float(np.abs(probs - ref["scores"][1]).max()) if names == ref["scores"][0] \
            else float("inf")
        self.check(err <= PROB_ATOL, f"node_scores.out: the same contigs in order, max |dp| "
                                     f"{err:.3g} from phase 17's <= {PROB_ATOL}")
        n, c = ref["n_batches"], ref["n_chunks"]
        for r in ranks:
            la = r["launches"]
            want = dict(transition_counts=n, sage_rounds=n, conv_head=3 * n, scan_hits=c,
                        window_hits=c, scan_chunk=0, hit_filter=1)
            self.check({k: la[k] for k in want} == want,
                       f"pipeline, rank {r['rank']}: launched {want} (got "
                       f"{ {k: la[k] for k in want} })")
            say(f"  rank {r['rank']}: {r['wall_s']:.3f} s, peak {r['peak_bytes'] / 2**30:.3f} GiB; "
                + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(r["seconds"].items())
                            if k.startswith("step") or k in ("gcn.score", "eref.count_reads",
                                                             "eref.scan_refs")))
        self.records["pipeline_mesh"] = ranks


def run_across_devices_phases(smoke: Smoke, eref_world, pipeline_config, tmp: Path) -> None:
    """Phases 22-24, after the card is freed of the earlier phases' models:
    eref on phase 7's world (kept in ``tmp``), one rank then two, and the
    pipeline on the copy of phase 16's world."""
    import gc

    gc.collect()
    if smoke.dev.type == "cuda":
        torch.cuda.empty_cache()
    if eref_world:
        with torch.inference_mode():
            ok = smoke.phase("eref across devices: one rank", smoke.eref_mesh_one_rank,
                             eref_world, tmp)
        if ok:
            smoke.phase("eref across devices: two ranks on one card", smoke.eref_mesh_two_ranks,
                        eref_world, tmp)
    if pipeline_config:
        smoke.phase("the pipeline across devices: two ranks on one card", smoke.pipeline_mesh,
                    pipeline_config, tmp)


def run_graph_phases(smoke: Smoke) -> None:
    """The graph path on the host, in a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        world = smoke.phase("graph world", smoke.graph_world, Path(tmp))
        if world:
            smoke.phase("graph path", smoke.graph_path, world, Path(tmp))


def run_pipeline_phases(smoke: Smoke, keep: Path | None = None) -> Path | None:
    """Phases 16-17, the whole pipeline, in a temporary directory; with
    ``keep``, the world is first copied there for phase 24, and the copy's
    config returned."""
    twin = None
    with tempfile.TemporaryDirectory() as tmp:
        world = smoke.phase("pipeline world", smoke.pipeline_world, Path(tmp))
        if world:
            if keep is not None:
                twin = copy_pipeline_world(world, Path(tmp), keep / "pipeline_world")
            smoke.phase("pipeline", smoke.pipeline, world)
    return twin


def run_train_phases(smoke: Smoke) -> None:
    """Phases 18-19, training, after the card is freed of the earlier
    phases' tables and models; checkpoints in a temporary directory."""
    import gc

    gc.collect()
    if smoke.dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        world = smoke.phase("training world", smoke.train_world)
        if world:
            smoke.phase("one training step against the CPU", smoke.train_step_against_cpu,
                        world)
            state = smoke.phase("training and checkpoints", smoke.train_learns, world,
                                Path(tmp))
            if state:
                smoke.phase("trained parameters through the kernels",
                            smoke.trained_through_kernels, world, state)
                smoke.phase("where a training step's time goes", smoke.train_numbers, world,
                            state)


def run_mesh_phases(smoke: Smoke) -> None:
    """Phases 20-21, the GCN across devices, after the card is freed of the
    earlier phases' models; stores and checkpoints in a temporary
    directory."""
    import gc

    gc.collect()
    if smoke.dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        refs = smoke.phase("the GCN across devices: one rank", smoke.mesh_one_rank, Path(tmp))
        if refs:
            smoke.phase("the GCN across devices: two ranks on one card", smoke.mesh_two_ranks,
                        refs, Path(tmp))


def run_phases(smoke: Smoke) -> None:
    """Phases 3-6 on ``smoke.dev``."""
    from palace_tpu_torch.models.gcn import init_params

    with torch.inference_mode():
        contigs = smoke.phase("contigs", make_contigs, N_CONTIGS, CONTIG_LEN, SEED)
        params = init_params(torch.Generator(device=smoke.dev).manual_seed(SEED))
        smoke.phase("kernels at the main path's shapes", smoke.kernels_at_main_shapes,
                    params, contigs)
        smoke.phase("K1 on an assembly's lengths", smoke.k1_on_assembly_lengths)
        smoke.phase("K1 on low-complexity rows", smoke.k1_low_complexity)
        smoke.phase("K3 where its outputs are large", smoke.conv_rounding)
        smoke.phase("K3 at ragged shapes", smoke.conv_ragged)
        smoke.phase("K2 where its intermediates reach 4..8", smoke.sage_rounding)
        smoke.phase("slice", smoke.slice, params, contigs)
        smoke.phase("where the time goes", smoke.where_the_time_goes, params, contigs)
        smoke.phase("slice against the plain versions", smoke.slice_against_plain, params)
        smoke.phase("public names on the card", smoke.public_names, params, contigs)


def run_eref_phases(smoke: Smoke, keep: Path | None = None):
    """Phases 7-13 on ``smoke.dev``, in a temporary directory, or with the
    eref world in ``keep``, returned for phases 22-23."""
    with torch.inference_mode(), tempfile.TemporaryDirectory() as tmp:
        world = smoke.phase("eref world", smoke.eref_world, keep or Path(tmp))
        table, hits = (world and smoke.phase("eref slice", smoke.eref_slice, world)) or (None, [])
        counted = table is not None
        if table:
            smoke.phase("K4 fused on real chunks", smoke.scan_chunk_on_real_chunks, world, table)
            smoke.phase("K4 at the main path's shapes", smoke.k4_at_main_shapes, world, table)
            smoke.phase("window and hash names on the card", smoke.window_names, world, table)
            smoke.phase("per-reference scan", smoke.per_reference_scan, world, table, hits)
            smoke.phase("count_codes on Phase A's batches", smoke.count_codes_on_real_batches,
                        world)
            smoke.phase("Phase A with the native loader", smoke.phase_a_native, world)
            smoke.phase("where Phase A's time goes", smoke.phase_a_split, world)
            smoke.phase("where Phase B's time goes", smoke.phase_b_profile, world, table)
        del table
        if smoke.dev.type == "cuda":
            torch.cuda.empty_cache()
        smoke.phase("eref slice against the CPU", smoke.eref_against_cpu, Path(tmp))
    return world if keep is not None and counted else None


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import palace_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 1
    if ROOT not in Path(palace_tpu_torch.__file__).resolve().parents:
        print(f"chip_smoke: palace_tpu_torch comes from {palace_tpu_torch.__file__}, "
              f"not from this checkout", file=sys.stderr)
        return 1
    from palace_tpu_torch.device import device_info

    # the plain versions are the reference: full float32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke()

    say("== card")
    info = device_info()
    smi = info["nvidia_smi"] or "nvidia-smi: not available"
    say(smi)
    say(f"torch {info['torch']}, CUDA {info['cuda']}, {info['count']} device(s), "
        f"python {sys.version.split()[0]}")

    smoke.native_build()
    smoke.phase("build", smoke.build)
    if not smoke.failures:
        with tempfile.TemporaryDirectory() as keep:
            run_phases(smoke)
            eref_world = run_eref_phases(smoke, Path(keep))
            run_graph_phases(smoke)
            pipeline_config = run_pipeline_phases(smoke, Path(keep))
            run_train_phases(smoke)
            run_mesh_phases(smoke)
            run_across_devices_phases(smoke, eref_world, pipeline_config, Path(keep))
    if smoke.failures:
        say("FAILED: " + "; ".join(smoke.failures))
        return 1
    # each kernel's launches on its own main path
    launches = dict(smoke.records["slice"]["launches"],
                    scan_chunk=smoke.records["eref"]["launches"]["scan_chunk"],
                    good_windows=smoke.records["per_reference"]["launches"]["good_windows"],
                    scan_hits=smoke.records["eref_mesh"]["launches"]["scan_hits"],
                    window_hits=smoke.records["eref_mesh"]["launches"]["window_hits"],
                    hit_filter=smoke.records["eref_mesh"]["launches"]["hit_filter"],
                    count_codes=smoke.records["eref"]["launches"]["count_codes"])
    # and the float32 routes of K2 and K3, the pipeline's default dtype, in the
    # float32 slice; K1's padded-codes entry in its phase
    f32 = {f"{k}/float32": KERNELS[k] for k in ("sage_rounds", "conv_head")}
    for name in f32:
        launches[name] = smoke.records["slice_float32"]["launches"][name.split("/")[0]]
    f32["transition_counts/codes"] = KERNELS["transition_counts"]
    launches["transition_counts/codes"] = \
        smoke.records["public_names"]["launches"]["transition_counts_codes"]
    rows = []
    for name, (source, replaces) in dict(KERNELS, **f32).items():
        rec = smoke.records[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0],
                     "bound_by": rec["bound"][1], "library_ms": rec["library_ms"],
                     "dtype": rec["dtype"], "status": "ok"})
    say(json.dumps({"kernels": rows}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                           "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
