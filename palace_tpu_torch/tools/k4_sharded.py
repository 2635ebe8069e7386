#!/usr/bin/env python3
"""K4's sharded Phase B (``kernels.scan_hits`` and ``kernels.window_hits``)
on one CUDA card, on the chunks ``chip_smoke.py`` times them on (phase 22):
the eref world of ``chip_smoke.make_eref_world`` (5,000 references, 357.8
Mbp, 200,000 reads, seed 7) at k = 32, its 4 GiB count table, and
``chip_smoke.picked_chunks(plan_chunks(index))``, 13 chunks.

    python palace_tpu_torch/tools/k4_sharded.py ab ROOT [--iters N]
    python palace_tpu_torch/tools/k4_sharded.py variants [--iters N]

Run it as a file, not with ``-m``: ``ab`` imports ROOT's package, which
must not be imported before it.  The world's files are written once into
``build/k4_sharded_world/`` of this checkout and reused.

``ab``: the two kernels of the tree at ROOT (this checkout, or an earlier
commit unpacked with ``git archive``; its kernels are built under ROOT),
through their wrappers, over the 13 chunks: ``scan_hits`` at the shard
ranges of world 1, 2 and 4 (rank 0's and the last rank's share; a shard is
a slice of the table, so one process and no process group), each equal to
``scan_hits_plain``, with one ``hit_filter`` a share made before, as a Phase
B makes one, where the tree has it (and its time); ``window_hits`` on the
world-1 planes, equal to ``window_hits_plain``.  Device time by kernel
from torch.profiler, and CUDA events around the wrappers.  To compare two
trees on one card, run it in one call on each in turns (a, b, b, a).

``variants``: what holds ``scan_hits``' table reads, each timed with CUDA
events in turns, twice, over the 13 chunks:
  a. ``scan_hits`` as committed at the world 1, 2 and 4 shard ranges, each
     with its share's filter, and ``hit_filter``'s time on each share;
  b. copies of the committed ``csrc/good_windows.cu`` that each change one
     thing in ``scan_hits_kernel`` (no filter, so every in-range hash reads
     the shard as the first design did; the filter's reads alone; no reads
     at all; ``ld.global.nc.L1::no_allocate``; L2 eviction hints, first
     for the shard's reads and last for the filter's; 4 or 16 positions a
     thread a round), built with nvcc into ``build/k4_sharded_variants/``; the
     committed kernel with filters of 2^25-2^29 bits, and at an L2 fetch
     granularity (``cudaLimitMaxL2FetchGranularity``) of 32 B;
  c-f. a bare gather: the in-range shard offsets of world 1 (every
     nonzero hash) as uint32 in device memory, read as 1-byte loads with
     8, 24 and 64 in flight a thread; masked into windows of 4 MiB to 1
     GiB; sorted, and grouped by their top 4, 7 and 10 bits in the order
     they came; with ``ld.global.nc.L1::no_allocate``; at an L2 fetch
     granularity of 32 B;
  g. ``scan_hits_kernel``'s SASS (``cuobjdump -sass`` of the committed
     source): its loads by kind, and how many global loads are issued
     before an instruction reads one of their registers.

Each mode prints one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import k2_float32

HERE = k2_float32.HERE
WORLD_DIR = HERE / "build" / "k4_sharded_world"
WORK = HERE / "build" / "k4_sharded_variants"

WORD = "        word[b][i] = mine ? __ldg(filt + ((h[b].v[i] & fmask) >> 5)) : 0u;\n"
COUNT = "        cnt[b][i] = maybe ? __ldg(shard + h[b].v[i]) : 0xffffffffu;\n"
# name → [(anchor in csrc/good_windows.cu, replacement)], each in scan_hits_kernel
VARIANTS = {
    "no filter (every in-range hash reads the shard)": [
        (WORD, "        word[b][i] = mine ? 0xffffffffu : 0u;\n")],
    "filter reads only (a set bit counted a miss)": [
        (COUNT, "        cnt[b][i] = maybe ? h[b].v[i] | 0x100u : 0xffffffffu;\n")],
    "no table reads (each in-range hash a miss)": [
        (WORD, "        word[b][i] = 0u;\n"),
        (COUNT, "        cnt[b][i] = h[b].v[i] | 0x100u;\n")],
    "ld.global.nc.L1::no_allocate (filter and shard)": [
        (WORD, WORD.replace("__ldg(filt", "ld_no_allocate(filt")),
        (COUNT, COUNT.replace("__ldg(shard", "ld_no_allocate(shard"))],
    "shard reads L2::evict_first": [
        (COUNT, COUNT.replace("__ldg(shard", "ld_evict_first(shard"))],
    "shard reads L2::evict_first, filter reads L2::evict_last": [
        (WORD, WORD.replace("__ldg(filt", "ld_evict_last(filt")),
        (COUNT, COUNT.replace("__ldg(shard", "ld_evict_first(shard"))],
    "4 positions a thread a round": [("constexpr int kBatch = 8;", "constexpr int kBatch = 4;")],
    "16 positions a thread a round": [("constexpr int kBatch = 8;", "constexpr int kBatch = 16;")],
}
#: filter sizes the committed kernel is timed at (``kernels.HIT_FILTER_BITS`` set
#: to each for the call that makes the filter)
FILTER_BITS = (25, 26, 27, 28, 29)

# the variants' load helpers, put before scan_hits_kernel
LOADS = r"""
__device__ __forceinline__ uint32_t ld_no_allocate(const uint8_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_no_allocate(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_evict_first(const uint8_t* p) {
  uint64_t policy;
  uint32_t v;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ uint32_t ld_evict_last(const uint32_t* p) {
  uint64_t policy;
  uint32_t v;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}
"""

GATHER = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t ld_no_allocate(const uint8_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Each thread takes D offsets a round (coalesced uint32 loads), issues their
// D 1-byte table reads together, then counts the ones equal to `want`.
template <int D, bool NoAllocate>
__global__ void __launch_bounds__(256) gather_kernel(const uint32_t* __restrict__ offs, long long n,
                                                     const uint8_t* __restrict__ table,
                                                     uint32_t mask, uint32_t want,
                                                     unsigned long long* __restrict__ hits) {
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned count = 0;
  for (long long base = 0; base < n; base += nthreads * D) {
    uint32_t o[D], v[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const long long i = base + j * nthreads + tid;
      o[j] = i < n ? offs[i] & mask : 0xffffffffu;
    }
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (o[j] != 0xffffffffu)
        v[j] = NoAllocate ? ld_no_allocate(table + o[j]) : (uint32_t)__ldg(table + o[j]);
      else
        v[j] = 0x100u;
#pragma unroll
    for (int j = 0; j < D; ++j) count += v[j] == want;
  }
  atomicAdd(hits, (unsigned long long)count);
}

template <int D, bool NoAllocate>
int launch(const void* offs, long long n, const void* table, unsigned mask, unsigned want,
           void* hits, int blocks, void* stream) {
  gather_kernel<D, NoAllocate><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)offs, n, (const uint8_t*)table, mask, want, (unsigned long long*)hits);
  return (int)cudaGetLastError();
}

extern "C" int gather_run(const void* offs, long long n, const void* table, unsigned mask,
                          unsigned want, void* hits, int depth, int no_allocate, int blocks,
                          void* stream) {
  if (no_allocate) return launch<24, true>(offs, n, table, mask, want, hits, blocks, stream);
  switch (depth) {
    case 8: return launch<8, false>(offs, n, table, mask, want, hits, blocks, stream);
    case 24: return launch<24, false>(offs, n, table, mask, want, hits, blocks, stream);
    case 64: return launch<64, false>(offs, n, table, mask, want, hits, blocks, stream);
  }
  return -1;
}

extern "C" int l2_fetch_granularity(int bytes) {  // sets it where bytes > 0; returns it
  if (bytes > 0 && cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, bytes)) return -1;
  size_t v = 0;
  if (cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity)) return -1;
  return (int)v;
}

extern "C" int blocks_per_sm(int depth) {
  int n = 0;
  if (depth == 8) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gather_kernel<8, false>, 256, 0);
  if (depth == 24) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gather_kernel<24, false>, 256, 0);
  if (depth == 64) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gather_kernel<64, false>, 256, 0);
  return n;
}
"""


def load_world(smoke, dev):
    """The index, the 4 GiB table (Phase A on the card) and phase 22's
    chunks, each as (target, rows, offsets on the card)."""
    from palace_tpu_torch.config import KmerParams
    from palace_tpu_torch.search.eref import (DeviceDB, chunk_offsets, count_reads_into_table,
                                              plan_chunks)
    from palace_tpu_torch.search.index import build_index

    import torch

    WORLD_DIR.mkdir(parents=True, exist_ok=True)
    db, fq = WORLD_DIR / "db.fasta", WORLD_DIR / "reads.fastq"
    if not fq.exists():
        smoke.make_eref_world(WORLD_DIR, smoke.EREF_REFS, smoke.EREF_READS)
    index = build_index(db, k=smoke.EREF_K, save=False)
    params = KmerParams(k=smoke.EREF_K)
    table = count_reads_into_table([fq], index, params, device=dev)
    ddb = DeviceDB(index, dev)
    chunks = [(target, rows, torch.from_numpy(chunk_offsets(index, refs, rows)).to(dev))
              for target, refs, rows in smoke.picked_chunks(plan_chunks(index))]
    return index, params, table.table, ddb, chunks


def in_range_reads(index, ddb, chunks, lo: int, size: int) -> int:
    """The table reads a share makes over the chunks: hashes not 0 in [lo, lo + S)."""
    from palace_tpu_torch.ops import kernels

    n = 0
    for target, _, offs in chunks:
        h = kernels.scan_hashes_plain(ddb.packed, ddb.mask, offs, index.perm, index.k, target)
        n += int(((h != 0) & (h >= lo) & (h < lo + size)).sum())
    return n


def device_ms(prof, names) -> dict:
    """Device ms of the profiled kernels whose name holds one of ``names``."""
    import torch

    return {n: sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and n in e.name) / 1e3
            for n in names}


def ab(args, smoke, dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from palace_tpu_torch.ops import _build, kernels
    from palace_tpu_torch.ops.window import window_thresholds

    _build.build_all(["scan_hits", "window_hits"])
    index, params, table, ddb, chunks = load_world(smoke, dev)
    win = (params.window, *window_thresholds(params.window, params.hit_ratio,
                                             params.perfect_hit_ratio))
    scan = (index.perm, index.k)
    out = {"root": str(args.root), "chunks": len(chunks),
           "positions": sum(t * r for t, r, _ in chunks), "scan_hits": {}}
    planes1, filtered = [], hasattr(kernels, "hit_filter")
    for world, rank, lo, size in smoke.shard_shares(table.numel()):
        shard = table[lo:lo + size]
        # one filter a share, as a Phase B makes one, where the tree has it
        extra = (kernels.hit_filter(shard, params.least_depth),) if filtered else ()
        calls = [lambda t=t, o=o, shard=shard, lo=lo, extra=extra: kernels.scan_hits(
            ddb.packed, ddb.mask, o, shard, lo, *scan, t, params.least_depth, *extra)
            for t, _, o in chunks]
        equal = True
        for (t, _, o), call in zip(chunks, calls):
            got = call()
            equal &= torch.equal(got, kernels.scan_hits_plain(ddb.packed, ddb.mask, o, shard, lo,
                                                              *scan, t, params.least_depth))
            if world == 1:
                planes1.append(got)
        rec = dict(equal_plain=bool(equal), lo=lo, size=size,
                   reads=in_range_reads(index, ddb, chunks, lo, size))
        rec["wrapper_ms"] = [smoke.cuda_ms(lambda: [c() for c in calls], args.iters)]
        if filtered:
            rec["hit_filter_ms"] = smoke.cuda_ms(
                lambda: kernels.hit_filter(shard, params.least_depth), args.iters)
        rec["calls"] = calls
        out["scan_hits"][f"world {world} rank {rank}"] = rec
    wcalls = [lambda p=p: kernels.window_hits(p, *win) for p in planes1]
    equal = all(torch.equal(c(), kernels.window_hits_plain(p, *win))
                for c, p in zip(wcalls, planes1))
    out["window_hits"] = dict(equal_plain=bool(equal),
                              wrapper_ms=[smoke.cuda_ms(lambda: [c() for c in wcalls],
                                                        args.iters)])
    # device time of the kernels alone, twice
    for _ in range(2):
        for name, rec in out["scan_hits"].items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    for c in rec["calls"]:
                        c()
                torch.cuda.synchronize()
            rec.setdefault("ms", []).append(device_ms(prof, ["scan_hits"])["scan_hits"]
                                            / args.iters)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                for c in wcalls:
                    c()
            torch.cuda.synchronize()
        out["window_hits"].setdefault("ms", []).append(
            device_ms(prof, ["window_hits"])["window_hits"] / args.iters)
    for rec in out["scan_hits"].values():
        del rec["calls"]
    return out


def _build_lib(name: str, text: str, extra=()) -> tuple:
    from palace_tpu_torch.ops import _build

    WORK.mkdir(parents=True, exist_ok=True)
    cu, lib = WORK / f"{name}.cu", WORK / f"{name}.so"
    cu.write_text(text)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I",
                             str(_build.csrc_dir()), "-o", str(lib), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc


def variants(args, smoke, dev) -> dict:
    import torch

    from palace_tpu_torch.ops import _build, kernels

    src = (_build.csrc_dir() / "good_windows.cu").read_text()
    anchor = "__global__ void __launch_bounds__(kThreads) scan_hits_kernel("
    sources = {"committed": src}
    out = {"variants": {}}
    for name, edits in VARIANTS.items():
        if any(src.count(old) != 1 for old, _ in edits):
            out["variants"][name] = "anchor not found in csrc/good_windows.cu"
            continue
        text = src
        for old, new in edits:
            text = text.replace(old, new)
        if "ld_no_allocate" in text or "ld_evict" in text:
            text = text.replace(anchor, LOADS + anchor)
        sources[name] = text
    procs = {name: _build_lib(f"v{i}", text) for i, (name, text) in enumerate(sources.items())}
    gather_lib, gather_proc = _build_lib("gather", GATHER)
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            out["variants"][name] = f"nvcc failed: {log[-600:]}"
            continue
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].palace_scan_hits.argtypes = _build.KERNELS["scan_hits"][2]
        out["variants"][name] = dict(
            ptxas=[line for line in smoke.ptxas_summary(log) if line.startswith("scan_hits")],
            ms=[])
    log, _ = gather_proc.communicate()
    if gather_proc.returncode:
        raise RuntimeError(f"nvcc failed on the bare gather: {log[-2000:]}")
    g = ctypes.CDLL(str(gather_lib))
    g.gather_run.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_uint,
                             ctypes.c_uint, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    out["l2_fetch_granularity_default"] = g.l2_fetch_granularity(0)
    out["gather_blocks_per_sm"] = {d: g.blocks_per_sm(d) for d in (8, 24, 64)}

    t0 = time.perf_counter()
    index, params, table, ddb, chunks = load_world(smoke, dev)
    out["setup_s"] = time.perf_counter() - t0
    stream = torch.cuda.current_stream().cuda_stream
    masks = kernels._coder_masks(index.perm, index.k)
    planes = [torch.empty(r, 3, t // 8, dtype=torch.uint8, device=dev) for t, r, _ in chunks]

    def scan(lib, lo, size, filt):
        def run():
            for (t, r, o), p in zip(chunks, planes):
                err = lib.palace_scan_hits(ddb.packed.data_ptr(), ddb.mask.data_ptr(),
                                           o.data_ptr(), table.data_ptr() + lo,
                                           filt.words.data_ptr(), filt.fbits,
                                           ctypes.addressof(masks), p.data_ptr(), r, t, index.k,
                                           params.least_depth, lo, lo + size, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
        return run

    # a. the committed kernel at each share, with the share's filter; its
    # reads; equal to the plain version
    committed = libs["committed"]
    out["shares"], filters = {}, {}
    for world, rank, lo, size in smoke.shard_shares(table.numel()):
        shard = table[lo:lo + size]
        name = f"world {world} rank {rank}"
        filters[name] = kernels.hit_filter(shard, params.least_depth)
        scan(committed, lo, size, filters[name])()
        equal = all(torch.equal(p, kernels.scan_hits_plain(ddb.packed, ddb.mask, o, shard, lo,
                                                           index.perm, index.k, t,
                                                           params.least_depth))
                    for (t, _, o), p in zip(chunks, planes))
        reads = in_range_reads(index, ddb, chunks, lo, size)
        out["shares"][name] = dict(
            lo=lo, size=size, reads=reads, equal_plain=bool(equal), ms=[],
            floor_ms=smoke.gather_floor_ms(reads), filter_bits=filters[name].fbits,
            filter_ms=smoke.cuda_ms(lambda: kernels.hit_filter(shard, params.least_depth),
                                    args.iters))
    whole = filters["world 1 rank 0"]
    # the committed kernel at world 1 with filters of other sizes
    sized = {}
    keep = kernels.HIT_FILTER_BITS
    try:
        for b in FILTER_BITS:
            kernels.HIT_FILTER_BITS = b
            sized[b] = kernels.hit_filter(table, params.least_depth)
    finally:
        kernels.HIT_FILTER_BITS = keep
    ones = torch.tensor([bin(i).count("1") for i in range(256)], device=dev)
    out["filters"] = {f"2^{b} bits": dict(
        set_share=int(ones[f.words.view(torch.uint8).long()].sum()) / (1 << f.fbits), ms=[])
        for b, f in sized.items()}

    # c-f. the bare gather's offsets: every nonzero hash of the chunks (world 1)
    parts = []
    for t, _, o in chunks:
        h = kernels.scan_hashes_plain(ddb.packed, ddb.mask, o, index.perm, index.k, t)
        parts.append(h[h != 0])
    offs64 = torch.cat(parts)
    del parts, h
    n = offs64.numel()
    as32 = lambda x: (x - (x >= 1 << 31).long() * (1 << 32)).to(torch.int32)  # uint32 bits
    offsets = {"as scanned": as32(offs64), "sorted": as32(offs64.sort().values)}
    for bits in (4, 7, 10):
        key = offs64 >> (32 - bits)
        offsets[f"grouped by the top {bits} bits"] = as32(offs64[key.sort(stable=True).indices])
    del offs64, key
    hits = torch.zeros(1, dtype=torch.int64, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def gather(order, depth=24, window=1 << 32, no_allocate=0):
        o, blocks = offsets[order], sms * out["gather_blocks_per_sm"][depth]

        def run():
            err = g.gather_run(o.data_ptr(), n, table.data_ptr(), (window - 1) & 0xffffffff,
                               params.least_depth, hits.data_ptr(), depth, no_allocate, blocks,
                               stream)
            if err:
                raise RuntimeError(f"gather failed: CUDA error {err}")
        return run

    runs = {}
    for d in (8, 24, 64):
        runs[f"gather, depth {d}"] = gather("as scanned", d)
    for w, label in ((1 << 22, "4 MiB"), (1 << 23, "8 MiB"), (1 << 24, "16 MiB"),
                     (1 << 25, "32 MiB"), (1 << 26, "64 MiB"), (1 << 28, "256 MiB"),
                     (1 << 30, "1 GiB")):
        runs[f"gather, depth 24, offsets in a {label} window"] = gather("as scanned", window=w)
    for order in offsets:
        if order != "as scanned":
            runs[f"gather, depth 24, {order}"] = gather(order)
    runs["gather, depth 24, ld.global.nc.L1::no_allocate"] = gather("as scanned", no_allocate=1)
    out["gather"] = {name: dict(ms=[]) for name in runs}
    out["gather_reads"] = n
    for _ in range(2):  # in turns
        for name, rec in out["shares"].items():
            rec["ms"].append(smoke.cuda_ms(scan(committed, rec["lo"], rec["size"],
                                                filters[name]), args.iters))
        for name, rec in out["variants"].items():
            if isinstance(rec, dict):
                rec["ms"].append(smoke.cuda_ms(scan(libs[name], 0, table.numel(), whole),
                                               args.iters))
        for b, f in sized.items():
            out["filters"][f"2^{b} bits"]["ms"].append(
                smoke.cuda_ms(scan(committed, 0, table.numel(), f), args.iters))
        for name, run in runs.items():
            out["gather"][name]["ms"].append(smoke.cuda_ms(run, args.iters))
        # the L2 fetch granularity at 32 B, then back
        g.l2_fetch_granularity(32)
        out.setdefault("l2_fetch_32", {}).setdefault("granularity", g.l2_fetch_granularity(0))
        for name, run in (("scan_hits, world 1", scan(committed, 0, table.numel(), whole)),
                          ("gather, depth 24", runs["gather, depth 24"])):
            out["l2_fetch_32"].setdefault(name, []).append(smoke.cuda_ms(run, args.iters))
        g.l2_fetch_granularity(out["l2_fetch_granularity_default"])
    for rec in out["gather"].values():
        rec["G_reads_per_s"] = n / (min(rec["ms"]) * 1e-3) / 1e9
    for rec in out["shares"].values():
        rec["G_reads_per_s"] = rec["reads"] / (min(rec["ms"]) * 1e-3) / 1e9
    out["sass"] = sass()
    return out


def sass() -> dict:
    """g. ``scan_hits_kernel``'s loads by kind, and the global loads issued
    before an instruction reads a register one of them wrote, run by run."""
    from palace_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    WORK.mkdir(parents=True, exist_ok=True)
    cubin = WORK / "good_windows.cubin"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-o", str(cubin), str(_build.csrc_dir() / "good_windows.cu")],
                   check=True, capture_output=True)
    text = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True).stdout
    fn = next(f for f in text.split("Function : ")[1:] if "scan_hits_kernel" in f.split()[0])
    ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)\s*([^;]*);", fn)
    loads = Counter(op for op, _ in ins if op.startswith(("LDG", "LD.", "LDS", "LDC")))
    pending, runs = set(), []
    for op, operands in ins:
        regs = re.findall(r"\bR\d+\b", operands)
        stores = op.startswith(("ST", "RED", "ATOM"))
        if pending & set(regs if stores else regs[1:]):  # reads a pending load's register
            runs.append(len(pending))
            pending = set()
        if op.startswith("LDG"):
            pending.add(regs[0])
    return {"loads": dict(loads), "global_loads_before_first_use": runs,
            "instructions": len(ins)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("ab", "variants"))
    ap.add_argument("root", type=Path, nargs="?", default=HERE)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))  # the tree's palace_tpu_torch

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smoke = k2_float32.load_smoke()
    dev = torch.device("cuda")
    with torch.inference_mode():
        out = {"ab": ab, "variants": variants}[args.mode](args, smoke, dev)
    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
