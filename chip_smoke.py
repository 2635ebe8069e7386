#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

The main path is the scoring stage, contig FASTA → ``node_scores.out``:
2-bit packed contigs → transition-count features (kernel K1) → the GCN
scorer at its published width (``GCNConfig()``), whose SAGE rounds (K2)
and conv head (K3) are CUDA kernels, with the large products in cuBLAS.
The workload is the one the scorer's users run: batches of 512 random
10 kb contigs in bfloat16, weights drawn from a seeded generator.

Phases, each of which must pass:

1. the card's name and power limit, the torch and CUDA versions;
2. the kernels, built from ``palace_tpu_torch/csrc`` with nvcc for sm_90a,
   with the registers, shared memory and spills ptxas reports;
3. each kernel at the main path's shapes against its plain PyTorch
   version on the same inputs (K1 equal; K2 and K3 within
   ``ops.compare.TOLERANCES``), in float32 and bfloat16, with its time,
   its bound, the plain version's time and, for K3, cuDNN's;
4. the slice: ``score_sequences`` over 16 batches of 512 contigs in
   bfloat16 with every launch counter reset just before and read just
   after; then one batch in float32 and in bfloat16 against the plain
   versions on the card, and a few contigs against the plain path on
   the CPU;
5. where the time goes: the host's packing time for a batch, and device
   time by kernel over 4 batches from torch.profiler;
6. a ``kernels`` JSON line, then, last, ``{"ok": true, "device": ...}``.

It exits nonzero, printing no result, without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import json
import sys
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
PROB_ATOL = 2e-4        # float32 probabilities, kernels against plain versions
PROB_ATOL_BF16 = 2e-2   # bfloat16 probabilities (inputs and weights rounded to 8 bits)

# H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.float16: 989e12}

KERNELS = {  # name → (CUDA source, the Pallas call it replaces)
    "transition_counts": ("palace_tpu_torch/csrc/transition_counts.cu",
                          "palace_tpu/ops/pallas_kernels.py:154"),
    "sage_rounds": ("palace_tpu_torch/csrc/sage_rounds.cu",
                    "palace_tpu/ops/pallas_kernels.py:462"),
    "conv_head": ("palace_tpu_torch/csrc/conv_head.cu",
                  "palace_tpu/ops/pallas_kernels.py:324"),
}
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}


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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def ptxas_summary(log: str) -> list:
    """ptxas -v output → one line per compiled entry: its working dtype,
    registers, shared memory and spills."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = ("bf16" if "bfloat16" in name else "f16" if "__half" in name
                     else "f32" if "IfE" in name else "-")
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


class Smoke:
    def __init__(self, device: str = "cuda"):
        self.dev = torch.device(device)
        self.failures: list = []
        self.records: dict = {}

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
        for name in libs:
            for line in ptxas_summary(_build.PTXAS_LOG[name]):
                say(f"  {name} {line}")
        self.check(_build.kernels_built(), "every kernel built for sm_90a")

    # -- phase 3 -----------------------------------------------------------
    def kernels_at_main_shapes(self, params, contigs):
        from palace_tpu_torch.models import gcn
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.compare import TOLERANCES, compare
        from palace_tpu_torch.ops.encoder import pack_contigs

        dev = self.dev
        packed, n_codes, lens = (torch.from_numpy(a).to(dev)
                                 for a in pack_contigs([s for _, s in contigs[:BATCH]]))

        # K1: integer counts, so equal
        feats = kernels.transition_features(packed, n_codes, lens)
        plain = kernels.transition_features_plain(packed, n_codes, lens)
        torch.cuda.synchronize()
        self.check(torch.equal(feats, plain),
                   f"K1 transition_counts equals its plain version at {tuple(packed.shape)}")
        n_locs = torch.clamp(n_codes.long() - 2, min=0)
        pairs = float(sum(torch.clamp(n_locs - 3 - d, min=0).sum() for d in range(3)))
        self.records["transition_counts"] = dict(
            dtype="int32 counts, float32 out",
            max_abs_err=float((feats - plain).abs().max()),
            ms=cuda_ms(lambda: kernels.transition_features(packed, n_codes, lens), 20),
            plain_ms=cuda_ms(lambda: kernels.transition_features_plain(packed, n_codes, lens), 3),
            bound=bound(nbytes(packed, n_codes, lens, feats), pairs, torch.float32),
            library_ms=None)

        for dt in (torch.float32, torch.bfloat16):
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
                library_ms=cuda_ms(cudnn, 5))
            for name, rec in (("sage_rounds", sage_rec), ("conv_head", conv_rec)):
                self.records[name if dt == torch.bfloat16 else f"{name}/float32"] = rec
            del got, x, y
            torch.cuda.empty_cache()
        for name, rec in self.records.items():
            b, by = rec["bound"]
            lib = "-" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
            say(f"  {name:<20} {rec['dtype']:<26} kernel {rec['ms']:.4f} ms  "
                f"plain {rec['plain_ms']:.4f} ms  library {lib} ms  "
                f"bound {b:.4f} ms ({by})  max_abs_err {rec['max_abs_err']:.3g}")

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
        for name in KERNELS:
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

    def where_the_time_goes(self, params, contigs, n_batches: int = 4):
        """The host's packing time for one batch, and the device time by
        kernel over ``n_batches`` batches of the main path (torch.profiler)."""
        from torch.profiler import ProfilerActivity, profile

        from palace_tpu_torch.models.scoring import score_sequences
        from palace_tpu_torch.ops.encoder import pack_contigs

        seqs = [s for _, s in contigs[:BATCH]]
        t0 = time.perf_counter()
        pack_contigs(seqs)
        say(f"  host pack_contigs: {(time.perf_counter() - t0) * 1e3:.2f} ms for {BATCH} contigs")
        part = contigs[:n_batches * BATCH]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            score_sequences(params, part, batch_size=BATCH, dtype=torch.bfloat16, device=self.dev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms, calls = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
        busy_ms = sum(ms for ms, _ in by_name.values())
        if not by_name:
            say("  device time by kernel: not measured (the profiler saw no device events)")
            return
        say(f"  profile of {n_batches} batches, bfloat16: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
            f"{wall_ms / n_batches:.2f} ms per batch")
        for name, (ms, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            say(f"    {ms / n_batches:9.3f} ms/batch  {calls:4d} calls  {name[:90]}")

    def slice_against_plain(self, params):
        """One batch through the kernels against the plain versions on the
        card, and a few contigs against the plain path on the CPU.  d1 and d2
        are scaled and the contigs' GC share varies, so the probabilities
        spread (fan-in weights put them all at about 0.507)."""
        from palace_tpu_torch.models.gcn import GCNScorer
        from palace_tpu_torch.models.scoring import score_sequences
        from palace_tpu_torch.ops import kernels
        from palace_tpu_torch.ops.encoder import pack_contigs

        p = dict(params, **{"d1.w": params["d1.w"] * 3.0, "d2.w": params["d2.w"] * 30.0})
        batch, dev = make_contigs(BATCH, CONTIG_LEN, SEED + 2, gc_spread=True), self.dev
        for dt, atol in ((None, PROB_ATOL), (torch.bfloat16, PROB_ATOL_BF16)):
            got = np.array([v for _, v in score_sequences(p, batch, batch_size=BATCH,
                                                            dtype=dt, device=dev)])
            model = GCNScorer(p).to(dev)
            model = model.to(dt) if dt is not None else model
            packed = [torch.from_numpy(a).to(dev) for a in pack_contigs([s for _, s in batch])]
            want = model.score_features(kernels.transition_features_plain(*packed),
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


def run_phases(smoke: Smoke) -> None:
    """Phases 3 and 4 on ``smoke.dev``."""
    from palace_tpu_torch.models.gcn import init_params

    with torch.inference_mode():
        contigs = smoke.phase("contigs", make_contigs, N_CONTIGS, CONTIG_LEN, SEED)
        params = init_params(torch.Generator(device=smoke.dev).manual_seed(SEED))
        smoke.phase("kernels at the main path's shapes", smoke.kernels_at_main_shapes,
                    params, contigs)
        smoke.phase("slice", smoke.slice, params, contigs)
        smoke.phase("where the time goes", smoke.where_the_time_goes, params, contigs)
        smoke.phase("slice against the plain versions", smoke.slice_against_plain, params)


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

    smoke.phase("build", smoke.build)
    if not smoke.failures:
        run_phases(smoke)
    if smoke.failures:
        say("FAILED: " + "; ".join(smoke.failures))
        return 1
    launches = smoke.records["slice"]["launches"]
    rows = []
    for name, (source, replaces) in KERNELS.items():
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
