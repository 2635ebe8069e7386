#!/usr/bin/env python3
"""K2's float32 route (``kernels.sage_rounds`` on float32 tensors) on one
CUDA card, at the first batch of ``chip_smoke.py``'s slice (512 contigs of
10 kb through the plain K1 and the node lifts, seeded weights).

    python palace_tpu_torch/tools/k2_float32.py ab ROOT [--iters N]
    python palace_tpu_torch/tools/k2_float32.py variants [--iters N]

Run it as a file, not with ``-m``: ``ab`` imports ROOT's package, which
must not be imported before it.

``ab``: the route of the tree at ROOT (this checkout, or an earlier commit
unpacked with ``git archive``; its kernels are built under ROOT): its time
and its max |error| against the plain version and the float64 sums, on
that batch and on ``chip_smoke.large_sage_inputs`` at 512.  To compare two
trees on one card, run it in one call on each in turns (a, b, b, a).

``variants``: the committed ``csrc/sage_rounds.cu`` beside copies that each
change one thing in ``sage_tf32_kernel``, built with nvcc into
``build/k2_float32_variants/`` and timed in turns, twice; then the rate that
``mma.sync`` m16n8k8 with TF32 operands reaches on the card.  A copy that
leaves work out computes wrong outputs: its time says what that work
costs, and its error is printed beside it.

Each mode prints one JSON line.  The inputs and the float64 sums come from
this checkout's ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout's root
TF32_PEAK = 495e12  # H100 SXM, dense, at 700 W (NVIDIA's data sheet)

# name → (anchor in csrc/sage_rounds.cu, replacement)
VARIANTS = {
    "two mma a step (no small·big)": (
        "          mma_tf32(acc[i][nj], as, b.big[ks][nj][0], b.big[ks][nj][1]);\n", ""),
    "big plane only (half the tile loads)": (
        "        const uint2 sl = *reinterpret_cast<const uint2*>(&a.small[r][k]);\n"
        "        const uint2 sh = *reinterpret_cast<const uint2*>(&a.small[r + 8][k]);\n",
        "        const uint2 sl = bl, sh = bh;\n"),
    "no pass-B elementwise": (
        "    const bool more = a + 1 < kF;\n", "    const bool more = false;\n"),
    "no pass-B product": (
        "    product_tf32(s.tile[a & 1], bfrag, nbase, lane, [&](int r, int c, int nj, float v0, "
        "float v1) {\n"
        "      __stcs(reinterpret_cast<float2*>(og + r * kGd + c),\n"
        "             make_float2(fmaxf(l2[nj].x + v0, 0.f), fmaxf(l2[nj].y + v1, 0.f)));\n"
        "    });\n",
        "    for (int r = lane >> 2; r < kF; r += 8)\n"
        "      for (int nj = 0; nj < 2; ++nj)\n"
        "        __stcs(reinterpret_cast<float2*>(og + r * kGd + nbase + 8 * nj + 2 * q), "
        "l2[nj]);\n"),
    "plain stores (no st.global.cs)": (
        "      __stcs(reinterpret_cast<float2*>(og + r * kGd + c),\n"
        "             make_float2(fmaxf(l2[nj].x + v0, 0.f), fmaxf(l2[nj].y + v1, 0.f)));\n",
        "      *reinterpret_cast<float2*>(og + r * kGd + c) =\n"
        "          make_float2(fmaxf(l2[nj].x + v0, 0.f), fmaxf(l2[nj].y + v1, 0.f));\n"),
}

# each warp: 4 independent accumulators, a chain of `iters` mma each
MMA_BENCH = r"""
#include "mma.cuh"
using namespace palace;
__global__ void mma_tf32_bench(float* out, int iters) {
  float acc[4][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], a, b0, b1);
  float s = 0.f;
  for (int j = 0; j < 4; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_tf32_run(float* out, int blocks, int threads, int iters, void* stream) {
  mma_tf32_bench<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def load_smoke():
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def slice_inputs(smoke, dev):
    """x_p, x_f and the stacked weights of the slice's first batch, float32."""
    import torch

    from palace_tpu_torch.models import gcn
    from palace_tpu_torch.ops import kernels
    from palace_tpu_torch.ops.encoder import byte_batch

    contigs = smoke.make_contigs(smoke.N_CONTIGS, smoke.CONTIG_LEN, smoke.SEED)[:smoke.BATCH]
    params = gcn.init_params(torch.Generator(device=dev).manual_seed(smoke.SEED))
    rows = [t.to(dev) for t in byte_batch([s for _, s in contigs])]
    feats = kernels.transition_features_bytes_plain(*rows)
    x_p, x_f = gcn.lift_inputs(params, *gcn.model_inputs_from_features(feats))
    return x_p.contiguous(), x_f.contiguous(), gcn.sage_weight_stack(params, torch.float32)


def ab(args, smoke, dev) -> dict:
    import torch

    from palace_tpu_torch.ops import _build, kernels
    from palace_tpu_torch.ops.compare import TOLERANCES, compare

    _build.build_all(["sage_rounds"])
    out = {"root": str(args.root)}
    inputs = {"slice": slice_inputs(smoke, dev),
              "large": smoke.large_sage_inputs(smoke.SAGE_ROUNDING_BATCH, torch.float32, dev)}
    for name, (xp, xf, w) in inputs.items():
        got = kernels.sage_rounds(xp, xf, w)
        errs = {}
        for ref, want in (("plain", kernels.sage_rounds_plain(xp, xf, w)),
                          ("float64", smoke.sage_sums64(xp, xf, w))):
            res = compare(got, want, TOLERANCES[torch.float32])
            errs[ref], errs[f"{ref}_steps"] = res["max_abs_err"], res["steps"]
            del want
        ms = smoke.cuda_ms(lambda: kernels.sage_rounds(xp, xf, w), args.iters)
        out[name] = dict(ms=ms, batch=xp.shape[0], **errs)
        del got
        torch.cuda.empty_cache()
    return out


def variants(args, smoke, dev) -> dict:
    import torch

    from palace_tpu_torch.ops import _build, kernels
    from palace_tpu_torch.ops.compare import TOLERANCES, compare

    csrc = _build.csrc_dir()
    src = (csrc / "sage_rounds.cu").read_text()
    work = HERE / "build" / "k2_float32_variants"
    work.mkdir(parents=True, exist_ok=True)
    sources = {"committed": src, "mma_tf32_bench": MMA_BENCH}
    out = {"variants": {}}
    for name, (anchor, repl) in VARIANTS.items():
        if src.count(anchor) != 1:
            out["variants"][name] = "anchor not found in csrc/sage_rounds.cu"
            continue
        sources[name] = src.replace(anchor, repl)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, lib = work / f"v{i}.cu", work / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            out["variants"][name] = f"nvcc failed: {log[-400:]}"
            continue
        libs[name] = ctypes.CDLL(str(lib))
        regs = [line for line in smoke.ptxas_summary(log) if "sage_tf32" in line]
        if name != "mma_tf32_bench":
            out["variants"][name] = dict(ptxas=regs, ms=[])

    stream = torch.cuda.current_stream().cuda_stream
    xp, xf, w = slice_inputs(smoke, dev)
    want = kernels.sage_rounds_plain(xp, xf, w)
    got = torch.empty_like(want)
    for name, lib in libs.items():
        if name != "mma_tf32_bench":
            lib.palace_sage_rounds.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]

    def launch(lib):
        err = lib.palace_sage_rounds(xp.data_ptr(), xf.data_ptr(), w.data_ptr(), got.data_ptr(),
                                     xp.shape[0], 0, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    for _ in range(2):  # in turns
        for name, rec in out["variants"].items():
            if isinstance(rec, dict):
                rec["ms"].append(smoke.cuda_ms(lambda: launch(libs[name]), args.iters))
                rec["max_abs_err"] = compare(got, want, TOLERANCES[torch.float32])["max_abs_err"]

    bench = libs.get("mma_tf32_bench")
    if bench is not None:
        bench.mma_tf32_run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rates = {}
        for per_sm, threads in ((1, 256), (2, 256), (4, 256)):
            buf = torch.empty(sms * per_sm * threads, device=dev)
            iters = 4096
            ms = smoke.cuda_ms(lambda: bench.mma_tf32_run(buf.data_ptr(), sms * per_sm, threads,
                                                          iters, stream), 5)
            flop = sms * per_sm * threads // 32 * iters * 4 * 2 * 16 * 8 * 8
            rates[f"{per_sm} x {threads} threads an SM"] = flop / (ms * 1e-3) / 1e12
        out["mma_tf32_tflops"] = rates
        out["tf32_peak_tflops"] = TF32_PEAK / 1e12
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("ab", "variants"))
    ap.add_argument("root", type=Path, nargs="?", default=HERE)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))  # the tree's palace_tpu_torch

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smoke = load_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with torch.inference_mode():
        out = (ab if args.mode == "ab" else variants)(args, smoke, dev)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
