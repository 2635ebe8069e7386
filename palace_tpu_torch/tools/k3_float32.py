#!/usr/bin/env python3
"""K3's float32 route (``kernels.conv_head`` on float32 tensors) on one
CUDA card: its input at the first batch of ``chip_smoke.py``'s slice (512
contigs of 10 kb through the plain K1, the node lifts and the plain SAGE
rounds, seeded weights), and ``chip_smoke.large_conv_inputs``, whose
outputs reach 40.

    python palace_tpu_torch/tools/k3_float32.py ab ROOT [--iters N]
    python palace_tpu_torch/tools/k3_float32.py variants [--iters N]
    python palace_tpu_torch/tools/k3_float32.py sass

Run it as a file, not with ``-m``: ``ab`` imports ROOT's package, which
must not be imported before it.

``ab``: the route of the tree at ROOT (this checkout, or an earlier commit
unpacked with ``git archive``; its kernels are built under ROOT): the time
of the three layers, and their max |error| against the plain version and
the float64 sums, on both inputs.  To compare two trees on one card, run
it in one call on each in turns (a, b, b, a).

``variants``: the committed ``csrc/conv_head.cu`` beside copies that each
change one thing in ``conv_tf32_kernel``, built with nvcc into
``build/k3_float32_variants/`` and timed in turns, twice, on the slice's
input.  A copy that leaves work out computes wrong outputs: its time says
what that work costs, and its error is printed beside it.

``sass``: the committed source built to a cubin and read back with
``cuobjdump -sass``: the instructions of ``conv_tf32_kernel`` by opcode,
the whole kernel, whose slice loop is unrolled once (768 HMMA).

Each mode prints one JSON line.  The inputs and the float64 sums come from
this checkout's ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import k2_float32

HERE = k2_float32.HERE

# name → (anchor in csrc/conv_head.cu, replacement)
VARIANTS = {
    "two mma a step (no small·big)": (
        "            mma_tf32(part[mi][nj], as, bb[nj][0], bb[nj][1]);\n", ""),
    "A's big plane only (a third fewer loads)": (
        "          const uint4 vs = *reinterpret_cast<const uint4*>"
        "(cur.w[k][ks][obase / 16 + mi][1][lane]);\n",
        "          const uint4 vs = vb;\n"),
    "no split pass (each stage keeps its first input)": (
        "          if (more) split_x(nxt, raw);\n", ""),
    "no input copies": (
        "      load_x(raw, x_at(ntile, nslice), L_in, (ntile % tiles_per_row) * kTileF);\n", ""),
    "split after the products": (
        "        if (k == kTaps / 2 - 1 && ks == 1) {", "        if (k == kTaps - 1 && ks == 1) {"),
    "no weight stream (each stage keeps its first weights)": (
        "      load_w(nxt, ws, nslice);\n", ""),
    "no epilogue stores": (
        "ob[(size_t)o * L_out + p] = ost[o][p];", "(void)0;"),
    "16 warps of 32 channels x 32 positions": (
        "constexpr int kWarpM = 64, kWarpN = 32;", "constexpr int kWarpM = 32, kWarpN = 32;"),
    "8 warps of 32 channels x 64 positions": (
        "constexpr int kWarpM = 64, kWarpN = 32;", "constexpr int kWarpM = 32, kWarpN = 64;"),
}


def slice_conv_input(smoke, dev):
    """K3's float32 input on the slice's first batch: the SAGE rounds'
    output in the raw channel-scramble view (512, 128, 4096), and the
    seeded conv weights and biases."""
    import torch

    from palace_tpu_torch.models import gcn
    from palace_tpu_torch.ops import kernels

    x_p, x_f, w = k2_float32.slice_inputs(smoke, dev)
    params = gcn.init_params(torch.Generator(device=dev).manual_seed(smoke.SEED))
    x = kernels.sage_rounds_plain(x_p, x_f, w).reshape(x_p.shape[0], w.shape[1], x_p.shape[1])
    return (x, [params[f"conv{i}.w"] for i in (1, 2, 3)],
            [params[f"conv{i}.b"] for i in (1, 2, 3)])


def ab(args, smoke, dev) -> dict:
    import torch

    from palace_tpu_torch.ops import _build, kernels
    from palace_tpu_torch.ops.compare import CONV_LARGE_OUTPUTS, compare

    _build.build_all(["conv_head"])
    out = {"root": str(args.root)}
    inputs = {"slice": slice_conv_input(smoke, dev),
              "large": smoke.large_conv_inputs(smoke.ROUNDING_SHAPE, torch.float32, dev)}
    for name, (x, ws, bs) in inputs.items():
        got = kernels.conv_head(x, ws, bs)
        errs = {}
        for ref, want in (("plain", kernels.conv_head_plain(x, ws, bs)),
                          ("float64", smoke.conv_sums(x, ws, bs, torch.float64))):
            res = compare(got, want, CONV_LARGE_OUTPUTS[torch.float32])
            errs[ref], errs[f"{ref}_steps"] = res["max_abs_err"], res["steps"]
            del want
        ms = smoke.cuda_ms(lambda: kernels.conv_head(x, ws, bs), args.iters)
        out[name] = dict(ms=ms, shape=list(x.shape), **errs)
        del got
        torch.cuda.empty_cache()
    return out


def variants(args, smoke, dev) -> dict:
    import torch

    from palace_tpu_torch.ops import _build, kernels
    from palace_tpu_torch.ops.compare import TOLERANCES, compare

    csrc = _build.csrc_dir()
    src = (csrc / "conv_head.cu").read_text()
    work = HERE / "build" / "k3_float32_variants"
    work.mkdir(parents=True, exist_ok=True)
    sources = {"committed": src}
    out = {"variants": {}}
    for name, (anchor, repl) in VARIANTS.items():
        if src.count(anchor) != 1:
            out["variants"][name] = "anchor not found in csrc/conv_head.cu"
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
        libs[name].palace_conv_layer.argtypes = _build.KERNELS["conv_head"][2]
        regs = [line for line in smoke.ptxas_summary(log) if "conv_tf32" in line]
        out["variants"][name] = dict(ptxas=regs, ms=[])

    stream = torch.cuda.current_stream().cuda_stream
    x, ws, bs = slice_conv_input(smoke, dev)
    want = kernels.conv_head_plain(x, ws, bs)
    B, L = x.shape[0], x.shape[2]
    outs = [torch.empty(B, 64, L - 7 * (i + 1), device=dev) for i in range(3)]
    splits = [torch.empty(2 * w.numel(), dtype=torch.int32, device=dev) for w in ws]

    def head(lib):
        y = x
        for w, b, o, s in zip(ws, bs, outs, splits):
            err = lib.palace_conv_layer(y.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(),
                                        s.data_ptr(), B, w.shape[1], y.shape[2], 0, 1, 1, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            y = o

    for _ in range(2):  # in turns
        for name, rec in out["variants"].items():
            if isinstance(rec, dict):
                rec["ms"].append(smoke.cuda_ms(lambda: head(libs[name]), args.iters))
                rec["max_abs_err"] = compare(outs[2], want,
                                             TOLERANCES[torch.float32])["max_abs_err"]
    return out


def sass(args, smoke, dev) -> dict:
    from palace_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    work = HERE / "build" / "k3_float32_variants"
    work.mkdir(parents=True, exist_ok=True)
    cubin = work / "conv_head.cubin"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-o", str(cubin), str(_build.csrc_dir() / "conv_head.cu")],
                   check=True, capture_output=True)
    text = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True).stdout
    fn = next(f for f in text.split("Function : ")[1:] if f.split()[0].find("conv_tf32") >= 0)
    ops = Counter(m.split(".")[0] for m in re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", fn))
    return {"sass": dict(ops.most_common()), "instructions": sum(ops.values())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("ab", "variants", "sass"))
    ap.add_argument("root", type=Path, nargs="?", default=HERE)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))  # the tree's palace_tpu_torch

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smoke = k2_float32.load_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    with torch.inference_mode():
        out = {"ab": ab, "variants": variants, "sass": sass}[args.mode](args, smoke, dev)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
