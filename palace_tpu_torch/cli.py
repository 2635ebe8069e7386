"""Command-line tools of the port.  The whole pipeline, the reference's
``palace --config`` (its six steps, ``pipeline/driver.py``):

    python -m palace_tpu_torch --config config.txt [--force] [--device cuda|cpu]

It runs on the CUDA device unless ``--device cpu``, and exits nonzero
without a card.  Each stage alone:

    python -m palace_tpu_torch score <contigs.fasta> <out> [--model PT]
        [--batch N] [--dtype float32|bfloat16|float16] [--device cuda|cpu]
    python -m palace_tpu_torch eref <fq1> <fq2> <phagedb> <out> [--k K]
        [--hit-ratio R] [--perfect-hit-ratio R] [--device cuda|cpu]

``score`` is the reference's phage_scoring.py stage: contig FASTA →
``node_scores.out``.  ``eref`` is the reference's bin/eref: paired reads
and a phagedb FASTA → ``ref_names.txt``, one ``ref_index`` line a hit
(also printed); the phagedb's index is cached beside it as
``{phagedb}.k{K}.palace.npz``.  Both run on the CUDA device unless
``--device cpu``.

The host stages between the mapped reads and the path FASTA take no
``--device``:

    python -m palace_tpu_torch graph <bam> <fastg.fai> <out> [--avg-depth D]
    python -m palace_tpu_torch depth <bam> <out>
    python -m palace_tpu_torch fastg2fa <in.fastg> <out.fasta>
    python -m palace_tpu_torch matching -g G -r LIN -c CYC [-s] [-b] [-i N]
        [-l contigs.paths] [--aggressive] [--exact | --no-exact]
    python -m palace_tpu_torch makefa <fasta> <paths> <out> [--mode 0|1]

``graph`` and ``depth`` are the reference's bin/generateGraph and
``samtools depth``, run by the native ``palace_native`` program (built
with g++ at first use) or, where it cannot be built, in Python with the
same output; ``fastg2fa`` is split_fastg.py, ``matching`` bin/matching
and ``makefa`` make_fa_from_path.py.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def _cmd_score(args) -> int:
    import torch

    from palace_tpu_torch.device import resolve_device
    from palace_tpu_torch.models.gcn import DEFAULT_CONFIG, init_params, load_torch_state_dict
    from palace_tpu_torch.models.scoring import resolve_dtype, score_fasta

    device = resolve_device(args.device)
    if args.model:
        params = load_torch_state_dict(args.model)
    elif args.allow_random_weights:
        params = init_params(torch.Generator().manual_seed(0), DEFAULT_CONFIG)
        print("warning: no --model; scoring with RANDOM weights", file=sys.stderr)
    else:
        print("error: no --model given; random-weight scores are garbage. "
              "Pass --model GCN_model_retrained.pt or opt in with "
              "--allow-random-weights.", file=sys.stderr)
        return 2
    score_fasta(params, args.fasta, args.out, batch_size=args.batch,
                dtype=resolve_dtype(args.dtype), device=device)
    return 0


def _cmd_eref(args) -> int:
    from palace_tpu_torch.config import KmerParams
    from palace_tpu_torch.device import resolve_device
    from palace_tpu_torch.search.eref import run_search
    from palace_tpu_torch.search.index import load_or_build_index

    device = resolve_device(args.device)
    params = KmerParams(k=args.k, hit_ratio=args.hit_ratio,
                        perfect_hit_ratio=args.perfect_hit_ratio)
    index = load_or_build_index(args.phagedb, k=args.k)
    for h in run_search(args.fq1, args.fq2, index, params, args.out, device=device):
        print(h.line())
    return 0


def _cmd_graph(args) -> int:
    from palace_tpu_torch.graph.native import build_graph

    build_graph(args.bam, args.fastg_fai, args.out, args.avg_depth)
    return 0


def _cmd_depth(args) -> int:
    from palace_tpu_torch.graph.native import compute_depth_file

    compute_depth_file(args.bam, args.out)
    return 0


def _cmd_fastg2fa(args) -> int:
    from palace_tpu_torch.io.fastg import fastg_to_node_fasta

    n = fastg_to_node_fasta(args.fastg, args.out)
    print(f"{n} nodes", file=sys.stderr)
    return 0


def _cmd_makefa(args) -> int:
    from palace_tpu_torch.assembly.path_fa import make_fa_from_path

    make_fa_from_path(args.fasta, args.paths, args.out, args.mode)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0].startswith("--") and argv[0] != "--help":
        from palace_tpu_torch.pipeline.driver import main as pipeline_main

        return pipeline_main(argv)
    if argv and argv[0] == "matching":
        from palace_tpu_torch.matching.solver import main as matching_main

        return matching_main(argv[1:])
    ap = argparse.ArgumentParser(prog="palace_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("score", help="GCN contig scoring (phage_scoring.py)")
    p.add_argument("fasta")
    p.add_argument("out")
    p.add_argument("--model", default="")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--dtype", default="float32",
                   help="compute dtype: float32 (default), bfloat16 or float16")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) or cpu; there is no fallback between them")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="score without a checkpoint (garbage probabilities; "
                        "tests/dev only)")
    p.set_defaults(fn=_cmd_score)

    p = sub.add_parser("eref", help="k-mer reference search (bin/eref)")
    p.add_argument("fq1")
    p.add_argument("fq2")
    p.add_argument("phagedb")
    p.add_argument("out")
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--hit-ratio", type=float, default=0.9)
    p.add_argument("--perfect-hit-ratio", type=float, default=0.85)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) or cpu; there is no fallback between them")
    p.set_defaults(fn=_cmd_eref)

    p = sub.add_parser("graph", help="junction graph from BAM (bin/generateGraph)")
    p.add_argument("bam")
    p.add_argument("fastg_fai")
    p.add_argument("out")
    p.add_argument("--avg-depth", type=float, default=0.0)
    p.set_defaults(fn=_cmd_graph)

    p = sub.add_parser("depth", help="per-base depth (samtools depth equivalent)")
    p.add_argument("bam")
    p.add_argument("out")
    p.set_defaults(fn=_cmd_depth)

    p = sub.add_parser("fastg2fa", help="FASTG → node FASTA (split_fastg.py)")
    p.add_argument("fastg")
    p.add_argument("out")
    p.set_defaults(fn=_cmd_fastg2fa)

    p = sub.add_parser("makefa", help="path file → FASTA (make_fa_from_path.py)")
    p.add_argument("fasta")
    p.add_argument("paths")
    p.add_argument("out")
    p.add_argument("--mode", type=int, default=0, choices=(0, 1))
    p.set_defaults(fn=_cmd_makefa)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
