"""Command-line tools of the port:

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


def main(argv: Optional[Sequence[str]] = None) -> int:
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
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
