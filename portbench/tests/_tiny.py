"""Tiny cells for the CPU: the package's scorer at small widths (the
feature width stays 12,288) and eref at k = 16 on a small world."""
import copy
import time

import torch

from portbench.harness import cell

GCN = {"hidden_dim": 3, "fnode_num": 64, "gcn_dim": 16, "cnn_dim": 8, "fc_dim": 8,
       "num_layers": 2, "drop_rate": 0.2, "conv_kernel": 8}
SCORE_MIX = {"driver": "score", "contigs": 12,
             "special": [[["random", 3000]], [["AT", 500]], [["N", 900], ["random", 500]]],
             "lengths_seed": 0, "median_len": 800, "sigma": 0.5, "min_len": 300, "max_len": 5000,
             "gap_every": 4, "gap_len": 100, "gc_range": [0.3, 0.7]}
KMER = {"k": 16, "coder_num": 3, "least_depth": 3, "window": 500, "hit_ratio": 0.9,
        "perfect_hit_ratio": 0.85, "min_cover_ratio": 0.75, "down_sampling_size": 2000000000,
        "coder_seed": 1}
EREF_MIX = {"driver": "eref", "refs": 60, "ref_len_min": 2000, "ref_len_max": 8000,
            "lengths_seed": 7, "present": 6, "outside_genomes": 20, "abundance_log_mu": 1.0,
            "abundance_log_sigma": 2.0, "outside_share": 0.7, "reads": 6000, "read_len": 150,
            "substitution_rate": 0.001}
SEED = 2**31 + 12345
CPU = torch.device("cpu")


def bench() -> dict:
    return cell.load_json(cell.ROOT / "BENCHMARK.json")


def parts(kind: str, dtype: str = "float32") -> dict:
    """The parts of a tiny cell: ``score`` (in ``dtype``) or ``eref``, held to
    the limits of the real cell of that kind."""
    if kind == "score":
        name = "palace_f32.score_assembly" if dtype == "float32" else "palace_bf16.score_assembly"
        config = {"gcn": dict(GCN), "score": {"batch_size": 8, "dtype": dtype}}
        mix = copy.deepcopy(SCORE_MIX)
    else:
        name = "palace_f32.eref_virome"
        config, mix = {"kmer": dict(KMER)}, dict(EREF_MIX)
    limits = cell.load_json(cell.BENCH / "limits" / f"{name}.json")
    return {"cell": {"name": name, "chips": 1}, "config": config, "mix": mix, "limits": limits}


def run(p: dict, seconds: float = 0.2, trace: bool = False) -> dict:
    return cell.run_cell(bench(), p, SEED, seconds, trace, CPU, time.perf_counter(),
                         say=lambda s: None)
