"""Run one cell of the port's benchmark; the last line of stdout is its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs as many CUDA cards as the cell asks for, and exits 2 without them,
printing no result.  Set-up is counted from the process's start.  The
port's kernels build into ``build/`` inside the checkout on the first
run and are loaded from there after.
"""
import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def process_age_s() -> float:
    """Seconds since this process started (from /proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    t0 = time.perf_counter() - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of compilers the program may use, at fixed paths in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from portbench.harness import cell

    return cell.main(args, t0)


if __name__ == "__main__":
    sys.exit(main())
