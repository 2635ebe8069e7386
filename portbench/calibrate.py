"""Readings the check's limits are set from, for one cell, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each seed of ``--seeds`` it sets the cell up as a run does (inputs
and weights from the seed, the warm sample), runs one more sample
through the program and prints the numbers the check compares: the
lower readings.  For each of ``--control-seeds`` it prints the numbers
of the cell's control (``limits/<cell>.json`` ``control``): the plain
reference computed one precision lower, or with a table of fewer bits,
put in the program's place: the upper readings.  The benchmark's own
runs never run the control.  Needs the cell's cards.
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(parts, seed, device, control=None):
    import torch

    from portbench.harness.cell import load_driver

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        driver = load_driver(parts["mix"]["driver"])(parts["config"], parts["mix"], seed,
                                                     device, Path(tmp))
        try:
            driver.setup()
            if control is None:
                driver.sample()
            driver.release()
            torch.cuda.empty_cache()
            numbers = driver.check(**(control or {}))
            return numbers, getattr(driver, "info", {})
        finally:
            driver.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import cell

    parts = cell.find_cell(cell.load_json(ROOT / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(cell.card_line(device), flush=True)
    lower, upper = {}, {}
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), parts["limits"]["control"]) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t = time.perf_counter()
        numbers, info = readings(parts, seed, device, control)
        side = upper if control else lower
        for k, v in numbers.items():
            side.setdefault(k, []).append(v)
        print(json.dumps({"seed": seed, "control": control, "numbers": numbers, "info": info,
                          "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({"workload": args.workload,
                      "lower": {k: max(v) for k, v in lower.items()},
                      "upper": {k: min(v) for k, v in upper.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
