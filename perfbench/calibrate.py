"""Readings that the limits of ``correct`` are set from (not part of a
benchmark run).

For each seed, in one process: the program's numbers from a run of the
cell with a short window, the control's numbers (the plain reference one
precision lower in the program's place, on the same inputs), and each
planted fault's numbers (``faults.py``): every number the cell's driver
compares, whether or not the cell's limits hold it.  One JSON line a
reading:

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 \
        [--seconds 1] [--control-seeds 1 2 3] [--fault-seeds 1 2 3] \
        [--out readings.jsonl]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

from perfbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    help="the faults to plant (default: every one the "
                    "driver has)")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell.traffic["driver"])
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, checks, **extra):
        row = {"workload": args.workload, "kind": kind, "seed": seed,
               "checks": checks, **extra}
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()

    def program(seed):
        ctx = harness.Context(cell, seed, args.seconds, False, dev,
                              time.perf_counter())
        got = drv.run(ctx)
        return got["checks"], got

    for seed in args.seeds:
        checks, got = program(seed)
        emit("program", seed, checks, metrics=got["e2e"],
             memory_peak_bytes=got["device"]["memory_peak_bytes"])
    for seed in args.control_seeds:
        t = time.perf_counter()
        ctx = harness.Context(cell, seed, args.seconds, False, dev, t)
        emit("control", seed, drv.control_checks(ctx),
             seconds=time.perf_counter() - t)
    for seed in args.fault_seeds:
        for name in args.faults or drv.FAULTS:
            with drv.fault(name):
                checks, _ = program(seed)
            emit("fault:" + name, seed, checks)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
