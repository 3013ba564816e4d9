"""Readings that the limits of ``correct`` are set from: for each seed, one
run of the cell (a short window at its own load) compared with the
reference, and the control (the reference in the nearest precision below
the configuration's, in the program's place) compared the same way, all
in one process.  The benchmark's own runs never run it.

    python3 portbench/control.py --workload <name> --seconds <s>
                                 --seeds <n> [<n> ...]

One JSON line a seed: ``{"seed", "correct", "program": {number: value},
"control": {number: value}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    sys.path[0] = ROOT
    from portbench.run import caches
    caches()
    import torch

    from portbench.harness import run_cell
    from portbench.spec import Cell, load_benchmark

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    cell = Cell(load_benchmark(), a.workload)
    for seed in a.seeds:
        t0 = time.time()
        out = run_cell(cell, seed, a.seconds, False, "cuda",
                       lambda: time.time() - t0, control=True)
        print(json.dumps({
            "seed": seed, "correct": out["correct"],
            "jobs": out["attempted"], "failed": out["failed"],
            "program": {k: c["value"] for k, c in out["checks"].items()},
            "control": out["control"], "seconds": time.time() - t0}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
