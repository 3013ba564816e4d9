"""Phase 8 of chip_smoke.py (the main path: grad -> curvature -> isosurface
of one float32 state, median CUDA-event ms of each stage) of two checkouts,
in turns on one card, each run in a fresh process: A, B, B, A.  Needs one
CUDA card; run from the repository root:

    mkdir -p build/parent                # gitignored
    git archive <commit> | tar -x -C build/parent
    python3 main_path_ab.py build/parent . --out build/ab.jsonl

Each tree holds chip_smoke.py and peleanalysis_tpu_torch/; its run builds
its own grad_mag kernel and writes the repo and production plotfiles of
chip_smoke.py phases 4 and 5 with its own testing module.  Prints one JSON
line a run ({"tree", "turn", "main_path"}) and writes them to --out, then
the card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def run_tree(tree: str) -> None:
    """One run of phase 8 with ``tree``'s own modules (in this process)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from peleanalysis_tpu_torch.ops import grad_kernels as gk
    if not cs.__file__.startswith(tree) or not gk.__file__.startswith(tree):
        raise RuntimeError(f"{tree}: imported {cs.__file__}, {gk.__file__}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda is not available")
    gk.build()
    gk.load_library()
    os.makedirs(os.path.join(tree, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(tree, "build")) as tmp:
        for name, case in (("plt_repo", cs.REPO_CASE),
                           ("plt_prod", cs.PROD_CASE)):
            cs.write_synthetic_plotfile(
                os.path.join(tmp, name),
                fields={"temp": cs.default_fields()["temp"]}, **case)
        cs.phase_main_path(tmp, torch.device("cuda"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="checkout A (run first and last)")
    ap.add_argument("b", help="checkout B (run second and third)")
    ap.add_argument("--out", default=None, help="JSON lines file")
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_tree(args.run)
        return 0
    lines = []
    for turn, tree in enumerate((args.a, args.b, args.b, args.a)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              args.a, args.b, "--run", tree],
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            raise RuntimeError(f"{tree}: exit {res.returncode}")
        phase = [json.loads(s) for s in res.stdout.splitlines()
                 if s.startswith('{"phase": "main_path"')]
        if len(phase) != 1:
            raise RuntimeError(f"{tree}: no main_path line")
        lines.append({"tree": tree, "turn": turn, "main_path": phase[0]})
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
