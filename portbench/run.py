"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this directory
and the program (``peleanalysis_tpu_torch``).  The run writes its inputs
from the seed under ``TMPDIR``, warms up every shape its traffic uses,
measures for ``--seconds``, compares a sample of what the window wrote with
the plain reference, and prints one JSON object as the last line of
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``, with the device's busy time and a
breakdown), and last the numbers compared, each beside its limit (also the
last lines of standard error).  The run sees the cell's ``chips`` cards and
no others (``narrow_cards``) and measures each of them.  It exits non-zero,
printing no result, without enough CUDA cards (3), when the program is
missing (4), when a JAX module is loaded once the window has closed (5), or
when the inputs would not fit on the disk under ``TMPDIR`` (6).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_start() -> float:
    """This process's start on ``time.time``'s clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()


def caches() -> None:
    """Kernel and build caches inside the checkout, at fixed paths; no
    library loads JAX; one PyTorch CPU thread."""
    base = os.path.join(ROOT, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one PyTorch CPU thread, here and in the server: the default pool of
    # one thread a CPU competes with the reader's threads and the
    # write-back thread, which slows a job and spreads its runs
    os.environ["OMP_NUM_THREADS"] = "1"


def narrow_cards(chips: int) -> None:
    """Let this process and its children see the first ``chips`` cards of
    those visible (of ``CUDA_VISIBLE_DEVICES`` where it is set).  Before
    CUDA starts: ``torch.cuda.device_count()`` may keep its first answer."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [str(i) for i in range(chips)] if vis is None else \
        [x.strip() for x in vis.split(",") if x.strip()]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    caches()
    # the checkout, not this directory, is where modules are found
    sys.path[0] = ROOT
    from portbench.spec import Cell, load_benchmark

    cell = Cell(load_benchmark(), a.workload)
    narrow_cards(cell.chips)
    import torch

    from portbench.gen import NoRoom
    from portbench.harness import forbidden_modules, report, run_cell

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    try:
        import peleanalysis_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 4
    try:
        out = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                       lambda: time.time() - T_START)
    except NoRoom as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 6
    bad = sorted(set(forbidden_modules()) | set(out.pop("server_modules")))
    if bad:
        print(f"portbench: JAX modules loaded: {bad}", file=sys.stderr)
        return 5
    report(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
