"""The program's ``serve`` as the explore cells run it:
``python -m peleanalysis_tpu_torch serve`` through ``cli.main``, with the
benchmark's window signals.

SIGUSR1 starts the window: the peak device memory is reset and, in a
traced run, the profiler and the metrics' hooks start.  SIGUSR2 ends it:
the window's peak is read and the trace taken.  Both run on the main
thread, between commands.  When the server shuts down, the record (peak,
trace, hooks, and any JAX module this process holds) goes to
``--record`` as JSON.

Usage: ``python -m portbench.serve_child --socket S --record R
[--hooks H.json] [--trace 0|1]``
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "peleanalysis_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``peleanalysis_tpu_torch`` is not ``peleanalysis_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--socket", required=True)
    ap.add_argument("--record", required=True)
    ap.add_argument("--hooks", default="")
    ap.add_argument("--trace", type=int, default=0)
    a = ap.parse_args()

    import torch
    from peleanalysis_tpu_torch import cli

    from .hooks import Hooks
    from .devtrace import Tracer

    hooks = []
    if a.hooks:
        with open(a.hooks) as f:
            hooks = json.load(f)
    state = {"peak_window": 0, "trace": None, "hooks": None}
    live = {}

    def start(signum, frame):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if a.trace:
            live["hooks"] = Hooks(hooks).install()
            live["tracer"] = Tracer()
            live["tracer"].start()

    def stop(signum, frame):
        if a.trace and "tracer" in live:
            state["trace"] = live.pop("tracer").stop()
            hk = live.pop("hooks")
            hk.uninstall()
            state["hooks"] = hk.record()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            state["peak_window"] = torch.cuda.max_memory_allocated()

    signal.signal(signal.SIGUSR1, start)
    signal.signal(signal.SIGUSR2, stop)
    try:
        rc = cli.main(["serve", f"socket={a.socket}", "idle_timeout=0"])
    finally:
        state["forbidden"] = forbidden_modules()
        tmp = a.record + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, a.record)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
