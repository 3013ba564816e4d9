"""The program's ``serve`` as the explore cells run it:
``python -m peleanalysis_tpu_torch serve`` through ``cli.main``, with the
benchmark's window signals.

SIGUSR1 starts the window: every visible card is synchronised, each
card's peak device memory reset and, in a traced run, the profiler and the
metrics' hooks start.  SIGUSR2 ends it: the cards are synchronised, each
card's peak read and the trace taken.  Both run on the main
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

from . import cards
from .devtrace import Tracer
from .hooks import Hooks

FORBIDDEN = ("jax", "jaxlib", "flax", "peleanalysis_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``peleanalysis_tpu_torch`` is not ``peleanalysis_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Window:
    """The server's window, opened and closed by the signals: every
    visible card synchronised, each card's peak reset at the start and
    read at the end (the fullest card's is ``peak_window``), and in a
    traced run the profiler and the metrics' hooks."""

    def __init__(self, hooks: list, trace: bool):
        self.hooks, self.trace = hooks, trace
        self.state = {"peak_window": 0, "peak_by_card": [], "trace": None,
                      "hooks": None}
        self.live = {}

    def start(self, signum=None, frame=None) -> None:
        cards.sync()
        cards.reset_peaks()
        if self.trace:
            self.live["hooks"] = Hooks(self.hooks).install()
            self.live["tracer"] = Tracer()
            self.live["tracer"].start()

    def stop(self, signum=None, frame=None) -> None:
        if self.trace and "tracer" in self.live:
            self.state["trace"] = self.live.pop("tracer").stop()
            hk = self.live.pop("hooks")
            hk.uninstall()
            self.state["hooks"] = hk.record()
        cards.sync()
        peaks = cards.peaks()
        self.state["peak_by_card"] = peaks
        self.state["peak_window"] = max(peaks, default=0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--socket", required=True)
    ap.add_argument("--record", required=True)
    ap.add_argument("--hooks", default="")
    ap.add_argument("--trace", type=int, default=0)
    a = ap.parse_args()

    from peleanalysis_tpu_torch import cli

    hooks = []
    if a.hooks:
        with open(a.hooks) as f:
            hooks = json.load(f)
    win = Window(hooks, bool(a.trace))
    signal.signal(signal.SIGUSR1, win.start)
    signal.signal(signal.SIGUSR2, win.stop)
    state = win.state
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
