"""Spans and call records taken from the benchmark's side, around calls
into the program's layers, in traced runs only.

A metric's ``HOOKS`` lists what it needs, each one of:

* ``{"span": name, "target": "module:function"}``: host seconds inside
  every call of the function (any thread);
* ``{"span": name, "open_in": [modules]}``: host seconds inside every
  ``with open(path, "w...")`` block of those modules (the text and
  binary writers);
* ``{"calls": name, "target": "module:function"}``: the shapes and
  scalars of every call's arguments, for operation and byte counts.

A function is replaced in every module of the program that holds it under
any name, so a caller that imported it by name is seen too.  ``Hooks``
also keeps one span a pipeline stage or server command (``stage.<tool>``),
for the breakdown of idle time.
"""
from __future__ import annotations

import builtins
import functools
import importlib
import sys
import threading
import time
from typing import Dict, List

import torch

PACKAGE = "peleanalysis_tpu_torch"


def describe(x, depth: int = 0):
    """Shapes and sizes of tensors, values of scalars, lengths of the
    rest."""
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape), "itemsize": x.element_size(),
                "dtype": str(x.dtype).replace("torch.", "")}
    if isinstance(x, (bool, int, float)) or x is None:
        return x
    if isinstance(x, (list, tuple)) and depth < 2:
        return [describe(v, depth + 1) for v in x]
    try:
        return {"len": len(x)}
    except TypeError:
        return str(type(x).__name__)


class Hooks:
    def __init__(self, hooks: List[dict]):
        self.hooks = hooks
        self.spans: Dict[str, List[List[float]]] = {}
        self.calls: Dict[str, List[dict]] = {}
        self._lock = threading.Lock()
        self._undo = []

    def _span(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.spans.setdefault(name, []).append([t0, t1])

    def _replace(self, target: str, make) -> None:
        mod_name, attr = target.split(":")
        orig = getattr(importlib.import_module(mod_name), attr)
        new = make(orig)
        for m in list(sys.modules.values()):
            if not getattr(m, "__name__", "").startswith(PACKAGE):
                continue
            for k, v in list(vars(m).items()):
                if v is orig:
                    setattr(m, k, new)
                    self._undo.append((m, k, orig))

    def _timed(self, name: str):
        def make(fn):
            @functools.wraps(fn)
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self._span(name, t0, time.perf_counter())
            return wrapper
        return make

    def _recorded(self, name: str):
        def make(fn):
            @functools.wraps(fn)
            def wrapper(*a, **k):
                rec = {"args": [describe(v) for v in a],
                       "kwargs": {n: describe(v) for n, v in k.items()}}
                with self._lock:
                    self.calls.setdefault(name, []).append(rec)
                return fn(*a, **k)
            return wrapper
        return make

    def _open_in(self, name: str, modules: List[str]) -> None:
        hooks = self

        class Timed:
            def __init__(self, f):
                self.f = f

            def __enter__(self):
                self.t0 = time.perf_counter()
                return self.f.__enter__()

            def __exit__(self, *exc):
                try:
                    return self.f.__exit__(*exc)
                finally:
                    hooks._span(name, self.t0, time.perf_counter())

        def timed_open(file, mode="r", *a, **k):
            f = builtins.open(file, mode, *a, **k)
            return Timed(f) if any(c in mode for c in "wa") else f

        for mod_name in modules:
            m = importlib.import_module(mod_name)
            prev = vars(m).get("open", None)
            m.open = timed_open
            self._undo.append((m, "open", prev))

    def install(self) -> "Hooks":
        from peleanalysis_tpu_torch import cli
        for h in self.hooks:
            if "open_in" in h:
                self._open_in(h["span"], h["open_in"])
            elif "span" in h:
                self._replace(h["target"], self._timed(h["span"]))
            else:
                self._replace(h["target"], self._recorded(h["calls"]))
        real_main = cli.main

        def main(argv=None, session=None):
            if session is None or not argv or argv[0] == "pipeline":
                return real_main(argv, session=session)
            t0 = time.perf_counter()
            try:
                return real_main(argv, session=session)
            finally:
                self._span("stage." + argv[0], t0, time.perf_counter())
        cli.main = main
        self._undo.append((cli, "main", real_main))
        return self

    def uninstall(self) -> None:
        for m, k, v in reversed(self._undo):
            if v is None:
                delattr(m, k)
            else:
                setattr(m, k, v)
        self._undo = []

    def record(self) -> dict:
        return {"spans": self.spans, "calls": self.calls}


def import_tools(tools: List[str]) -> None:
    """Import the program's modules of these tools, so hooks find every
    module that holds a hooked function."""
    from peleanalysis_tpu_torch import cli
    for t in tools:
        if t in cli.TOOLS:
            importlib.import_module(cli.TOOLS[t], PACKAGE)
