"""The program's own spans and counters (``peleanalysis_tpu_torch.telemetry``)
over a traced window, and the arithmetic of the metrics that read them.

A metric that reads them lists ``WINDOW`` in its ``HOOKS``: an ``open_in``
hook naming this module.  The hooks (``hooks.py``) are installed at the
traced window's start and removed at its end, in the harness process for
a series cell and in the server for an explore cell, and never in an
untimed run.  Installing the hook sets ``open`` on this module, which
starts the program's telemetry; removing it deletes ``open`` again, which
stops telemetry and files the result in the hook record that the run
returns (``rec["hooks"]``):

* ``calls["program"]``: ``[telemetry.stop()]``, the spans (``name, start,
  end, id, parent, request, thread``, ``time.perf_counter`` seconds, the
  device trace's clock), the counters' increases and ``dropped``;
* ``spans[<name>]``: each of the program's spans as ``[start, end]``,
  beside the hooks' own, so the breakdown of idle time
  (``devtrace.idle_gaps``) labels idle stretches with them too.  The
  ``isosurface.<stage>`` spans are left out there: the device trace's
  ranges already carry them.

A metric reads the record with ``telemetry(rec)``, which is None where the
program has no telemetry module (an older checkout): its ``read`` then
returns None.
"""
from __future__ import annotations

import importlib
import sys
import types
from typing import Callable, Dict, List, Optional

from .devtrace import union

WINDOW = {"span": "program.window", "open_in": ["portbench.program"]}
HOOKS = [WINDOW]

_live: dict = {}


def _hooks_of(timed_open):
    """The hook set that made ``timed_open`` (``Hooks._open_in``): the
    object holding the record's ``spans`` and ``calls`` among what its
    closures reach."""
    todo, seen = [timed_open], set()
    while todo:
        f = todo.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        if isinstance(f, type):
            todo.extend(v for v in vars(f).values() if callable(v))
            continue
        for cell in getattr(f, "__closure__", None) or ():
            v = cell.cell_contents
            if isinstance(getattr(v, "spans", None), dict) and \
                    isinstance(getattr(v, "calls", None), dict):
                return v
            if callable(v):
                todo.append(v)
    return None


def _start(timed_open) -> None:
    if _live:
        return                  # another metric's copy of the same hook
    try:
        tel = importlib.import_module("peleanalysis_tpu_torch.telemetry")
    except ImportError:
        return
    hooks = _hooks_of(timed_open)
    if hooks is None:
        return
    _live.update(tel=tel, hooks=hooks)
    tel.start()


def _stop() -> None:
    if not _live:
        return
    tel, hooks = _live.pop("tel"), _live.pop("hooks")
    got = tel.stop()
    hooks.calls["program"] = [got]
    for s in got["spans"]:
        if not s["name"].startswith("isosurface."):
            hooks.spans.setdefault(s["name"], []).append(
                [s["start"], s["end"]])


class _Window(types.ModuleType):
    """This module: setting ``open`` opens the window, deleting it closes
    it (the hooks' install and uninstall)."""

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name == "open" and value is not None:
            _start(value)

    def __delattr__(self, name):
        super().__delattr__(name)
        if name == "open":
            _stop()


sys.modules[__name__].__class__ = _Window


# -- reading the record ----------------------------------------------------

def telemetry(rec: dict) -> Optional[dict]:
    got = (rec.get("hooks") or {}).get("calls", {}).get("program")
    return got[0] if got else None


def spans(tel: dict, keep: Callable[[str], bool]) -> List[dict]:
    return [s for s in tel["spans"] if keep(s["name"])]


def measure(intervals) -> float:
    """Seconds covered by the union of ``(start, end)`` intervals."""
    return sum(t - s for s, t in union(list(intervals), float("-inf"),
                                       float("inf")))


def union_s(tel: dict, keep: Callable[[str], bool]) -> float:
    return measure((s["start"], s["end"]) for s in spans(tel, keep))


def self_s(tel: dict, keep: Callable[[str], bool]) -> float:
    """Self time of the kept spans: the union of their intervals less the
    part of it that the union of their descendants (on any thread)
    covers."""
    parent = {s["id"]: s["parent"] for s in tel["spans"]}
    roots = {s["id"] for s in spans(tel, keep)}
    memo: Dict[int, bool] = {}

    def under(i: int) -> bool:
        """Whether span ``i`` descends from a kept span."""
        path = []
        p = parent.get(i, 0)
        while p and p not in memo and p not in roots:
            path.append(p)
            p = parent.get(p, 0)
        hit = p in roots or memo.get(p, False)
        for q in path:
            memo[q] = hit
        return hit

    own = [(s["start"], s["end"]) for s in tel["spans"] if s["id"] in roots]
    kids = [(s["start"], s["end"]) for s in tel["spans"]
            if s["id"] not in roots and under(s["id"])]
    a, b = measure(own), measure(kids)
    both = measure(own + kids)
    return a - (a + b - both)
