"""The program's own spans and counters.

``span(name)`` times a block of one layer's work.  While telemetry is
started (``start()`` ... ``stop()``) each span is kept in memory as
``{name, start, end, id, parent, request, thread}``: the times on
``time.perf_counter``'s clock, ``parent`` the id of the span open around
it (0: none), ``request`` the id of the serve request or ``pipeline`` call
it belongs to (``request()``; 0: none).  While a ``torch.profiler``
session is active, a span is also a ``record_function`` range of the same
name, so it shows in a profiler trace (``PELE_PROFILE``, the benchmark's
device trace).  With telemetry stopped and no profiler active, ``span``
reads two flags and returns one shared null context.

``count(name, n)`` adds to a process-wide counter, always on, from any
thread (the kernel wrappers count their launches: ``kernel.<name>``).
``counter(name)`` reads one, ``counters()`` all.

The parent span and the request pass to another thread with the work
submitted to it: the prefetch worker and the session's write-back thread
run each task under ``contextvars.copy_context()`` taken at submission.

``start()`` clears the span buffer and snapshots the counters; ``stop()``
returns ``{"spans": [...], "counters": {name: increase}, "dropped": n}``,
``dropped`` the spans past the buffer's ``LIMIT``, counted and not kept.

Spans (layer: name):

* entry and dispatch: ``tool.<tool>`` (``cli.main``), ``pipeline``,
  ``serve.request`` and its ``serve.settle`` (the ``sync`` flush);
* read: ``read.plotfile`` (``amr/hierarchy.load_plotfile_fabs``);
* dense assembly and ghost fill: ``assemble.host``, ``assemble.h2d``
  (``amr/dense.py``), ``fill.dense`` (``ops/dense_fill.py``);
* analysis ops: ``stats.accumulate`` (conditionalMean, jpdf);
* marching cubes: ``isosurface.<stage>`` (``geom/marching_cubes.py``);
* device to host and write: ``write.mef``, ``write.text``,
  ``write.plotfile``, ``writeback.wait`` (``io/fab_pack.py``'s event
  wait), ``session.flush``.

Counters: ``serve.requests``; ``read.bytes``, ``read.plotfiles``;
``session.host_hit``, ``session.host_miss``, ``session.dense_hit``,
``session.dense_build``; ``h2d.bytes``, ``d2h.bytes``; ``kernel.grad_mag``,
``kernel.binned``, ``kernel.joint``, ``kernel.march``,
``kernel.order_key``.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from typing import Dict

import torch
import torch.autograd.profiler as _profiler

LIMIT = 1 << 20

_lock = threading.Lock()
_on = False
_gen = 0
_spans: list = []
_dropped = 0
_counts: Dict[str, int] = {}
_base: Dict[str, int] = {}
_ids = itertools.count(1)
_request_ids = itertools.count(1)
_parent = contextvars.ContextVar("pele_span", default=0)
_request = contextvars.ContextVar("pele_request", default=0)
_NULL = contextlib.nullcontext()


class _Span:
    """One kept span; a ``record_function`` range too under a profiler."""

    __slots__ = ("name", "gen", "id", "parent", "token", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.gen = _gen
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.id = next(_ids)
        self.parent = _parent.get()
        self.token = _parent.set(self.id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _parent.reset(self.token)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = (self.name, self.t0, t1, self.id, self.parent, _request.get(),
               threading.current_thread().name)
        global _dropped
        with _lock:
            # a span still open when telemetry stopped is not kept
            if _on and self.gen == _gen:
                if len(_spans) < LIMIT:
                    _spans.append(rec)
                else:
                    _dropped += 1
        return False


def span(name: str):
    """A context manager timing one block (module docstring)."""
    if _on:
        return _Span(name)
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


@contextlib.contextmanager
def request():
    """The spans inside (on any thread the work is handed to) carry one
    new request id."""
    token = _request.set(next(_request_ids))
    try:
        yield
    finally:
        _request.reset(token)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def counter(name: str) -> int:
    with _lock:
        return _counts.get(name, 0)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def start() -> None:
    """Keep spans from now on, in a cleared buffer, and count the counters'
    increases from here."""
    global _on, _gen, _spans, _dropped, _base
    with _lock:
        _gen += 1
        _spans, _dropped, _base = [], 0, dict(_counts)
        _on = True


def stop() -> dict:
    """Stop keeping spans: the spans kept since ``start()``, the counters'
    increases and the spans dropped past ``LIMIT``."""
    global _on, _spans
    with _lock:
        _on = False
        spans, _spans = _spans, []
        counts = {k: v - _base.get(k, 0) for k, v in _counts.items()
                  if v != _base.get(k, 0)}
        dropped = _dropped
    keys = ("name", "start", "end", "id", "parent", "request", "thread")
    return {"spans": [dict(zip(keys, s)) for s in spans],
            "counters": counts, "dropped": dropped}
