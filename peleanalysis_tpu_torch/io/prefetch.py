"""Read-ahead plotfile iteration for the series tools.

Counterpart of ``peleanalysis_tpu/io/prefetch.py``.  The reference's
series tools walk their plotfile list strictly serially: read file i,
compute, write, read file i+1.  :func:`iter_states` reads file i+1 on one
background thread while the caller computes on file i.

What overlaps with what on the H100: the worker produces the HOST FABs
(``session.load_state(..., cache=False)``: the native VisMF loader, a
``ctypes`` call that releases the GIL, and its host numpy); the caller
builds the ``DenseAmrState`` on the main thread (host assembly and the
copy to the card), so every CUDA call stays on the main thread.  The read
of file i+1 overlaps file i's assembly, copy, device compute and writes;
the steady-state time a file becomes ``max(read, the rest)`` instead of
their sum.

Exactly ``depth`` loads are in flight beyond the file the consumer holds
(depth 1: peak host residency two files).  Series members are never
INSERTED into a session's cache, but a registered output or an entry
already cached still serves its path.
"""
from __future__ import annotations

import contextvars
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence, Tuple

from ..session import LoadedPlotfile, load_state


def iter_states(args: dict, paths: Sequence[str], names=None,
                max_level=None, is_periodic=None, dtype=None, device=None,
                depth: int = 1) -> Iterator[Tuple[str, LoadedPlotfile]]:
    """Yield ``(path, LoadedPlotfile)`` over ``paths`` with ``depth``-file
    read-ahead on one background thread (depth<=0 or a single path: the
    plain serial loop).  ``names`` may be a callable ``path -> comp
    names`` (resolved on the worker).  ``dtype`` and ``device`` are the
    consumer's (session.load_state).  A worker's exception surfaces at the
    yield of the file that failed, in order; a consumer that stops early
    cancels the loads not yet started.  A load runs in the context of its
    submission (``telemetry``'s parent span and request)."""
    def load(p):
        n = names(p) if callable(names) else names
        return load_state(args, p, names=n, max_level=max_level,
                          is_periodic=is_periodic, dtype=dtype,
                          device=device, cache=False)

    paths = list(paths)
    if depth <= 0 or len(paths) <= 1:
        for p in paths:
            yield p, load(p)
        return
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="pele-prefetch")
    try:
        pending = deque()
        nxt = 0
        while nxt < len(paths) and len(pending) < depth:
            pending.append((paths[nxt], ex.submit(
                contextvars.copy_context().run, load, paths[nxt])))
            nxt += 1
        while pending:
            p, fut = pending.popleft()
            st = fut.result()          # a worker's failure, in order
            if nxt < len(paths):
                pending.append((paths[nxt], ex.submit(
                    contextvars.copy_context().run, load, paths[nxt])))
                nxt += 1
            yield p, st
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def query_prefetch(pp) -> int:
    """The series tools' ``prefetch=N``: files of read-ahead (default 1;
    0 keeps the serial loop)."""
    return pp.query_int("prefetch", 1)
