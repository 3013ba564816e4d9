"""Pipeline session of the PyTorch port: one :class:`Session` threaded
through chained tool mains.

Counterpart of ``peleanalysis_tpu/session.py``.  The reference chains its
tools through files: each main() re-reads the plotfile and writes its whole
output to disk.  The ``pipeline`` and ``serve`` verbs (cli.py, server.py)
thread one Session through the tool mains instead:

  * plotfile loads are cached per (path, max_level, is_periodic), with the
    Header's mtime beside the entry so that a rewrite evicts it, and
    extended IN PLACE when a later stage needs more components (appended,
    so comp indices already handed out stay valid).  The port
    loads host FABs first and builds a ``DenseAmrState`` on a device in a
    dtype from them, so the session caches both: the host
    ``(meta, names, fabs)`` under the path key and each dense state under
    (entry, device, dtype).  Entries of one file that differ only in
    periodicity share the host FABs and the device tensors (periodicity is
    metadata), so grad (periodic by default) and curvature (float32) share
    one read with isosurface and stream (float64), and each dtype is
    assembled and copied to the card once;
  * tool outputs (plotfiles, MEF surfaces, streamline sets) are registered
    under their output names; a later stage asking for that name gets the
    in-memory object instead of reading the file back, when its device,
    dtype (or, for copy-only consumers, a wider one), periodicity, levels
    and comps match;
  * per-stage ``write=0`` skips the disk artifact entirely;
  * ``async_writes=True`` (pipeline, server) writes plotfiles and text on
    ONE background thread while the next stage computes: the device packs
    and starts the copy into pinned memory, the thread waits on the copy's
    CUDA event and writes.  The thread never launches a kernel or
    allocates on the card.

Shared states are never written in place: the tools build new tensors
from a state's ``data`` (the session's byte-equality tests run each chain
stage twice in one session).

Python API::

    from peleanalysis_tpu_torch.session import Session
    s = Session()
    s.run("grad", infile="plt", gradVar="temp", outfile="g", device="cpu")
    s.run("isosurface", infile="plt", isoCompName="temp", isoVal=1000,
          outfile_base="iso", write=0, device="cpu")
    s.run("stream", plotfile="plt", isoFile="iso.mef", outFile="lines.dat",
          device="cpu")
"""
from __future__ import annotations

import contextvars
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config
from .amr.dense import DenseAmrState, _level_metas, assemble_level
from .amr.hierarchy import load_plotfile_fabs
from .telemetry import count, span


def _host_key(path: str, max_level, is_periodic) -> Tuple:
    per = (tuple(bool(p) for p in is_periodic) if is_periodic is not None
           else None)
    return (path, max_level, per)


def _dev_key(device) -> Tuple[str, int]:
    d = torch.device(device)
    return (d.type, d.index or 0)


def _with_periodicity(meta, is_periodic):
    """``meta`` with the periodicity ``load_plotfile_fabs`` gives a load
    of ``is_periodic`` (None: none; a DIM=2 file keeps z non-periodic)."""
    if meta.ndim2:
        per = ((False,) * 3 if is_periodic is None else
               tuple(bool(p) for p in is_periodic[:2]) + (False,))
    else:
        per = ((False,) * meta.ndim if is_periodic is None else
               tuple(bool(p) for p in is_periodic))
    return dataclasses.replace(meta, geoms=[
        dataclasses.replace(g, is_periodic=per) for g in meta.geoms])


def _header_mtime(path: str):
    """Header mtime, stored NEXT TO the cached entry (not in the key) so a
    rewrite of the plotfile EVICTS the superseded entry."""
    try:
        return os.path.getmtime(os.path.join(path, "Header"))
    except OSError:
        return None


class LoadedPlotfile:
    """A plotfile as a tool loads it: ``meta``, ``names`` and ``fabs``
    (``fabs[lev][i]``: box i's ``[ncomp, *box.shape]`` host array), the
    output of ``amr/hierarchy.load_plotfile_fabs``.  A registered
    in-session output wraps its ``DenseAmrState`` (``state``) instead; its
    ``fabs`` are copied from the state on first use (the sparse paths need
    them), in the state's dtype."""

    def __init__(self, meta, names, fabs=None,
                 state: Optional[DenseAmrState] = None):
        self.meta = meta
        self.names = names
        self._fabs = fabs
        self.state = state

    @classmethod
    def of_state(cls, state: DenseAmrState) -> "LoadedPlotfile":
        return cls(state.meta, state.names, state=state)

    @property
    def fabs(self):
        if self._fabs is None:
            self._fabs = self.state.level_fabs()
        return self._fabs


class Session:
    """Shared state across chained tool invocations (module docstring).
    Ordering of the write-back: one worker thread, so writes complete in
    submission order; any consumer that might READ a pending path from
    disk must ``flush_writes(match=argv)`` first (the pipeline driver and
    the server do, and ``load`` settles the path it opens).  The Python-API
    default stays synchronous."""

    def __init__(self, async_writes: bool = False) -> None:
        # key -> (Header mtime, LoadedPlotfile)
        self._states: Dict[Tuple, Tuple] = {}
        # (id(entry), device, dtype) -> DenseAmrState
        self._dense: Dict[Tuple, DenseAmrState] = {}
        # every entry keyed by id() is retained, so a recycled id never
        # serves another entry's dense state
        self._retain: Dict[int, LoadedPlotfile] = {}
        self.plotfiles: Dict[str, LoadedPlotfile] = {}  # output name -> state
        self.surfaces: Dict[str, object] = {}           # output name -> MEF
        self.lines: Dict[str, tuple] = {}   # name -> (names, lines, elements
        #                                     thunk, meta)
        self.async_writes = bool(async_writes)
        self._wb_pool = None
        self._wb: List[Tuple[str, object]] = []         # (path, Future)
        self._var_names: Dict[Tuple, List[str]] = {}    # (path, mtime) -> vars
        # guards the dicts against the prefetch worker (io/prefetch.py runs
        # load concurrently); file reads stay outside the lock
        self._cache_lock = threading.RLock()

    # -- write-back ------------------------------------------------------------

    def submit_write(self, path: str, thunk) -> None:
        """Queue a host-side write on the single write-back thread (any
        device-to-host copy already started by the caller)."""
        # a rewrite of the same path must not race its predecessor
        self.flush_writes(match=[path])
        with self._cache_lock:
            if self._wb_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._wb_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="pele-writeback")
            # the write runs in the context of its submission
            # (telemetry's parent span and request)
            self._wb.append((path, self._wb_pool.submit(
                contextvars.copy_context().run, thunk)))

    def flush_writes(self, match: Optional[Sequence[str]] = None) -> None:
        """Wait for pending writes and re-raise the first failure.
        match: only the writes whose output path is named by one of the
        strings (e.g. the next stage's argv); None = all.  A path matches
        by normalised path equality over the strings' path-like tokens
        ('./out', 'out' and an absolute spelling settle the same write),
        or as a raw substring: over-flushing is safe, a missed flush reads
        a half-written file."""
        toks = None
        if match is not None:
            toks = {os.path.abspath(t) for m in match
                    for t in str(m).replace("=", " ").split()}

        def hits(p):
            return (match is None or os.path.abspath(p) in toks
                    or any(p in str(m) for m in match))

        with self._cache_lock:
            take = [(p, f) for p, f in self._wb if hits(p)]
            self._wb = [(p, f) for p, f in self._wb if not hits(p)]
        if not take:
            return
        err = None
        with span("session.flush"):
            for _, fut in take:
                try:
                    fut.result()
                except Exception as e:         # surface at the flush point
                    err = err or e
        if err is not None:
            raise err

    # -- loading -----------------------------------------------------------------

    def load(self, path: str, names: Optional[Sequence[str]] = None,
             max_level=None, is_periodic=None, dtype=None, device=None,
             cache: bool = True, widen_ok: bool = False) -> LoadedPlotfile:
        """Cached ``load_plotfile_fabs``; extends the comp set in place.

        A registered output of ``path`` shadows the file when the request
        matches what the producer built: its device (``device`` None
        accepts any), its dtype exactly (``dtype`` None = the compute
        dtype; ``widen_ok`` also accepts a narrower state: for copy-only
        consumers it equals reading the wider file), its periodicity and
        levels, and the comps asked for.  A mismatch falls back to the file
        on disk, or raises when the producer ran with write=0.

        cache=False reuses an existing entry or output but never INSERTS
        one (series loops, io/prefetch.py) and never extends one: comps an
        entry lacks are read into a fresh, uncached load.

        Counts ``session.host_hit`` when nothing is read, else
        ``session.host_miss``."""
        src = self.plotfiles.get(path)
        if src is not None:
            st = src.state
            per_ok = (is_periodic is None
                      or tuple(bool(p) for p in is_periodic)
                      == tuple(bool(p) for p in
                               st.meta.geoms[0].is_periodic))
            lev_ok = max_level is None or max_level >= st.meta.n_levels - 1
            want = dtype or config.compute_dtype
            dt_ok = (want == st.dtype
                     or (widen_ok and want.itemsize >= st.dtype.itemsize))
            dev_ok = device is None or _dev_key(device) == _dev_key(
                st.device)
            comp_ok = names is None or all(n in st.names for n in names)
            if per_ok and lev_ok and dt_ok and dev_ok and comp_ok:
                count("session.host_hit")
                return src
            if not os.path.isdir(path):
                missing = ([] if comp_ok else
                           [n for n in names if n not in st.names])
                raise ValueError(
                    f"pipeline stage needs '{path}' with "
                    + (f"comps {missing}" if missing else
                       "different load options (periodicity/levels/dtype/"
                       "device)")
                    + ", but the registered in-session output doesn't "
                    "match and the stage that produced it ran with "
                    "write=0 (no file on disk). Re-run the producer "
                    "with write=1 or align the options.")
            # fall through: read the on-disk file
        # settle a pending write-back of THIS path before reading it
        self.flush_writes(match=[path])
        key = _host_key(path, max_level, is_periodic)
        mtime = _header_mtime(path)
        with self._cache_lock:
            ent = self._states.get(key)
            if ent is not None and ent[0] != mtime:
                self._evict(ent[1])          # superseded by a rewrite
                del self._states[key]
                ent = None
            src = ent[1] if ent is not None else None
            if src is None:
                # another periodicity of the same read: share its FABs
                sib = next((e for k, (mt, e) in self._states.items()
                            if k[:2] == key[:2] and mt == mtime), None)
                if sib is not None:
                    src = LoadedPlotfile(
                        _with_periodicity(sib.meta, is_periodic), sib.names,
                        sib.fabs)
                    if cache:
                        self._states[key] = (mtime, src)
        if src is None:
            count("session.host_miss")
            src = LoadedPlotfile(*load_plotfile_fabs(path, names, max_level,
                                                     is_periodic))
            if cache:
                with self._cache_lock:
                    self._states[key] = (mtime, src)
            return src
        if names is None:
            with self._cache_lock:
                vn = self._var_names.get((path, mtime))
            if vn is None:
                from .io.plotfile import PlotfileReader
                vn = list(PlotfileReader(path).var_names)
                with self._cache_lock:
                    self._var_names[(path, mtime)] = vn
            missing = [n for n in vn if n not in src.names]
        else:
            missing = [n for n in names if n not in src.names]
        if not missing:
            count("session.host_hit")
            return src
        count("session.host_miss")
        if not cache:
            return LoadedPlotfile(*load_plotfile_fabs(
                path, names, max_level, is_periodic))
        self._extend(src, path, missing, max_level, is_periodic)
        return src

    def _evict(self, src: LoadedPlotfile) -> None:
        """Drop an entry's dense states (its _states entry is the caller's
        to remove) so their device memory can be freed."""
        with self._cache_lock:
            for k in [k for k in self._dense if k[0] == id(src)]:
                del self._dense[k]
            self._retain.pop(id(src), None)

    def _siblings(self, src: LoadedPlotfile) -> List[LoadedPlotfile]:
        """The cached entries sharing ``src``'s host FABs (``src`` too)."""
        with self._cache_lock:
            return [src] + [e for _, e in self._states.values()
                            if e is not src and src._fabs is not None
                            and e._fabs is src._fabs]

    def _owns(self, src: LoadedPlotfile) -> bool:
        with self._cache_lock:
            return (any(ent[1] is src for ent in self._states.values())
                    or any(v is src for v in self.plotfiles.values()))

    def _extend(self, src: LoadedPlotfile, path: str,
                missing: Sequence[str], max_level, is_periodic) -> None:
        """Read only the missing comps and append them in place to the
        host FABs (shared with the entry's siblings); each dense state
        gains them when next asked for (``dense``)."""
        meta, _, extra = load_plotfile_fabs(path, list(missing), max_level,
                                            is_periodic)
        for lev in range(meta.n_levels):
            fabs = src.fabs[lev]
            for i, fab in enumerate(extra[lev]):
                fabs[i] = np.concatenate([fabs[i], fab], axis=0)
        src.names.extend(missing)

    def dense(self, src: LoadedPlotfile, device,
              dtype: torch.dtype) -> DenseAmrState:
        """The entry's ``DenseAmrState`` on ``device`` in ``dtype``, built
        once per (entry, device, dtype) and brought up to the comps the
        entry has gained since (appended, so comp indices stay valid).  A
        sibling entry's state lends its tensors; a registered output on
        the same device is itself, or a widened copy for a wider dtype.
        Counts ``session.dense_build`` when it assembles host FABs, else
        ``session.dense_hit``."""
        key = (id(src), _dev_key(device), dtype)
        st = src.state
        built = False
        with self._cache_lock:
            ds = self._dense.get(key)
            sib = next((self._dense[(id(e), key[1], dtype)]
                        for e in self._siblings(src)[1:]
                        if (id(e), key[1], dtype) in self._dense), None)
        if ds is None:
            if st is not None and _dev_key(st.device) == _dev_key(device):
                ds = st if st.dtype == dtype else st.with_data(
                    st.names, [d.to(dtype) for d in st.data])
            elif sib is not None:
                # the same tensors under this entry's periodicity
                ds = DenseAmrState(src.meta, sib.names, list(sib.data),
                                   _level_metas(src.meta), device)
            else:
                ds = DenseAmrState.from_level_fabs(src.meta, src.names,
                                                   src.fabs, device, dtype)
                built = True
            # only session-owned entries pin their dense states: a
            # streamed series member (load cache=False) must not stay
            # resident
            if self._owns(src):
                with self._cache_lock:
                    self._dense[key] = ds
                    self._retain[id(src)] = src
        n = len(ds.names)
        if st is None and n < len(src.names):
            for lev in range(src.meta.n_levels):
                ds.data[lev] = torch.cat([ds.data[lev], assemble_level(
                    src.meta.bas[lev], [f[n:] for f in src.fabs[lev]],
                    ds.lmeta[lev].bbox, dtype, ds.device)])
            ds.names.extend(src.names[n:])
            built = True
        count("session.dense_build" if built else "session.dense_hit")
        return ds

    # -- output registry ------------------------------------------------------------

    def put_plotfile(self, name: str, state: DenseAmrState) -> None:
        self.plotfiles[name] = LoadedPlotfile.of_state(state)

    def put_surface(self, name: str, mef) -> None:
        self.surfaces[name] = mef

    def get_surface(self, name: str):
        return self.surfaces.get(name)

    def put_lines(self, name: str, names, lines, get_elts, meta) -> None:
        """A stream stage's output: (var names, [nline, station, 3+nf]
        lines, connectivity thunk, AmrMeta); the StreamData consumers
        (read_stream) resolve it without a disk round trip."""
        self.lines[name] = (names, lines, get_elts, meta)

    # -- driver -----------------------------------------------------------------

    def reset(self) -> None:
        """Settle every pending write, then drop every cached state and
        registered output (frees their device memory)."""
        self.flush_writes()
        with self._cache_lock:
            self._states.clear()
            self._dense.clear()
            self._retain.clear()
            self.plotfiles.clear()
            self.surfaces.clear()
            self.lines.clear()
            self._var_names.clear()

    def run(self, tool: str, **kw) -> None:
        """Run one tool with this session attached (Python-API pipeline)."""
        from .cli import main as cli_main
        argv = [tool]
        for k, v in kw.items():
            if isinstance(v, (list, tuple)):
                argv.append(f"{k}=" + " ".join(str(x) for x in v))
            else:
                argv.append(f"{k}={v}")
        self.flush_writes(match=argv)
        rc = cli_main(argv, session=self)
        if rc != 0:
            raise RuntimeError(f"pipeline stage '{tool}' failed (rc={rc})")


# -- tool-side helpers: with no session each does what the tool did alone ----

def get_session(args: dict) -> Optional[Session]:
    s = args.get("_session")
    return s if isinstance(s, Session) else None


def load_state(args: dict, path: str, names=None, max_level=None,
               is_periodic=None, dtype=None, device=None, cache: bool = True,
               widen_ok: bool = False) -> LoadedPlotfile:
    """Session-aware ``load_plotfile_fabs`` (the arguments: Session.load;
    ``dtype`` and ``device`` are the consumer's, checked against a
    registered output)."""
    s = get_session(args)
    if s is not None:
        return s.load(path, names=names, max_level=max_level,
                      is_periodic=is_periodic, dtype=dtype, device=device,
                      cache=cache, widen_ok=widen_ok)
    return LoadedPlotfile(*load_plotfile_fabs(path, names, max_level,
                                              is_periodic))


def dense_state(args: dict, src: LoadedPlotfile, device,
                dtype: torch.dtype) -> DenseAmrState:
    """Session-aware ``DenseAmrState.from_level_fabs``."""
    s = get_session(args)
    if s is not None:
        return s.dense(src, device, dtype)
    return DenseAmrState.from_level_fabs(src.meta, src.names, src.fabs,
                                         device, dtype)


def select(ds: DenseAmrState, names: Sequence[str]) -> DenseAmrState:
    """``ds`` with exactly ``names``, in that order: ``ds`` itself when it
    holds just those, else a state of copies of those comps (a session's
    cached state may hold more, in another order)."""
    names = list(names)
    if ds.names == names:
        return ds
    idx = [ds.comp(n) for n in names]
    return ds.with_data(names, [d[idx] for d in ds.data])


def var_names(args: dict, path: str) -> List[str]:
    """The variables of ``path``: a registered output's, else the file's
    (in file order, whatever a cached entry holds)."""
    s = get_session(args)
    if s is not None and path in s.plotfiles:
        return list(s.plotfiles[path].names)
    from .io.plotfile import PlotfileReader
    return list(PlotfileReader(path).var_names)


def load_dense(args: dict, path: str, device, dtype: torch.dtype,
               names=None, max_level=None, is_periodic=None,
               widen_ok: bool = False) -> DenseAmrState:
    """Session-aware ``DenseAmrState.from_plotfile``: the state of exactly
    ``names`` (every variable, in the file's order, when None)."""
    src = load_state(args, path, names=names, max_level=max_level,
                     is_periodic=is_periodic, dtype=dtype, device=device,
                     widen_ok=widen_ok)
    return select(dense_state(args, src, device, dtype),
                  names if names is not None else var_names(args, path))


def read_stream(args: dict, path: str):
    """Session-aware StreamData read: a registered stream stage resolves by
    output name; otherwise the folder on disk is read."""
    from .io.stream_data import (StreamData, compute_inside_nodes,
                                 read_stream_data)
    s = get_session(args)
    if s is not None and path in s.lines:
        names, lines, get_elts, meta = s.lines[path]
        inside = compute_inside_nodes(meta, lines[:, lines.shape[1] // 2, :3])
        return StreamData(list(names), np.asarray(get_elts(), np.int32),
                          inside, lines)
    return read_stream_data(path)


def stage_writes(args: dict) -> bool:
    """Per-stage write=0 skips disk artifacts (in a session only: outside
    one the key is not read, so a single-tool run always writes and warns
    of the unused key)."""
    s = get_session(args)
    if s is None:
        return True
    from .parmparse import ParmParse
    return ParmParse(args).query_int("write", 1) == 1


def stage_submit_io(args: dict, path: str, thunk) -> None:
    """Run a pure-host artifact write now, or queue it on the session's
    write-back thread (async_writes).  The thunk only READS its captured
    data (later in-session consumers share the arrays)."""
    s = get_session(args)
    if s is not None and s.async_writes:
        s.submit_write(path, thunk)
    else:
        thunk()


def stage_write_plotfile(args: dict, out: DenseAmrState, path: str) -> bool:
    """Write a tool's output plotfile honouring write= and the session's
    write-back.  Returns whether a write was issued (now, or queued and
    settled by a later flush)."""
    if not stage_writes(args):
        return False
    s = get_session(args)
    if s is not None and s.async_writes:
        out.to_plotfile_async(path, lambda th: s.submit_write(path, th))
    else:
        out.to_plotfile(path)
    return True
