"""AMReX plotfile reader/writer (numpy, host side).

Replaces the reference's AmrData / PlotFileData / VisMF stack
(PeleAnalysis Src/grad.cpp:64-71, Src/isosurface.cpp:1307; format per
Docs/source/data.rst "Plotfiles" and the AMReX IO docs).  The reader is
demand-paged at (level, component, box) granularity like ``AmrData::FillVar``
so huge plotfiles need not be resident; a level's boxes are read by the
native parallel loader.  The writer emits the standard ``HyperCLaw-V1.1``
layout readable by amrvis / yt / the reference tools, from per-box numpy
arrays (``write_plotfile``) or from FAB records already packed in file
order with their min/max tables (``write_plotfile_records``, the device
writer's tail, ``amr/dense.py``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..amr.box import Box, BoxArray, parse_box
from ..amr.geometry import Geometry
from .fab import fab_header_str, read_fab_header, write_fab
from ..telemetry import span

_PLT_VERSION = "HyperCLaw-V1.1"


@dataclasses.dataclass
class PlotfileMeta:
    var_names: List[str]
    ndim: int
    time: float
    finest_level: int
    prob_lo: Tuple[float, ...]
    prob_hi: Tuple[float, ...]
    ref_ratio: List[int]                  # len = finest_level (ratio lev->lev+1)
    prob_domain: List[Box]                # per level
    level_steps: List[int]
    dx: List[Tuple[float, ...]]           # per level
    coord_sys: int = 0

    @property
    def n_levels(self) -> int:
        return self.finest_level + 1

    @property
    def ncomp(self) -> int:
        return len(self.var_names)

    def geometry(self, lev: int, is_periodic: Optional[Sequence[bool]] = None) -> Geometry:
        per = tuple(is_periodic) if is_periodic is not None else (False,) * self.ndim
        return Geometry(self.prob_domain[lev], self.prob_lo, self.prob_hi, per,
                        self.coord_sys)


class PlotfileReader:
    """Demand-paged plotfile reader.

    Parses ``Header`` and each level's ``Cell_H`` eagerly (metadata only);
    FAB payloads are read on request via :meth:`read_box` / :meth:`read_level`.
    """

    def __init__(self, path: str):
        self.path = path.rstrip("/")
        with open(os.path.join(self.path, "Header"), "r") as f:
            self.meta, self._mf_paths = _parse_header(f)
        self._level_index: List[Optional[dict]] = [None] * self.meta.n_levels

    # -- metadata helpers ---------------------------------------------------
    @property
    def var_names(self) -> List[str]:
        return self.meta.var_names

    def var_index(self, name: str) -> int:
        return self.meta.var_names.index(name)

    def box_array(self, lev: int) -> BoxArray:
        return BoxArray(self._index(lev)["boxes"])

    def _index(self, lev: int) -> dict:
        if self._level_index[lev] is None:
            mf_path = os.path.join(self.path, self._mf_paths[lev])
            self._level_index[lev] = _parse_vismf_header(mf_path + "_H")
            self._level_index[lev]["dir"] = os.path.dirname(mf_path)
        return self._level_index[lev]

    # -- data access --------------------------------------------------------
    def read_box(self, lev: int, ibox: int,
                 comps: Optional[Sequence[int]] = None) -> np.ndarray:
        """Read one box -> array [ncomp_sel, nx, ny(, nz)]."""
        idx = self._index(lev)
        box: Box = idx["boxes"][ibox]
        fname, offset = idx["fabs"][ibox]
        cells = box.size
        with open(os.path.join(idx["dir"], fname), "rb") as f:
            f.seek(offset)
            hbox, ncomp, dtype = read_fab_header(f)
            if hbox.shape != box.shape:
                raise ValueError(f"FAB/box mismatch at lev {lev} box {ibox}")
            data_start = f.tell()
            # normalize once: an iterator comps would be consumed by the
            # sizing list() and enumerate nothing
            sel = list(range(ncomp)) if comps is None else list(comps)
            out = np.empty((len(sel),) + box.shape, dtype=np.float64)
            for oi, c in enumerate(sel):
                f.seek(data_start + c * cells * dtype.itemsize)
                raw = np.fromfile(f, dtype=dtype, count=cells)
                # Fortran order per comp -> [x, y, z]
                out[oi] = raw.reshape(box.shape[::-1]).T
        return out

    def _fab_headers(self, lev: int) -> List[Tuple[Box, int, np.dtype]]:
        """Each FAB record's header (box, ncomp, dtype), in box order."""
        idx = self._index(lev)
        by_file: dict = {}
        for i, (fname, offset) in enumerate(idx["fabs"]):
            by_file.setdefault(fname, []).append((i, offset))
        heads: dict = {}
        for fname, recs in by_file.items():     # each file opened once
            with open(os.path.join(idx["dir"], fname), "rb") as f:
                for i, offset in recs:
                    f.seek(offset)
                    heads[i] = read_fab_header(f)
        return [heads[i] for i in range(len(idx["fabs"]))]

    def read_level(self, lev: int,
                   comps: Optional[Sequence[int]] = None) -> List[np.ndarray]:
        """All boxes of a level as float64 ``[ncomp_sel, nx, ny(, nz)]``
        arrays, read by the native parallel FAB loader
        (``native/vismf_io.cpp``).

        Three kinds of level take the per-box :meth:`read_box` instead:
        grown FABs (``ngrow > 0``), big-endian FABs (the loader reads
        little-endian floats), and a FAB whose header box differs in shape
        from the level's box (``read_box`` raises ``ValueError`` for it).
        A failed build or a record the loader cannot read raises."""
        idx = self._index(lev)
        boxes = idx["boxes"]
        nbox = len(boxes)
        if nbox == 0:
            return []
        heads = self._fab_headers(lev) if idx["ngrow"] == 0 else None
        if (heads is None
                or any(dt.byteorder == ">" for _, _, dt in heads)
                or any(hb.shape != b.shape for (hb, _, _), b in zip(heads,
                                                                    boxes))):
            return [self.read_box(lev, i, comps) for i in range(nbox)]
        from ..native import load_fabs
        sel = list(range(heads[0][1])) if comps is None else list(comps)
        for i, (_, ncomp, dt) in enumerate(heads):
            if any(not 0 <= c < ncomp for c in sel):
                raise ValueError(f"components {sel} out of range for the "
                                 f"{ncomp} of lev {lev} box {i}")
            if dt != heads[0][2]:
                raise ValueError(f"lev {lev} box {i}: FAB real format {dt} "
                                 f"differs from box 0's {heads[0][2]}")
        # DIM=2 boxes are padded with nz=1 for the loader's ABI
        dims = np.ones((nbox, 3), np.int32)
        for i, b in enumerate(boxes):
            dims[i, : len(b.shape)] = b.shape
        dests = [np.empty((len(sel),) + b.shape, np.float64) for b in boxes]
        load_fabs([os.path.join(idx["dir"], f) for f, _ in idx["fabs"]],
                  [off for _, off in idx["fabs"]], dims, sel,
                  heads[0][2].itemsize, dests)
        return dests

    def read_level_names(self, lev: int, names: Sequence[str]) -> List[np.ndarray]:
        return self.read_level(lev, [self.var_index(n) for n in names])


def promote_2d(meta: PlotfileMeta, bas: List[BoxArray],
               level_fabs: List[List[np.ndarray]]):
    """Promote a DIM=2 plotfile to the 3-D in-memory model with nz=1
    (the z dimension gets foextrap ghosts, so z-derivatives vanish — the
    engines stay 3-D).  Returns (geoms3, bas3, fabs3)."""
    geoms3, bas3, fabs3 = [], [], []
    for lev in range(len(bas)):
        dom = meta.prob_domain[lev]
        dom3 = Box(dom.lo + (0,), dom.hi + (0,))
        geoms3.append(Geometry(dom3, meta.prob_lo + (0.0,),
                               meta.prob_hi + (1.0,),
                               (False, False, False)))
        bas3.append(BoxArray([Box(b.lo + (0,), b.hi + (0,))
                              for b in bas[lev]]))
        fabs3.append([f[..., None] for f in level_fabs[lev]])
    return geoms3, bas3, fabs3


def _parse_header(f) -> Tuple[PlotfileMeta, List[str]]:
    version = f.readline().strip()
    if not version:
        raise ValueError("empty plotfile Header")
    ncomp = int(f.readline())
    names = [f.readline().strip() for _ in range(ncomp)]
    ndim = int(f.readline())
    time = float(f.readline())
    finest = int(f.readline())
    prob_lo = tuple(float(x) for x in f.readline().split())
    prob_hi = tuple(float(x) for x in f.readline().split())
    rr_line = f.readline().split()
    ref_ratio = [int(x) for x in rr_line] if finest > 0 else []
    dom_line = f.readline()
    domains = _parse_box_list(dom_line, finest + 1)
    level_steps = [int(x) for x in f.readline().split()] or [0] * (finest + 1)
    dx = []
    for _ in range(finest + 1):
        dx.append(tuple(float(x) for x in f.readline().split()))
    coord_sys = int(f.readline())
    _bwidth = int(f.readline())
    mf_paths: List[str] = []
    for lev in range(finest + 1):
        hdr = f.readline().split()
        nboxes = int(hdr[1])
        _steps = f.readline()
        for _ in range(nboxes * ndim):
            f.readline()  # physical extents per box per dim (redundant)
        mf_paths.append(f.readline().strip())
    meta = PlotfileMeta(names, ndim, time, finest, prob_lo, prob_hi, ref_ratio,
                        domains, level_steps, dx, coord_sys)
    return meta, mf_paths


def _parse_box_list(line: str, n: int) -> List[Box]:
    # boxes printed back to back: ((..) (..) (..)) ((..) (..) (..)) ...
    chunks = []
    depth = 0
    cur = ""
    for ch in line:
        if ch == "(":
            depth += 1
        if depth > 0:
            cur += ch
        if ch == ")":
            depth -= 1
            if depth == 0:
                chunks.append(cur)
                cur = ""
    if len(chunks) != n:
        raise ValueError(f"expected {n} domain boxes, got {len(chunks)}: {line!r}")
    return [parse_box(c) for c in chunks]


def _parse_vismf_header(path: str) -> dict:
    with open(path, "r") as f:
        _version = int(f.readline())
        _how = int(f.readline())
        ncomp = int(f.readline())
        ngrow = int(f.readline())
        ba_line = f.readline().split()
        nbox = int(ba_line[0].lstrip("("))
        boxes = [parse_box(f.readline()) for _ in range(nbox)]
        f.readline()  # ')'
        nfab = int(f.readline())
        fabs = []
        for _ in range(nfab):
            parts = f.readline().split()
            fabs.append((parts[1], int(parts[2])))
        # min/max tables follow; skip (recomputed on demand)
    return {"ncomp": ncomp, "ngrow": ngrow, "boxes": boxes, "fabs": fabs}


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def write_plotfile(
    path: str,
    var_names: Sequence[str],
    time: float,
    geoms: Sequence[Geometry],
    ref_ratio: Sequence[int],
    box_arrays: Sequence[BoxArray],
    level_data: Sequence[Sequence[np.ndarray]],  # per level, per box: [ncomp, *shape]
    level_steps: Optional[Sequence[int]] = None,
    dtype=np.float64,
    max_fabs_per_file: int = 64,
) -> None:
    """Write a standard multi-level plotfile (WriteMultiLevelPlotfile analog,
    reference: Src/grad.cpp:256)."""
    with span("write.plotfile"):
        write_plotfile_header(path, var_names, time, geoms, ref_ratio,
                              box_arrays, level_steps)
        for lev in range(len(box_arrays)):
            _write_vismf(os.path.join(path, f"Level_{lev}"), "Cell",
                         box_arrays[lev], level_data[lev], dtype,
                         max_fabs_per_file)


def write_plotfile_records(
    path: str,
    var_names: Sequence[str],
    time: float,
    geoms: Sequence[Geometry],
    ref_ratio: Sequence[int],
    box_arrays: Sequence[BoxArray],
    level_records: Sequence[Tuple[Sequence[np.ndarray], np.ndarray,
                                  np.ndarray]],
    level_steps: Optional[Sequence[int]] = None,
    dtype=np.float64,
    max_fabs_per_file: int = 64,
) -> None:
    """``write_plotfile`` from FAB payloads already in file order:
    ``level_records[lev] = (payloads, mins, maxs)``, where payloads[i] is
    box i's contiguous ``[comp, k, j, i]`` array of ``dtype`` and mins/maxs
    are ``[nbox, ncomp]`` float64 tables of those stored values.  The files
    are byte-identical to ``write_plotfile``'s for the same values."""
    with span("write.plotfile"):
        write_plotfile_header(path, var_names, time, geoms, ref_ratio,
                              box_arrays, level_steps)
        ncomp = len(var_names)
        for lev, (payloads, mins, maxs) in enumerate(level_records):
            ba = box_arrays[lev]
            dirname = os.path.join(path, f"Level_{lev}")

            def write_record(f, i, ba=ba, payloads=payloads):
                f.write(fab_header_str(ba[i], ncomp, dtype))
                f.write(payloads[i])
            entries = _write_fab_files(dirname, "Cell", len(ba),
                                       write_record, max_fabs_per_file)
            _write_vismf_h(dirname, "Cell", ba, ncomp, entries, mins, maxs)


def write_plotfile_header(path: str, var_names: Sequence[str], time: float,
                          geoms: Sequence[Geometry], ref_ratio: Sequence[int],
                          box_arrays: Sequence[BoxArray],
                          level_steps: Optional[Sequence[int]] = None) -> None:
    """The plotfile's top ``Header`` (creates ``path``)."""
    ndim = geoms[0].ndim
    n_lev = len(box_arrays)
    ncomp = len(var_names)
    if level_steps is None:
        level_steps = [0] * n_lev
    os.makedirs(path, exist_ok=True)

    with open(os.path.join(path, "Header"), "w") as f:
        f.write(_PLT_VERSION + "\n")
        f.write(f"{ncomp}\n")
        for nm in var_names:
            f.write(nm + "\n")
        f.write(f"{ndim}\n")
        f.write(f"{time:.17g}\n")
        f.write(f"{n_lev - 1}\n")
        f.write(" ".join(f"{x:.17g}" for x in geoms[0].prob_lo) + " \n")
        f.write(" ".join(f"{x:.17g}" for x in geoms[0].prob_hi) + " \n")
        f.write(" ".join(str(r) for r in ref_ratio) + " \n")
        f.write(" ".join(repr(g.domain) for g in geoms) + " \n")
        f.write(" ".join(str(s) for s in level_steps) + " \n")
        for g in geoms:
            f.write(" ".join(f"{d:.17g}" for d in g.dx) + " \n")
        f.write(f"{geoms[0].coord_sys}\n")
        f.write("0\n")
        for lev in range(n_lev):
            ba = box_arrays[lev]
            g = geoms[lev]
            dx = g.dx
            f.write(f"{lev} {len(ba)} {time:.17g}\n")
            f.write(f"{level_steps[lev]}\n")
            for b in ba:
                for d in range(ndim):
                    glo = g.prob_lo[d] + (b.lo[d] - g.domain.lo[d]) * dx[d]
                    ghi = g.prob_lo[d] + (b.hi[d] + 1 - g.domain.lo[d]) * dx[d]
                    f.write(f"{glo:.17g} {ghi:.17g}\n")
            f.write(f"Level_{lev}/Cell\n")


def _write_vismf(dirname: str, base: str, ba: BoxArray,
                 fab_data: Sequence[np.ndarray], dtype, max_fabs_per_file: int) -> None:
    ncomp = fab_data[0].shape[0]
    nfab = len(ba)
    entries = _write_fab_files(
        dirname, base, nfab,
        lambda f, i: write_fab(f, ba[i], fab_data[i], dtype=dtype),
        max_fabs_per_file)
    # range tables must describe the STORED values: cast to the output
    # dtype first (an f32 write rounds values past the f64
    # min/max the _H declared)
    cast = [np.asarray(fab_data[i], dtype=dtype) for i in range(nfab)]
    mins = np.array([[float(cast[i][c].min()) for c in range(ncomp)]
                     for i in range(nfab)])
    maxs = np.array([[float(cast[i][c].max()) for c in range(ncomp)]
                     for i in range(nfab)])
    _write_vismf_h(dirname, base, ba, ncomp, entries, mins, maxs)


def _write_fab_files(dirname: str, base: str, nfab: int, write_record,
                     max_fabs_per_file: int) -> List[Tuple[str, int]]:
    """``write_record(f, i)`` for each box in turn, ``max_fabs_per_file``
    records a ``<base>_D_<n>`` file; returns each record's (file, offset)."""
    os.makedirs(dirname, exist_ok=True)
    entries: List[Tuple[str, int]] = []
    ifile = 0
    i = 0
    while i < nfab:
        fname = f"{base}_D_{ifile:05d}"
        with open(os.path.join(dirname, fname), "wb") as f:
            for _ in range(min(max_fabs_per_file, nfab - i)):
                entries.append((fname, f.tell()))
                write_record(f, i)
                i += 1
        ifile += 1
    return entries


def _write_vismf_h(dirname: str, base: str, ba: BoxArray, ncomp: int,
                   entries: Sequence[Tuple[str, int]], mins: np.ndarray,
                   maxs: np.ndarray) -> None:
    nfab = len(ba)
    with open(os.path.join(dirname, base + "_H"), "w") as f:
        f.write("1\n1\n")
        f.write(f"{ncomp}\n")
        f.write("0\n")
        f.write(f"({nfab} 0\n")
        for b in ba:
            f.write(repr(b) + "\n")
        f.write(")\n")
        f.write(f"{nfab}\n")
        for fname, off in entries:
            f.write(f"FabOnDisk: {fname} {off}\n")
        f.write("\n")
        f.write(f"{nfab},{ncomp}\n")
        for i in range(nfab):
            f.write(",".join(f"{v:.17g}" for v in mins[i]) + ",\n")
        f.write("\n")
        f.write(f"{nfab},{ncomp}\n")
        for i in range(nfab):
            f.write(",".join(f"{v:.17g}" for v in maxs[i]) + ",\n")
