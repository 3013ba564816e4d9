"""Host side of the AMR hierarchy: static metadata, plotfile load into
per-level numpy FAB lists, and the plotfile write tail.

Counterpart of the host parts of ``peleanalysis_tpu/amr/hierarchy.py``
(``AmrMeta``, ``AmrState.from_plotfile``'s read, ``write_level_fabs``,
``_periodic_shifts``).  The batched-box device model and its gather fill
are not ported: the port's device model is the dense one (amr/dense.py).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence

import numpy as np

from .box import Box, BoxArray
from .geometry import Geometry
from ..io.plotfile import (PlotfileReader, promote_2d, write_plotfile,
                           write_plotfile_records)
from ..telemetry import count, span


@dataclasses.dataclass
class AmrMeta:
    """Static (host-side) description of the hierarchy."""

    geoms: List[Geometry]
    bas: List[BoxArray]
    ref_ratio: List[int]
    time: float = 0.0
    level_steps: Optional[List[int]] = None
    # True when the source plotfile was DIM=2 (promoted in memory to nz=1;
    # the writer demotes back)
    ndim2: bool = False

    @property
    def n_levels(self) -> int:
        return len(self.bas)

    @property
    def ndim(self) -> int:
        return self.geoms[0].ndim


def load_plotfile_fabs(path: str, names: Optional[Sequence[str]] = None,
                       max_level: Optional[int] = None,
                       is_periodic: Optional[Sequence[bool]] = None):
    """Read a plotfile into ``(meta, names, level_fabs)``, where
    ``level_fabs[lev][i]`` is box i's float64 ``[ncomp, *box.shape]``.
    DIM=2 plotfiles are promoted to 3-D with nz=1.  Counts the FABs'
    bytes (``read.bytes``) and the plotfile (``read.plotfiles``)."""
    with span("read.plotfile"):
        r = PlotfileReader(path)
        m = r.meta
        finest = m.finest_level if max_level is None else min(
            max_level, m.finest_level)
        names = list(names) if names is not None else list(m.var_names)
        comps = [r.var_index(n) for n in names]
        bas = [r.box_array(lev) for lev in range(finest + 1)]
        fabs = [r.read_level(lev, comps) for lev in range(finest + 1)]
    count("read.plotfiles")
    count("read.bytes", sum(f.nbytes for level in fabs for f in level))
    if m.ndim == 2:
        geoms, bas, fabs = promote_2d(m, bas, fabs)
        if is_periodic is not None:
            geoms = [Geometry(g.domain, g.prob_lo, g.prob_hi,
                              tuple(bool(p) for p in is_periodic[:2])
                              + (False,), g.coord_sys) for g in geoms]
    else:
        geoms = [m.geometry(lev, is_periodic) for lev in range(finest + 1)]
    meta = AmrMeta(geoms, bas, m.ref_ratio[:finest], m.time,
                   m.level_steps, ndim2=(m.ndim == 2))
    return meta, names, fabs


def output_layout(meta: AmrMeta):
    """(geoms, box arrays) as a plotfile of ``meta`` records them: a DIM=2
    source is demoted back from its nz=1 promotion."""
    geoms, bas = meta.geoms, meta.bas
    if meta.ndim2:
        geoms = [Geometry(Box(g.domain.lo[:2], g.domain.hi[:2]),
                          g.prob_lo[:2], g.prob_hi[:2],
                          g.is_periodic[:2], g.coord_sys) for g in geoms]
        bas = [BoxArray([Box(b.lo[:2], b.hi[:2]) for b in ba])
               for ba in meta.bas]
    return geoms, bas


def write_level_fabs(meta: AmrMeta, names, level_fabs, path: str,
                     dtype=np.float64) -> None:
    """Write per-level fab lists as a plotfile (handles the DIM=2
    demotion)."""
    geoms, bas = output_layout(meta)
    if meta.ndim2:
        level_fabs = [[f[..., 0] for f in fabs] for fabs in level_fabs]
    write_plotfile(path, names, meta.time, geoms, meta.ref_ratio,
                   bas, level_fabs,
                   level_steps=meta.level_steps, dtype=dtype)


def write_level_records(meta: AmrMeta, names, level_records, path: str,
                        dtype=np.float64) -> None:
    """Write per-level ``(payloads, mins, maxs)`` FAB records (see
    ``io/plotfile.py`` ``write_plotfile_records``) as a plotfile."""
    geoms, bas = output_layout(meta)
    write_plotfile_records(path, names, meta.time, geoms, meta.ref_ratio,
                           bas, level_records, level_steps=meta.level_steps,
                           dtype=dtype)


def _periodic_shifts(per: Sequence[bool], dom: Box):
    opts = [([-n, 0, n] if p else [0])
            for p, n in zip(per, dom.shape)]
    return [s for s in itertools.product(*opts)]
