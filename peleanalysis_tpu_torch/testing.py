"""Synthetic AMR plotfile generation for tests and benchmarks.

The reference ships no fixtures at all (SURVEY.md §4); we generate analytic
"flame-ball" plotfiles so every tool can be validated against closed-form
answers (gradient of a Gaussian, curvature of a sphere, etc.).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .amr.box import Box, BoxArray, decompose
from .amr.geometry import Geometry
from .io.plotfile import write_plotfile


def cell_centers(box: Box, geom: Geometry) -> List[np.ndarray]:
    """Per-dimension 1-D arrays of cell-center coordinates for ``box``."""
    dx = geom.dx
    return [
        geom.prob_lo[d] + (np.arange(box.lo[d], box.hi[d] + 1) -
                           geom.domain.lo[d] + 0.5) * dx[d]
        for d in range(box.ndim)
    ]


def eval_on_box(box: Box, geom: Geometry,
                fields: Dict[str, Callable]) -> np.ndarray:
    cs = cell_centers(box, geom)
    mesh = np.meshgrid(*cs, indexing="ij")
    return np.stack([np.asarray(fn(*mesh), dtype=np.float64)
                     for fn in fields.values()])


def default_fields(ndim: int = 3) -> Dict[str, Callable]:
    """Analytic flame-ball state: hot Gaussian ball at domain center."""
    c = 0.5
    w = 0.15

    def r2(*x):
        return sum((xi - c) ** 2 for xi in x)

    def temp(*x):
        return 300.0 + 1500.0 * np.exp(-r2(*x) / w**2)

    def prog(*x):  # progress-variable-like monotone field
        return np.exp(-r2(*x) / w**2)

    def density(*x):
        return 1.0 / (1.0 + 4.0 * np.exp(-r2(*x) / w**2))

    fields = {"temp": temp, "progress": prog, "density": density}
    names = ["x_velocity", "y_velocity", "z_velocity"][:ndim]
    for d, nm in enumerate(names):
        # solid-body-like rotation in the (0,1) plane + gentle shear
        if d == 0:
            fields[nm] = lambda *x: -(x[1] - c) + 0.1 * np.sin(2 * np.pi * x[0])
        elif d == 1:
            fields[nm] = lambda *x: (x[0] - c) + 0.1 * np.cos(2 * np.pi * x[1])
        else:
            fields[nm] = lambda *x: 0.25 * np.ones_like(x[0])
    return fields


def make_amr_hierarchy(
    n_cell: int = 32,
    n_levels: int = 3,
    ref_ratio: int = 2,
    max_grid_size: int = 16,
    ndim: int = 3,
    refine_frac: float = 0.5,
    is_periodic: Sequence[bool] = (False, False, False),
    nest_margin: int = 2,
) -> Tuple[List[Geometry], List[BoxArray], List[int]]:
    """Nested box hierarchy: each finer level covers the central
    ``refine_frac`` fraction of the domain, shrunk by ``nest_margin`` coarse
    cells so ghost fills up to 2*ratio*nest_margin wide stay properly nested
    (AMReX regrid's n_proper analog)."""
    dom0 = Box((0,) * ndim, (n_cell - 1,) * ndim)
    geom0 = Geometry(dom0, (0.0,) * ndim, (1.0,) * ndim, tuple(is_periodic[:ndim]))
    geoms = [geom0]
    bas = [decompose(dom0, max_grid_size)]
    ratios = []
    for lev in range(1, n_levels):
        geoms.append(geoms[-1].refine(ref_ratio))
        ratios.append(ref_ratio)
        dom = geoms[-1].domain
        n = dom.shape[0]
        half = int(n * refine_frac / 2)
        ctr = n // 2
        m = nest_margin * ref_ratio if lev > 1 else 0
        sub = Box(tuple(ctr - half + m for _ in range(ndim)),
                  tuple(ctr + half - 1 - m for _ in range(ndim)))
        bas.append(decompose(sub, max_grid_size))
    return geoms, bas, ratios


def make_level_data(
    geoms: Sequence[Geometry],
    bas: Sequence[BoxArray],
    fields: Optional[Dict[str, Callable]] = None,
) -> Tuple[List[str], List[List[np.ndarray]]]:
    ndim = geoms[0].ndim
    if fields is None:
        fields = default_fields(ndim)
    names = list(fields.keys())
    data = [[eval_on_box(b, geoms[lev], fields) for b in bas[lev]]
            for lev in range(len(bas))]
    return names, data


def write_synthetic_plotfile(
    path: str,
    n_cell: int = 32,
    n_levels: int = 3,
    ref_ratio: int = 2,
    max_grid_size: int = 16,
    ndim: int = 3,
    fields: Optional[Dict[str, Callable]] = None,
    time: float = 0.5,
    is_periodic: Sequence[bool] = (False, False, False),
    refine_frac: float = 0.5,
):
    geoms, bas, ratios = make_amr_hierarchy(
        n_cell, n_levels, ref_ratio, max_grid_size, ndim,
        refine_frac=refine_frac, is_periodic=is_periodic)
    names, data = make_level_data(geoms, bas, fields)
    write_plotfile(path, names, time, geoms, ratios, bas, data)
    return geoms, bas, ratios, names, data
