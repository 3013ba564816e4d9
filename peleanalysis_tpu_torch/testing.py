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


def hit_fields() -> Dict[str, Callable]:
    """A periodic, solenoidal unit-sine velocity field with a cosine
    temperature and a constant density (the HIT fields of
    ``tests/test_turbulence_post.py``): <|u|^2> = 1.5, curl u =
    -2pi(cos 2pi z, cos 2pi x, cos 2pi y), div u = 0, <T'^2> = 50, and all
    the kinetic energy in the |k| = 1 shell of the unit box."""
    return {
        "x_velocity": lambda x, y, z: np.sin(2 * np.pi * y),
        "y_velocity": lambda x, y, z: np.sin(2 * np.pi * z),
        "z_velocity": lambda x, y, z: np.sin(2 * np.pi * x),
        "temp": lambda x, y, z: 300.0 + 10 * np.cos(2 * np.pi * x),
        "density": lambda x, y, z: 1.0 + 0 * x,
    }


def write_hit_run(root: str, n_cell: int = 16, max_grid_size: int = 16,
                  times: Sequence[float] = (0.0, 0.1)) -> List[str]:
    """A HIT run directory for the turbulence tools: one single-level
    periodic plotfile ``plt%05d`` of ``hit_fields`` per time, and an
    ``ic.txt`` of the nondimensionalization constants.  Returns the
    plotfile paths."""
    paths = []
    for i, t in enumerate(times):
        paths.append(f"{root}/plt{i:05d}")
        write_synthetic_plotfile(paths[-1], n_cell=n_cell, n_levels=1,
                                 max_grid_size=max_grid_size,
                                 fields=hit_fields(), time=t,
                                 is_periodic=(True, True, True))
    with open(f"{root}/ic.txt", "w") as f:
        f.write("urms0, lambda0, tau, T0, Mach, c_s0\n")
        f.write("1.0, 0.5, 0.2, 300.0, 0.1, 340.0\n")
    return paths


def make_scattered_state(
    n0: int = 128,
    ratio: int = 4,
    n_clusters: int = 16,
    fine_box: int = 32,
    seed: int = 7,
    fields: Optional[Dict[str, Callable]] = None,
):
    """Production-sparse case (``peleanalysis_tpu/testing.py:133``): level 0
    ``n0``^3 in 32^3 boxes plus ``n_clusters`` scattered ``fine_box``^3
    patches on an (n0*ratio)^3 finest index space (<1% coverage at the
    defaults), the per-rank memory-scaling scenario the reference gets from
    DistributionMapping ownership (Src/grad.cpp:160-163).  The patches sit
    on a 4x4x4 coarse lattice, so they stay well separated.  Returns
    ``(meta, names, level_fabs)`` as ``load_plotfile_fabs`` does (float64
    per-box ``[ncomp, *box.shape]`` arrays)."""
    from .amr.hierarchy import AmrMeta

    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (False,) * 3)
    geom1 = geom0.refine(ratio)
    nf = n0 * ratio
    rng = np.random.default_rng(seed)
    cells = [(i, j, k) for i in range(4) for j in range(4) for k in range(4)]
    rng.shuffle(cells)
    boxes = []
    for (i, j, k) in cells[:n_clusters]:
        lo = (i * nf // 4 + 8, j * nf // 4 + 8, k * nf // 4 + 8)
        lo = tuple((v // ratio) * ratio for v in lo)  # ratio-aligned
        boxes.append(Box(lo, tuple(v + fine_box - 1 for v in lo)))
    bas = [decompose(dom0, 32), BoxArray(boxes)]
    if fields is None:
        fields = {"temp": lambda x, y, z: 300 + 1500 * np.exp(
            -((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2) / 0.2 ** 2)}
    names, data = make_level_data([geom0, geom1], bas, fields)
    return AmrMeta([geom0, geom1], bas, [ratio]), names, data


def write_scattered_plotfile(path: str, time: float = 0.0, **kw):
    """``make_scattered_state(**kw)`` written as a float64 plotfile;
    returns ``(meta, names, level_fabs)``."""
    meta, names, data = make_scattered_state(**kw)
    write_plotfile(path, names, time, meta.geoms, meta.ref_ratio, meta.bas,
                   data)
    return meta, names, data
