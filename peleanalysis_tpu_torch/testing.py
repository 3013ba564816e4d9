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


# -- chemistry -------------------------------------------------------------------
def fraction_fields(species: Sequence[str], prefix: str = "X",
                    ) -> Dict[str, Callable]:
    """Fields ``{prefix(s): fn}`` of mole (or mass) fractions that sum to 1
    everywhere for two species or more: species k is (1 + 0.5 sin(phi +
    2 pi k / ns)) / ns, phi = 2 pi (x + 2y + 3z), within [0.5, 1.5] / ns."""
    ns = len(species)

    def frac(k):
        return lambda x, y, z: (1.0 + 0.5 * np.sin(
            2 * np.pi * (x + 2 * y + 3 * z) + 2 * np.pi * k / ns)) / ns

    return {f"{prefix}({s})": frac(k) for k, s in enumerate(species)}


def nasa7_lines(name: str, hi: Sequence[float], lo: Sequence[float],
                t_mid: float = 1000.0) -> str:
    """One species' four fixed-column CHEMKIN NASA7 lines."""
    l1 = (f"{name:<18}{'':6}{'':20}G{200.0:10.3f}{6000.0:10.3f}"
          f"{t_mid:8.2f}").ljust(79) + "1"

    def f(v):
        return f"{v:15.8E}"

    return "\n".join([
        "".join(f(v) for v in hi[:5]).ljust(79) + "2",
        "".join(f(v) for v in list(hi[5:]) + list(lo[:3])).ljust(79) + "3",
        "".join(f(v) for v in lo[3:]).ljust(79) + "4"]).join(
            [l1 + "\n", ""])


def synthetic_mechanism(species: Sequence[str], n_reactions: int,
                        seed: int = 0, first: Sequence[str] = ()) -> str:
    """CHEMKIN text of a mechanism over ``species`` (formula names, as
    ``chem.mechanism.parse_formula`` reads them): the reaction lines
    ``first``, then atom-balanced reactions drawn with ``seed`` from the
    exchanges A + B = C + D and the combinations A + B = C that the
    formulas allow, up to ``n_reactions`` in all.  The exchanges take in
    turn the forms irreversible, equilibrium-reversible, REV and a
    DUPLICATE pair whose second A is negative; the combinations a third
    body with efficiencies, LOW + TROE (3 and 4 parameters), LOW + SRI (3
    and 5 parameters) and Lindemann.  A THERMO block gives every species
    constant-cp NASA7 data (cp/R 2.5 + its atom count / 2, each range its
    own, formation enthalpies within +-1.5e4 K), which keeps every rate
    and equilibrium constant finite over 300-3000 K."""
    from .chem.mechanism import parse_formula

    rng = np.random.default_rng(seed)
    comp = [parse_formula(s) for s in species]
    elems = sorted({e for c in comp for e in c})
    vec = [tuple(c.get(e, 0) for e in elems) for c in comp]
    idx = range(len(species))
    pairs = [(a, b) for a in idx for b in idx if a <= b]
    by_sum: Dict[tuple, List[tuple]] = {}
    for a, b in pairs:
        by_sum.setdefault(tuple(x + y for x, y in zip(vec[a], vec[b])),
                          []).append((a, b))
    exch, comb = [], []
    for key, ps in by_sum.items():
        for i, (a, b) in enumerate(ps):
            exch += [(a, b, c, d) for c, d in ps[i + 1:]
                     if not {a, b} & {c, d}]
        comb += [(a, b, c) for a, b in ps for c in idx
                 if vec[c] == key and c not in (a, b)]
    exch = [exch[i] for i in rng.permutation(len(exch))]
    comb = [comb[i] for i in rng.permutation(len(comb))]
    sp = list(species)
    effs = " ".join(f"{s}/{e}/" for s, e in zip(
        [s for s in ("H2O", "CO2", "N2", "AR") if s in sp][:3],
        (6.0, 2.0, 0.7)))

    def arr(lo_a=10.0, hi_a=14.0):
        return (f"{10 ** rng.uniform(lo_a, hi_a):.4E} "
                f"{rng.uniform(-1.0, 2.0):.3f} {rng.uniform(0, 3e4):.1f}")

    lines = list(first)
    n_comb = min(len(comb), max(1, (n_reactions - len(lines)) * 3 // 10))
    for i, (a, b, c) in enumerate(comb[:n_comb]):
        lhs = f"{sp[a]} + {sp[b]}"
        form = i % 6
        if form == 0:
            lines += [f"{lhs} + M <=> {sp[c]} + M   {arr(15, 18)}"]
            if effs:
                lines += [f"  {effs}"]
            continue
        lines += [f"{lhs} (+M) <=> {sp[c]} (+M)   {arr()}",
                  f"  LOW / {arr(15, 20)} /"]
        if form == 1:
            lines += [f"  TROE / {rng.uniform(0.4, 0.8):.3f} "
                      f"{rng.uniform(50, 300):.1f} "
                      f"{rng.uniform(1e3, 3e3):.1f} /"]
        elif form == 2:
            lines += [f"  TROE / {rng.uniform(0.4, 0.8):.3f} "
                      f"{rng.uniform(50, 300):.1f} "
                      f"{rng.uniform(1e3, 3e3):.1f} "
                      f"{rng.uniform(3e3, 8e3):.1f} /"]
        elif form == 3:
            lines += [f"  SRI / {rng.uniform(0.3, 0.7):.3f} "
                      f"{rng.uniform(100, 900):.1f} "
                      f"{rng.uniform(500, 2e3):.1f} /"]
        elif form == 4:
            lines += [f"  SRI / {rng.uniform(0.3, 0.7):.3f} "
                      f"{rng.uniform(100, 900):.1f} "
                      f"{rng.uniform(500, 2e3):.1f} "
                      f"{rng.uniform(0.8, 1.2):.3f} "
                      f"{rng.uniform(-0.5, 0.5):.3f} /"]
        if effs and form in (1, 3):
            lines += [f"  {effs}"]
    n_rx = len([ln for ln in lines if "=" in ln])
    for i, (a, b, c, d) in enumerate(exch):
        if n_rx >= n_reactions:
            break
        eqn = f"{sp[a]} + {sp[b]} {{}} {sp[c]} + {sp[d]}"
        form = i % 4
        if form == 0:
            lines += [f"{eqn.format('=>')}   {arr()}"]
        elif form == 1:
            lines += [f"{eqn.format('<=>')}   {arr()}"]
        elif form == 2:
            lines += [f"{eqn.format('<=>')}   {arr()}",
                      f"  REV / {arr()} /"]
        else:
            if n_rx + 2 > n_reactions:
                continue
            a1 = 10 ** rng.uniform(11, 13)
            rest = f"{rng.uniform(-0.5, 1.0):.3f} {rng.uniform(0, 2e4):.1f}"
            lines += [f"{eqn.format('<=>')}   {a1:.4E} {rest}", "DUPLICATE",
                      f"{eqn.format('<=>')}   {-0.3 * a1:.4E} {rest}",
                      "DUPLICATE"]
            n_rx += 1
        n_rx += 1
    if n_rx < n_reactions:
        raise ValueError(f"{species} allow only {n_rx} reactions")
    thermo = []
    for k, s in enumerate(species):
        cp = 2.5 + 0.5 * sum(comp[k].values())
        h = rng.uniform(-1.5e4, 1.5e4)
        s0 = rng.uniform(0.0, 10.0)
        lo = [cp, 0, 0, 0, 0, h, s0]
        hi = [cp + 0.25, 0, 0, 0, 0, h - 250.0, s0 - 1.75]
        thermo.append(nasa7_lines(s, hi, lo, (1000.0, 1200.0, 900.0)[k % 3]))
    return ("ELEMENTS\n" + " ".join(elems) + "\nEND\nSPECIES\n"
            + " ".join(species) + "\nEND\nTHERMO\n"
            + "\n".join(thermo) + "\nEND\nREACTIONS\n" + "\n".join(lines)
            + "\nEND\n")
