"""Domain decomposition of a dense hierarchy over a spatial mesh: deep-halo
windows.

Counterpart of ``peleanalysis_tpu/parallel/dense_shard.py``.  The JAX
package shards every level array over a ``jax.sharding`` mesh and lets
GSPMD insert the halo collectives into each slice of the fill and the
stencils.  PyTorch has no partitioner, and a halo exchange before each of
a curvature call's ~950 kernels would mean rewriting the tested
single-device engine.  So each shard gets one WINDOW instead: per level,
the cells it owns plus a halo as deep as the tool's whole chain of ghost
fills and stencils.  A window is assembled from the host FABs
(:class:`HostFabs`) and copied to the shard's device, or, when its source
is an earlier stage's output (:class:`ShardGather`), cut on the shard's
device from the parts that stay on their cards: a neighbour's part gives
a thin slab, one peer copy.  Both give the same window, byte for byte.
The shard runs the single-device function on its window and keeps only
its own cells, on its card (``run_windows``, :class:`ShardGather`): the
plotfile, the one-card state, the host FABs and the next stage's windows
are all read from there.  A cell farther than the halo from a window's
edge is computed exactly as in the global run, whatever the fill puts at
that edge, so the files are the unsharded run's, byte for byte.

The partition (AMReX's DistributionMapping, Src/grad.cpp:160-163): the
level-0 domain is cut into the mesh's blocks (X slabs by default,
``mesh_shape=a b [c]`` blocks along x, y, z), faces on level-0 cell faces,
so every ratio divides them; on every level a shard owns the cells of its
block.  Its level-l window is the bounding box of its owned cells grown by
``Halo.cells`` and of the parent region of its level-(l+1) window grown by
``Halo.reach`` coarse cells, clipped to the level's bbox, ratio-aligned.
With ``Halo.child`` (fluxMatch: coarse cells take their fine faces'
fluxes) a fine window also covers the children of its coarser owned cells.
No device ever holds a whole level.

Each window's geometry (``WindowGeometry``) has the window's level-0 box
as its domain along the cut dims, periodicity off there, and the global
dx: the fill then meets a cut like a domain edge (whatever it puts there
the halo absorbs), a true domain edge keeps its BC, and coordinates,
stencil weights and volumes are the global run's.  Along a periodic cut
dim the window runs past the domain edge and holds the periodic images of
the boxes there, unrolled.  The in-level and covered masks come from the
global BoxArrays.  The isosurface windows (``Halo.duals``) own dual cells
instead of cells, the outermost blocks reaching out to the grown ring, and
each has a :class:`WindowInfo` (``window_info``) that keeps the enum
engine's node keys, node rows and triangle order global
(``geom/marching_cubes.py``).

A DIM=2 plotfile (promoted to nz=1) is cut along x and y only: its z
extent of 1 is never refined, coarsened or cut.  The smoothing solve is
elliptic, so no finite halo makes a window exact: its shards keep every
window resident and exchange halos inside the solve
(``parallel/halo.py`` ``WindowHalo``, ``tools/curvature.py``).
``pad_state_to`` / ``pad_state_divisible`` exist for XLA's divisibility and
for ``shape_bucket=`` (refused): they have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..amr.box import Box, BoxArray
from ..amr.dense import (DenseAmrState, DenseLevelMeta, PlotfileRecords,
                         _box_slices, _level_metas, _np_dtype,
                         covered_mask_over)
from ..amr.geometry import Geometry
from ..amr.hierarchy import AmrMeta, _periodic_shifts
from ..ops.dense_fill import interp_stencil
from ..telemetry import count, span
from .mesh import Mesh, shard_devices

SPATIAL_AXES = ("x", "y", "z")
_FAR = 1 << 40


def make_spatial_mesh(n: int, shape: Optional[Sequence[int]] = None,
                      device=None) -> Mesh:
    """X slabs by default; ``shape=(a, b[, c])`` for blocks over ("x",
    "y"[, "z"]).  Raises when the shape's product is not n."""
    shape = (int(n),) if shape is None else tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if len(shape) > 3:
        raise ValueError(f"mesh shape {shape}: at most 3 spatial axes")
    return Mesh(shard_devices(n, device), shape,
                SPATIAL_AXES[: len(shape)])


def mesh_from_pp(pp, ndev: int, device) -> Mesh:
    """Mesh from the shared CLI keys: ndevices=N [mesh_shape=a b [c]]."""
    return make_spatial_mesh(ndev, pp.query_int_list("mesh_shape", None),
                             device)


@dataclasses.dataclass(frozen=True)
class Halo:
    """How far a window reaches beyond what its shard owns.

    cells:  level cells around the owned region, at every level
    reach:  coarse cells around the parent region of a finer window
    child:  a fine window also holds the children of its coarser owned
            cells and one ring (fluxMatch)
    duals:  the shard owns dual cells (the isosurface) and its windows
            have a :class:`WindowInfo`"""
    cells: int
    reach: int
    child: bool = False
    duals: bool = False


def stencil_halo(stages: int, interp: str, child: bool = False) -> Halo:
    """The halo of a chain of ``stages`` fill-then-stencil steps, each a
    one-ghost fill (``fill_dense_multilevel`` with ngrow=1) and a centred
    stencil.  Step k's output is exact one cell further in than its input,
    so owned cells need ``stages`` cells around them; a fine hole or ghost
    at step k reads the coarse level ``interp_stencil`` cells around its
    parent, where the coarse field is exact k - 1 cells in from the coarse
    window's edge, so a parent region needs ``interp_stencil + stages - 1``
    coarse cells around it."""
    return Halo(stages, interp_stencil(interp) + stages - 1, child)


# grad: one fill + the gradient; curvature: G, then N and the Hessian
# from G (tools/curvature.py _make_pipeline); the isosurface: one
# piecewise-constant fill, a dual cell reading its +1 corners, and a
# class-B seam edge's coarse parent with its +1 corner
GRAD_STAGES = 1
CURVATURE_STAGES = 2
ISO_HALO = Halo(1, 1, duals=True)


@dataclasses.dataclass(frozen=True)
class WindowGeometry(Geometry):
    """A window's level geometry: ``domain`` is where the fill meets the
    window's edge as a domain edge (the window's level-0 box along the cut
    dims, refined), ``is_periodic`` is off along the cut dims, and ``dx`` is
    the global level's (``base``), so no coordinate or weight is
    recomputed from a shifted origin."""
    base: Optional[Geometry] = None

    @property
    def dx(self) -> Tuple[float, ...]:
        return self.base.dx


@dataclasses.dataclass
class WindowInfo:
    """What the isosurface engine needs to keep a window's output global,
    per window level: the global geometry (coordinates, periodic unwraps);
    whether the global level spans each periodic dim (node keys then fold
    as its seams do); the range of dual-cell lower corners the shard owns;
    which window cells lie inside the global domain (the unrolled periodic
    images do not: the engine's in-level flags are the global run's); and
    the global covered mask over the window grown by one."""
    geoms: List[Geometry]
    spans: List[Tuple[bool, bool, bool]]
    duals: List[Tuple[Tuple[int, ...], Tuple[int, ...]]]
    in_domain: List[np.ndarray]
    covered_ring: List[np.ndarray]

    def wrap(self, lev: int, d: int, idx: np.ndarray) -> np.ndarray:
        """Global indices along d mapped into the domain where d is
        periodic."""
        g = self.geoms[lev]
        if not g.is_periodic[d]:
            return idx
        return g.domain.lo[d] + (idx - g.domain.lo[d]) % g.domain.shape[d]


def _blocks(n: int, lo: int, hi: int) -> List[Tuple[int, int]]:
    """n near-equal ranges over lo..hi (``amr/box.decompose``'s split)."""
    ext = hi - lo + 1
    if n > ext:
        raise ValueError(f"{n} blocks over a level-0 extent of {ext} cells")
    base, rem = divmod(ext, n)
    sizes = [base + (1 if i < rem else 0) for i in range(n)]
    offs = np.cumsum([0] + sizes)
    return [(lo + int(offs[i]), lo + int(offs[i + 1]) - 1) for i in range(n)]


def _hull(boxes) -> Optional[Box]:
    boxes = [b for b in boxes if b is not None and not b.is_empty()]
    if not boxes:
        return None
    return Box(tuple(min(b.lo[d] for b in boxes) for d in range(3)),
               tuple(max(b.hi[d] for b in boxes) for d in range(3)))


def _isect(a: Box, b: Box) -> Optional[Box]:
    c = a.intersect(b)
    return None if c.is_empty() else c


@dataclasses.dataclass
class ShardPlan:
    """One shard's windows: ``windows[l]`` for levels 0..len-1, the level-l
    ``block`` it owns (cells: ``owned[l]`` is its part of the level's bbox,
    None when empty) and, for the isosurface, its dual-cell range."""
    blocks: List[Box]
    owned: List[Optional[Box]]
    windows: List[Box]
    duals: List[Tuple[Tuple[int, ...], Tuple[int, ...]]]

    @property
    def n_levels(self) -> int:
        return len(self.windows)


class ShardedDenseState:
    """A hierarchy cut into one window a shard over ``mesh``, each built on
    its shard's device when visited (``window(s)`` or iteration) and held
    only by the caller.  The counterpart of the JAX ``shard_dense_state``.

    ``source``: where the windows' data comes from, holding the comps
    ``source.names``: :class:`HostFabs`, or an earlier stage's
    :class:`ShardGather`; None for the partition only.  The windows hold
    ``names`` only."""

    def __init__(self, meta: AmrMeta, names: Sequence[str], source,
                 mesh: Mesh, halo: Halo, dtype: torch.dtype):
        if meta.ndim2 and "z" in mesh.axis_names:
            raise ValueError(f"mesh_shape {mesh.shape} cuts z, which a DIM=2 "
                             "plotfile does not have: give mesh_shape=a b")
        axes = [SPATIAL_AXES.index(a) for a in mesh.axis_names]
        self.meta, self.names, self.source = meta, list(names), source
        # the source's comp of each of the windows' comps
        self._idx = (None if source is None else
                     [list(source.names).index(n) for n in self.names])
        self.mesh, self.halo, self.dtype = mesh, halo, dtype
        self.lmeta = _level_metas(meta)
        self.cut = [False] * 3
        for ax, n in zip(axes, mesh.shape):
            self.cut[ax] = n > 1
        g0 = meta.geoms[0]
        ranges = [[(g0.domain.lo[d], g0.domain.hi[d])] for d in range(3)]
        for ax, n in zip(axes, mesh.shape):
            ranges[ax] = _blocks(n, g0.domain.lo[ax], g0.domain.hi[ax])
        self.plans = []
        for s in range(mesh.size):
            idx = mesh.index(s)
            pick = [0, 0, 0]
            for ax, i in zip(axes, idx):
                pick[ax] = i
            b0 = Box(tuple(ranges[d][pick[d]][0] for d in range(3)),
                     tuple(ranges[d][pick[d]][1] for d in range(3)))
            ends = [(pick[d] == 0, pick[d] == len(ranges[d]) - 1)
                    for d in range(3)]
            self.plans.append(self._plan(b0, ends))

    # -- the partition ---------------------------------------------------------
    def _ratio(self, lev: int) -> Tuple[int, int, int]:
        """Per-dim ratio from level lev to lev + 1 (1 along a DIM=2
        plotfile's z)."""
        r = self.meta.ref_ratio[lev]
        return (r, r, 1) if self.meta.ndim2 else (r, r, r)

    def _level_block(self, b0: Box, lev: int) -> Box:
        b = b0
        for l in range(lev):
            b = b.refine(self._ratio(l))
        return b

    def _dual_range(self, block: Box, ends, lev: int):
        """Owned lower corners of the level's dual cells: the block, the
        outermost blocks out to the grown ring ([lo - 1, hi] where the
        global level is periodic, unbounded elsewhere: the window's own
        domain bounds take over there)."""
        g = self.meta.geoms[lev]
        lo, hi = list(block.lo), list(block.hi)
        for d in range(3):
            if not self.cut[d]:
                lo[d], hi[d] = -_FAR, _FAR
                continue
            per = g.is_periodic[d]
            if ends[d][0]:
                lo[d] = g.domain.lo[d] - 1 if per else -_FAR
            if ends[d][1]:
                hi[d] = g.domain.hi[d] if per else _FAR
        return tuple(lo), tuple(hi)

    def _own_region(self, plan_blocks, duals, lev: int) -> Optional[Box]:
        bbox = self.lmeta[lev].bbox
        if self.halo.duals:
            lo, hi = duals[lev]
            ring = Box(tuple(v - 1 for v in bbox.lo), bbox.hi)
            return _isect(Box(lo, hi), ring)
        return _isect(plan_blocks[lev], bbox)

    def _clip(self, w: Box, lev: int) -> Optional[Box]:
        """``w`` clipped to the level's bbox; along a periodic cut dim to
        the hull of the bbox's periodic images that meet it."""
        bbox = self.lmeta[lev].bbox
        g = self.meta.geoms[lev]
        lo, hi = [], []
        for d in range(3):
            pieces = [(bbox.lo[d], bbox.hi[d])]
            if self.cut[d] and g.is_periodic[d]:
                n = g.domain.shape[d]
                pieces = [(bbox.lo[d] + k * n, bbox.hi[d] + k * n)
                          for k in (-1, 0, 1)]
            got = [(max(a, w.lo[d]), min(b, w.hi[d])) for a, b in pieces]
            got = [(a, b) for a, b in got if a <= b]
            if not got:
                return None
            lo.append(min(a for a, _ in got))
            hi.append(max(b for _, b in got))
        return Box(tuple(lo), tuple(hi))

    def _align(self, w: Box, lev: int) -> Box:
        """``w`` grown to whole ratio blocks counted from the level's bbox
        (a fine level's coarse-aligned planes and block means, as
        ``ops/restrict.py`` takes them, start there)."""
        if lev == 0:
            return w
        r = self._ratio(lev - 1)
        o = [v % r[d] for d, v in enumerate(self.lmeta[lev].bbox.lo)]
        return Box(tuple((w.lo[d] - o[d]) // r[d] * r[d] + o[d]
                         for d in range(3)),
                   tuple(-(-(w.hi[d] + 1 - o[d]) // r[d]) * r[d] + o[d] - 1
                         for d in range(3)))

    def _plan(self, b0: Box, ends) -> ShardPlan:
        meta, halo = self.meta, self.halo
        L = meta.n_levels
        blocks = [self._level_block(b0, lev) for lev in range(L)]
        duals = [self._dual_range(blocks[lev], ends, lev) for lev in range(L)]
        owned = [_isect(blocks[lev], self.lmeta[lev].bbox)
                 for lev in range(L)]
        region = [self._own_region(blocks, duals, lev) for lev in range(L)]

        def child(lev):
            # fluxMatch: the children of the coarser owned cells and a ring
            if not halo.child or lev == 0 or region[lev - 1] is None:
                return None
            return _isect(region[lev - 1].grow(1).refine(
                self._ratio(lev - 1)).grow(1), self.lmeta[lev].bbox)

        top = max(lev for lev in range(L)
                  if region[lev] is not None or child(lev) is not None)
        while True:
            wins: List[Optional[Box]] = [None] * (top + 1)
            need = None
            for lev in range(top, -1, -1):
                # the parent region of what the finer level needs, ghosts
                # beyond its bbox included, not of its clipped window
                parts = [child(lev)]
                if region[lev] is not None:
                    parts.append(region[lev].grow(halo.cells))
                if need is not None:
                    parts.append(need.coarsen(
                        self._ratio(lev)).grow(halo.reach))
                need = _hull(parts)
                wins[lev] = None if need is None else self._clip(
                    self._align(need, lev), lev)
            # a window level whose region holds no box of the level adds
            # nothing (its owned cells are holes): the window stops below
            empty = [lev for lev in range(top + 1)
                     if wins[lev] is None or not self._boxes(lev, wins[lev])]
            if not empty:
                break
            top = min(empty) - 1
            if top < 0:
                raise ValueError("a shard's window holds no level-0 box")
        return ShardPlan(blocks, owned, wins, duals)

    def _shifts(self, lev: int):
        g = self.meta.geoms[lev]
        return _periodic_shifts(g.is_periodic, g.domain)

    def _boxes(self, lev: int, w: Box):
        """(box index, shift, part of the shifted box inside w) of every
        box of the level or periodic image of one that meets w, by box
        then shift."""
        ba = self.meta.bas[lev]
        lo, hi = ba.lo, ba.hi
        hits = []
        for k, sh in enumerate(self._shifts(lev)):
            ilo = np.maximum(lo + sh, w.lo)
            ihi = np.minimum(hi + sh, w.hi)
            for i in np.nonzero((ilo <= ihi).all(axis=1))[0]:
                hits.append((int(i), k, sh, Box(tuple(int(v) for v in ilo[i]),
                                                tuple(int(v) for v in ihi[i]))))
        return [(i, sh, part) for i, _, sh, part in sorted(
            hits, key=lambda h: h[:2])]

    # -- the windows -------------------------------------------------------------
    def __iter__(self):
        for s in range(self.mesh.size):
            yield s, self.window(s)

    def window_bytes(self, s: int) -> int:
        """Bytes of shard s's window data (every component, every level)."""
        item = torch.empty((), dtype=self.dtype).element_size()
        return sum(len(self.names) * w.size * item
                   for w in self.plans[s].windows)

    def state_bytes(self) -> int:
        """Bytes of the unsharded dense state of the same components."""
        item = torch.empty((), dtype=self.dtype).element_size()
        return sum(len(self.names) * lm.bbox.size * item
                   for lm in self.lmeta)

    def _geometry(self, plan: ShardPlan, lev: int) -> WindowGeometry:
        g = self.meta.geoms[lev]
        w0 = plan.windows[0]
        lo, hi = list(self.meta.geoms[0].domain.lo), list(
            self.meta.geoms[0].domain.hi)
        for d in range(3):
            if self.cut[d]:
                lo[d], hi[d] = w0.lo[d], w0.hi[d]
        dom = Box(tuple(lo), tuple(hi))
        for l in range(lev):
            dom = dom.refine(self._ratio(l))
        per = tuple(p and not c for p, c in zip(g.is_periodic, self.cut))
        return WindowGeometry(dom, g.prob_lo, g.prob_hi, per, g.coord_sys,
                              base=g)

    @staticmethod
    def _inside(box: Box, w: Box) -> np.ndarray:
        """bool over w: the cell lies in ``box``."""
        axes = [(np.arange(w.lo[d], w.hi[d] + 1) >= box.lo[d])
                & (np.arange(w.lo[d], w.hi[d] + 1) <= box.hi[d])
                for d in range(3)]
        return axes[0][:, None, None] & axes[1][None, :, None] \
            & axes[2][None, None, :]

    def window(self, s: int) -> DenseAmrState:
        """Shard s's window as a dense state on its device; its in-level
        and covered masks the global ones, computed on the host, and its
        levels taken from ``source`` (span ``shard.assemble``), then placed
        on the device (``source.window_data``).  Counts ``shard.windows``,
        ``shard.window_cells`` (every level's window, halo included) and
        ``shard.owned_cells``."""
        plan = self.plans[s]
        meta = self.meta
        dev = self.mesh.devices[s]
        L = plan.n_levels
        geoms = [self._geometry(plan, lev) for lev in range(L)]
        bas, levels, inlev, covered = [], [], [], []
        with span("shard.assemble"):
            for lev in range(L):
                w = plan.windows[lev]
                parts = self._boxes(lev, w)
                mask = np.zeros(w.shape, dtype=bool)
                for _, _, part in parts:
                    mask[_box_slices(part, w)] = True
                levels.append(self.source.window_level(self, lev, w, parts,
                                                       mask, dev))
                bas.append(BoxArray([p for _, _, p in parts]))
                inlev.append(mask)
                # no cell outside the global bbox is covered, as none is in
                # the global run: its flux matching sees the bbox's edge
                covered.append(covered_mask_over(meta, lev, w)
                               & self._inside(self.lmeta[lev].bbox, w))
        data = self.source.window_data(levels, dev)
        count("shard.windows")
        count("shard.window_cells", sum(w.size for w in plan.windows[:L]))
        count("shard.owned_cells", self.owned_cells(s))
        del levels
        wmeta = AmrMeta(geoms, bas, list(meta.ref_ratio[: L - 1]), meta.time,
                        meta.level_steps[:L] if meta.level_steps else None,
                        meta.ndim2)
        lmeta = [DenseLevelMeta(plan.windows[lev], geoms[lev])
                 for lev in range(L)]
        ds = DenseAmrState(wmeta, self.names, data, lmeta, dev)
        ds._in_level_np[:L] = inlev
        ds._covered_np[:L] = covered
        return ds

    def owned_cells(self, s: int) -> int:
        """The cells shard s answers for: of the levels' boxes inside its
        blocks, or with ``Halo.duals`` the dual cells (lower corners over
        each level's bbox grown by one below) it owns.  Over the shards
        they sum to the hierarchy's cells, or to its dual cells."""
        plan = self.plans[s]
        n = 0
        for lev in range(self.meta.n_levels):
            if self.halo.duals:
                got = self._own_region(plan.blocks, plan.duals, lev)
                n += 0 if got is None else got.size
                continue
            ba, blk = self.meta.bas[lev], plan.blocks[lev]
            ext = (np.minimum(ba.hi, blk.hi) - np.maximum(ba.lo, blk.lo)
                   + 1).clip(min=0)
            n += int(ext.prod(axis=1).sum())
        return n

    def window_info(self, s: int) -> WindowInfo:
        """What the isosurface engine needs to keep shard s's output global
        (``geom/marching_cubes.extract_isosurface_enum``'s ``window``);
        only for the windows of a ``Halo`` with ``duals``."""
        if not self.halo.duals:
            raise ValueError("window_info needs windows that own dual cells "
                             "(Halo.duals)")
        plan = self.plans[s]
        meta = self.meta
        L = plan.n_levels
        return WindowInfo(
            [meta.geoms[lev] for lev in range(L)],
            [self._spans(lev) for lev in range(L)],
            plan.duals[:L],
            [self._inside(meta.geoms[lev].domain, plan.windows[lev])
             for lev in range(L)],
            [covered_mask_over(meta, lev, plan.windows[lev].grow(1))
             for lev in range(L)])

    def _spans(self, lev: int) -> Tuple[bool, bool, bool]:
        g = self.meta.geoms[lev]
        bbox = self.lmeta[lev].bbox
        return tuple(bool(g.is_periodic[d]) and bbox.lo[d] == g.domain.lo[d]
                     and bbox.hi[d] >= g.domain.hi[d] for d in range(3))


class HostFabs:
    """A window source of host FABs: ``fabs[lev][i]``, box i's ``[ncomp,
    *box.shape]`` array of the comps ``names``.  Each level of a window is
    assembled on the host from the boxes (and periodic images) that meet
    it, then every level copied to the shard's device once."""

    def __init__(self, names: Sequence[str], fabs):
        self.names, self.fabs = list(names), fabs

    def window_level(self, sd: ShardedDenseState, lev: int, w: Box, parts,
                     mask: np.ndarray, dev: torch.device) -> np.ndarray:
        """Level lev of a window of ``sd`` over w on the host, from the
        FABs of ``parts`` (``ShardedDenseState._boxes``); zero outside
        them."""
        # all comps in order as a slice: a view, not a copy
        sel = (slice(None) if sd._idx == list(range(len(self.names)))
               else sd._idx)
        host = np.zeros((len(sd.names),) + w.shape,
                        dtype=_np_dtype(sd.dtype))
        for i, sh, part in parts:
            src = sd.meta.bas[lev][i].shift(sh)
            host[(slice(None),) + _box_slices(part, w)] = \
                self.fabs[lev][i][(sel,) + _box_slices(part, src)]
        return host

    @staticmethod
    def window_data(levels: List[np.ndarray],
                    dev: torch.device) -> List[torch.Tensor]:
        """The assembled levels copied to ``dev`` (span ``shard.h2d``;
        counts ``shard.h2d_bytes``, nothing on the CPU)."""
        with span("shard.h2d"):
            data = [torch.from_numpy(h).to(dev) for h in levels]
        if dev.type != "cpu":
            count("shard.h2d_bytes", sum(h.nbytes for h in levels))
        return data


class ShardGather:
    """A sharded stage's output (``run_windows``): of each shard's output,
    the block it owns on each level (``plans[s].owned[l]``), a copy on the
    shard's own device, so that the window is freed.  It carries what
    ``Session.load`` checks: ``meta`` and the levels' ``lmeta``,
    ``names``, ``dtype`` and ``device``, the first shard's.

    Every consumer reads the parts where they lie.  A sharded stage cuts
    its windows from them on the cards (a window source, as
    :class:`HostFabs` is).  ``to_plotfile`` packs a box inside one block
    from that block on its card, and a box that straddles blocks on the
    first card, assembled there from each part; ``state()`` is the output
    as one state on the first card; ``level_fabs()`` copies each part to
    the host on its own.

    ``add``, ``to_plotfile``, ``state`` and ``level_fabs`` run in the span
    ``shard.gather``; the bytes of owned cells moved to another card or to
    the host count in ``shard.gather_bytes``."""

    def __init__(self, sd: ShardedDenseState):
        self.sd, self.meta, self.lmeta = sd, sd.meta, sd.lmeta
        self.device = sd.mesh.devices[0]
        self.names = self.dtype = self._nc = None
        self.parts: List[Optional[list]] = [None] * sd.mesh.size
        self._state = None

    def add(self, s: int, out: DenseAmrState) -> None:
        """Shard s's output over its windows (``out.data[l]`` covers
        ``windows[l]``; None where the shard computed no output): its owned
        blocks kept."""
        plan = self.sd.plans[s]
        with span("shard.gather"):
            if self.names is None:
                # the comps the data holds, which may outnumber the names
                self.names, self.dtype = list(out.names), out.dtype
                self._nc = out.data[0].shape[0]
            self.parts[s] = [
                None if own is None or data is None else data[
                    (slice(None),) + _box_slices(own, w)].clone(
                        memory_format=torch.contiguous_format)
                for own, data, w in zip(plan.owned, out.data, plan.windows)]

    def level_parts(self, lev: int) -> List[Tuple[Box, torch.Tensor]]:
        """(owned block, part) of every shard holding level ``lev``."""
        return [(plan.owned[lev], parts[lev])
                for plan, parts in zip(self.sd.plans, self.parts)
                if parts is not None and lev < len(parts)
                and parts[lev] is not None]

    # -- the output ----------------------------------------------------------
    def _pack(self, rec: PlotfileRecords, file) -> None:
        """Every box of the output into ``rec`` through ``file(lev, data,
        box, idx)`` (``rec.add``, or ``rec.start`` with its finish kept):
        the boxes inside one part packed from it, one pack a part and
        level, a box that straddles parts assembled on the first card.  A
        box the parts do not cover whole gets no record: the write
        raises."""
        meta, dev0 = self.meta, self.device
        item = self._nc * np.dtype(rec.dtype).itemsize
        for lev in range(meta.n_levels):
            parts = self.level_parts(lev)
            whole = [[] for _ in parts]
            for i, (b, pieces) in enumerate(_pieces(parts, meta.bas[lev])):
                if len(pieces) == 1 and pieces[0][1] == b:
                    whole[pieces[0][0]].append(i)
                    continue
                if sum(p.size for _, p in pieces) < b.size:
                    continue
                buf = torch.empty((self._nc,) + b.shape, dtype=self.dtype,
                                  device=dev0)
                for k, p in pieces:
                    own, part = parts[k]
                    buf[(slice(None),) + _box_slices(p, b)] = _moved(
                        part[(slice(None),) + _box_slices(p, own)], dev0)
                file(lev, buf, b, [i])
                if dev0.type != "cpu":
                    count("shard.gather_bytes", item * b.size)
            for (own, part), idx in zip(parts, whole):
                if not idx:
                    continue
                file(lev, part, own, idx)
                if part.device.type != "cpu":
                    count("shard.gather_bytes", item * sum(
                        meta.bas[lev][i].size for i in idx))

    def to_plotfile(self, path: str) -> None:
        """The output as a plotfile of float64 FABs, the bytes of
        ``DenseAmrState.to_plotfile`` of ``state()``."""
        with span("shard.gather"):
            rec = PlotfileRecords(self.meta, self.names)
            self._pack(rec, rec.add)
            rec.write(path)

    def to_plotfile_async(self, path: str, submit) -> None:
        """``to_plotfile`` with the host half on another thread, as
        ``DenseAmrState.to_plotfile_async``: every pack and its copy
        started here; ``submit`` gets the thunk that waits for each copy,
        files the records and writes."""
        pending = []
        with span("shard.gather"):
            rec = PlotfileRecords(self.meta, self.names)
            self._pack(rec, lambda *a: pending.append(rec.start(*a)))

        def write():
            for finish in pending:
                finish()
            rec.write(path)

        submit(write)

    def state(self) -> DenseAmrState:
        """The output as one state on ``device``: per level a zero tensor
        over the level's bbox with each owned block copied in.  Built on
        the first call, then kept."""
        if self._state is None:
            levels = []
            with span("shard.gather"):
                for lev, lm in enumerate(self.lmeta):
                    d = torch.zeros((self._nc,) + lm.bbox.shape,
                                    dtype=self.dtype, device=self.device)
                    for own, part in self.level_parts(lev):
                        d[(slice(None),) + _box_slices(own, lm.bbox)] = \
                            _moved(part, self.device)
                    levels.append(d)
            self._state = DenseAmrState(self.meta, self.names, levels,
                                        self.lmeta, self.device)
        return self._state

    def level_fabs(self) -> List[List[np.ndarray]]:
        """``DenseAmrState.level_fabs`` of ``state()``: each level's part
        copied to the host on its own (no stop on the first card), then
        each box's C-contiguous copy assembled from the parts."""
        out = []
        with span("shard.gather"):
            for lev in range(self.meta.n_levels):
                held = []
                for own, part in self.level_parts(lev):
                    if part.device.type != "cpu":
                        count("shard.gather_bytes",
                              part.numel() * part.element_size())
                    held.append((own, part.cpu().numpy()))
                fabs = []
                for b, pieces in _pieces(held, self.meta.bas[lev]):
                    fab = np.zeros((self._nc,) + b.shape,
                                   dtype=_np_dtype(self.dtype))
                    for k, p in pieces:
                        own, h = held[k]
                        fab[(slice(None),) + _box_slices(p, b)] = \
                            h[(slice(None),) + _box_slices(p, own)]
                    fabs.append(fab)
                out.append(fabs)
        return out

    # -- a window source -----------------------------------------------------
    def window_level(self, sd: ShardedDenseState, lev: int, w: Box, parts,
                     mask: np.ndarray, dev: torch.device) -> torch.Tensor:
        """Level lev of a window of ``sd`` over w on ``dev``, cut from the
        parts: the window's intersection with each part's owned block, and
        with each periodic image of it, one ``.to(dev)`` a comp
        (``shard.gather_bytes`` when it crosses cards; from the window's
        own card a strided copy, no temporary), then every cell outside
        the level's boxes (``mask`` False) zeroed, as
        ``HostFabs.window_level`` leaves it.  A non-trivial mask is copied
        to the card (``shard.h2d_bytes``)."""
        out = torch.zeros((len(sd.names),) + w.shape, dtype=sd.dtype,
                          device=dev)
        for sh in sd._shifts(lev):
            for own, part in self.level_parts(lev):
                home = own.shift(sh)
                piece = _isect(home, w)
                if piece is None:
                    continue
                dst, src = _box_slices(piece, w), _box_slices(piece, home)
                for k, c in enumerate(sd._idx):
                    out[(k,) + dst] = _moved(part[(c,) + src], dev, sd.dtype)
        if not mask.all():
            hole = torch.from_numpy(~mask).to(dev)
            if dev.type != "cpu":
                count("shard.h2d_bytes", mask.nbytes)
            out.masked_fill_(hole, 0)
        return out

    @staticmethod
    def window_data(levels: List[torch.Tensor],
                    dev: torch.device) -> List[torch.Tensor]:
        """The cut levels, on ``dev`` already (counts
        ``shard.device_windows``)."""
        count("shard.device_windows")
        return levels


def _pieces(parts, boxes):
    """Each box with (k, the box's piece in it) for every part k of
    ``parts`` ((owned block, data over it)) whose block meets it."""
    for b in boxes:
        yield b, [(k, c) for k, (own, _) in enumerate(parts)
                  if (c := _isect(own, b)) is not None]


def _moved(t: torch.Tensor, device: torch.device,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``t`` on ``device`` (in ``dtype``); a copy to another device counts
    in ``shard.gather_bytes``."""
    if t.device != device:
        count("shard.gather_bytes", t.numel() * t.element_size())
    return t.to(device, dtype)


def run_windows(sd: ShardedDenseState, fn: Callable[..., DenseAmrState],
                windows: Optional[list] = None) -> ShardGather:
    """``fn`` on every window, one after another, each output's owned
    blocks kept on its device (``ShardGather``) before the next window is
    built.  ``windows``: the argument of ``fn`` for each shard, built
    already (the windows a solve kept resident); each entry is dropped
    once visited."""
    out = ShardGather(sd)
    for s in range(sd.mesh.size):
        if windows is None:
            arg = sd.window(s)
        else:
            arg, windows[s] = windows[s], None
        with span("shard.run"):
            res = fn(arg)
        del arg
        out.add(s, res)
        del res
    return out
