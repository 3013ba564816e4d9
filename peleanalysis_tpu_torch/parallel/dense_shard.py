"""Domain decomposition of a dense hierarchy over a spatial mesh: deep-halo
windows.

Counterpart of ``peleanalysis_tpu/parallel/dense_shard.py``.  The JAX
package shards every level array over a ``jax.sharding`` mesh and lets
GSPMD insert the halo collectives into each slice of the fill and the
stencils.  PyTorch has no partitioner, and a halo exchange before each of
a curvature call's ~950 kernels would mean rewriting the tested
single-device engine.  So each shard gets one WINDOW instead: per level,
the cells it owns plus a halo as deep as the tool's whole chain of ghost
fills and stencils, assembled straight from the host FABs on the shard's
device.  The shard runs the single-device function on its window and keeps
only its own cells.  A cell farther than the halo from a window's edge is
computed exactly as in the global run, whatever the fill puts at that
edge, so the files are the unsharded run's, byte for byte.

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

``pad_state_to`` / ``pad_state_divisible`` exist for XLA's divisibility and
for ``shape_bucket=`` (refused): they have no counterpart.  The composite
smoothing solve is elliptic, so no finite halo makes a window exact:
``do_smooth=1`` with ``ndevices>1`` and DIM=2 plotfiles are refused
(ROADMAP.md Queue 1 item 9b).
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
from .mesh import Mesh, shard_devices

SPATIAL_AXES = ("x", "y", "z")
# the refusal's pointer for what this slice leaves out
ITEM_9B = "ROADMAP.md Queue 1 item 9b"
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


def refuse_unsharded(what: str) -> None:
    raise NotImplementedError(
        f"{what} with ndevices>1 is not ported yet ({ITEM_9B})")


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
    """A hierarchy (host FABs) cut into one window a shard over ``mesh``,
    each built on its shard's device when visited (``window(s)`` or
    iteration) and held only by the caller.  The counterpart of the JAX
    ``shard_dense_state``."""

    def __init__(self, meta: AmrMeta, names: Sequence[str], fabs, mesh: Mesh,
                 halo: Halo, dtype: torch.dtype):
        if meta.ndim2:
            refuse_unsharded("a DIM=2 plotfile")
        axes = [SPATIAL_AXES.index(a) for a in mesh.axis_names]
        self.meta, self.names, self.fabs = meta, list(names), fabs
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
    def _level_block(self, b0: Box, lev: int) -> Box:
        b = b0
        for r in self.meta.ref_ratio[:lev]:
            b = b.refine(r)
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
        r = self.meta.ref_ratio[lev - 1]
        o = [v % r for v in self.lmeta[lev].bbox.lo]
        return Box(tuple((w.lo[d] - o[d]) // r * r + o[d] for d in range(3)),
                   tuple(-(-(w.hi[d] + 1 - o[d]) // r) * r + o[d] - 1
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
                meta.ref_ratio[lev - 1]).grow(1), self.lmeta[lev].bbox)

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
                        meta.ref_ratio[lev]).grow(halo.reach))
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
        box of the level or periodic image of one that meets w."""
        out = []
        shifts = self._shifts(lev)
        for i, b in enumerate(self.meta.bas[lev]):
            for sh in shifts:
                part = _isect(w, b.shift(sh))
                if part is not None:
                    out.append((i, sh, part))
        return out

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
        for r in self.meta.ref_ratio[:lev]:
            dom = dom.refine(r)
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
        """Shard s's window as a dense state on its device: each level
        assembled on the host from the boxes (and periodic images) that
        meet it, copied once; its in-level and covered masks the global
        ones."""
        plan = self.plans[s]
        meta = self.meta
        dev = self.mesh.devices[s]
        np_dt = _np_dtype(self.dtype)
        L = plan.n_levels
        geoms = [self._geometry(plan, lev) for lev in range(L)]
        bas, data, inlev = [], [], []
        for lev in range(L):
            w = plan.windows[lev]
            host = np.zeros((len(self.names),) + w.shape, dtype=np_dt)
            mask = np.zeros(w.shape, dtype=bool)
            parts = self._boxes(lev, w)
            for i, sh, part in parts:
                src = meta.bas[lev][i].shift(sh)
                host[(slice(None),) + _box_slices(part, w)] = \
                    self.fabs[lev][i][(slice(None),)
                                      + _box_slices(part, src)]
                mask[_box_slices(part, w)] = True
            bas.append(BoxArray([p for _, _, p in parts]))
            data.append(torch.from_numpy(host).to(dev))
            inlev.append(mask)
        wmeta = AmrMeta(geoms, bas, list(meta.ref_ratio[: L - 1]), meta.time,
                        meta.level_steps[:L] if meta.level_steps else None,
                        meta.ndim2)
        lmeta = [DenseLevelMeta(plan.windows[lev], geoms[lev])
                 for lev in range(L)]
        ds = DenseAmrState(wmeta, self.names, data, lmeta, dev)
        for lev in range(L):
            ds._in_level_np[lev] = inlev[lev]
            # no cell outside the global bbox is covered, as none is in the
            # global run: its flux matching sees the bbox's edge there
            ds._covered_np[lev] = covered_mask_over(meta, lev,
                                                    plan.windows[lev]) \
                & self._inside(self.lmeta[lev].bbox, plan.windows[lev])
        return ds

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


class ShardGather:
    """The owned cells of each shard's output, gathered.

    Without ``device``: into one plotfile (``PlotfileRecords``): a box
    inside one shard's block is packed straight out of that shard's
    output; a box that straddles blocks is assembled on the first shard's
    device from each owner's part (one ``.to`` a part) and packed there.
    With ``device``: into one ``DenseAmrState`` on it (a pipeline stage's
    registered output), each shard's owned cells copied with one ``.to``
    a level."""

    def __init__(self, sd: ShardedDenseState, device=None,
                 dtype=np.float64):
        self.sd = sd
        self.device = None if device is None else torch.device(device)
        self.dtype = dtype
        self.names = None
        self._records = None
        self._levels = None
        self._straddle: dict = {}

    def add(self, s: int, out: DenseAmrState) -> None:
        """Shard s's output over its windows (``out.data[l]`` covers
        ``windows[l]``; None where the shard computed no output)."""
        sd, plan = self.sd, self.sd.plans[s]
        meta = sd.meta
        if self.names is None:
            self.names = list(out.names)
            if self.device is None:
                self._records = PlotfileRecords(meta, self.names, self.dtype)
            else:
                self._levels = [None] * meta.n_levels
        for lev in range(plan.n_levels):
            own = plan.owned[lev]
            data = out.data[lev]
            if own is None or data is None:
                continue
            w = plan.windows[lev]
            if self.device is not None:
                self._add_state(lev, data, w, own)
                continue
            block = plan.blocks[lev]
            whole = []
            for i, b in enumerate(meta.bas[lev]):
                if block.contains_box(b):
                    whole.append(i)
                    continue
                part = _isect(block, b)
                if part is not None:
                    self._add_part(lev, i, b, data, w, part)
            if whole:
                self._records.add(lev, data, w, whole)

    def _add_part(self, lev, i, b, data, w, part) -> None:
        dev0 = self.sd.mesh.devices[0]
        buf, left = self._straddle.get((lev, i), (None, b.size))
        if buf is None:
            buf = torch.empty((data.shape[0],) + b.shape, dtype=data.dtype,
                              device=dev0)
        buf[(slice(None),) + _box_slices(part, b)] = \
            data[(slice(None),) + _box_slices(part, w)].to(dev0)
        left -= part.size
        if left:
            self._straddle[(lev, i)] = (buf, left)
            return
        self._straddle.pop((lev, i), None)
        self._records.add(lev, buf, b, [i])

    def _add_state(self, lev, data, w, own) -> None:
        bbox = self.sd.lmeta[lev].bbox
        if self._levels[lev] is None:
            self._levels[lev] = torch.zeros(
                (data.shape[0],) + bbox.shape, dtype=data.dtype,
                device=self.device)
        self._levels[lev][(slice(None),) + _box_slices(own, bbox)] = \
            data[(slice(None),) + _box_slices(own, w)].to(self.device)

    def write(self, path: str) -> None:
        if self._straddle:
            raise ValueError(f"boxes {sorted(self._straddle)[:4]} only "
                             "partly gathered")
        self._records.write(path)

    def state(self) -> DenseAmrState:
        """The gathered output as one state on ``device``."""
        sd = self.sd
        return DenseAmrState(sd.meta, self.names, self._levels, sd.lmeta,
                             self.device)


def run_windows(sd: ShardedDenseState,
                fn: Callable[[DenseAmrState], DenseAmrState],
                device=None) -> ShardGather:
    """``fn`` on every window, one after another, each output's owned cells
    gathered (``ShardGather``) before the next window is built."""
    out = ShardGather(sd, device)
    for s, win in sd:
        out.add(s, fn(win))
        del win
    return out
