"""Marching-cubes isosurface extraction on the dual grid of the AMR
hierarchy: the ``enum`` engine behind the ``isosurface`` tool (dense path).

Counterpart of ``peleanalysis_tpu/geom/marching_cubes.py`` with
``classify="enum"`` (``_build_enum_fn`` :654, ``extract_isosurface_enum``
:1163), itself the replacement for the reference's
Src/isosurface.cpp:1278-2269:

  * the dual grid's node coordinates are data: cell-centre coordinate fields
    filled with the same piecewise-constant fill as the state, so ghost and
    hole nodes collapse onto their coarse parents' centres and the
    coarse-fine seam is watertight by construction;
  * a node is a crossed dual-grid edge (lower cell, axis) of a level's grown
    volume that an active dual cell references.  An exclusive cumsum over the
    referenced flags numbers the nodes level by level, then axis 0, 1, 2,
    then by ascending flat index: no sort and no atomics, so the ids, and the
    MEF, are the JAX package's;
  * a fine level's ghost-ghost edges (class B) are identified with their
    coarse parent edges, which the coarse level then enumerates; periodic
    images fold onto their primary slots;
  * triangles come per active cell in ascending flat order, each cell's in
    the case table's order.

PyTorch has dynamic shapes, so the TPU engine's static-shape machinery is
not carried over (capacities, the counts probe and its retries, the packed
int32 result with 21-bit ids): active cells and nodes are compacted by
``searchsorted`` on the cumsums that number them, and nodes and elements
come to the host in one copy each.

Sparse refinement (``extract_isosurface_sparse``) runs the engine once on
the coarse levels and once a finest-level cluster with ``emit_levels`` and
``want_eids``, and merges the runs by global node keys.

``defer=True`` (a pipeline stage with write=0) keeps the nodes and elements
on the device and returns a :class:`DeferredSurface`: a downstream stream
stage copies only the seed xyz columns.

Not ported: the ``device``, ``fused`` and ``numpy`` engines, and the
canonical frames and batched clusters of the JAX sparse path.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..amr.cluster import coarse_only_state
from ..amr.dense import DenseAmrState
from ..amr.hierarchy import _periodic_shifts
from ..io.mef import MEF
from ..ops.dense_fill import fill_dense_multilevel
from ..ops.fill import default_bc
from ..parallel.cluster_shard import sharded_substates
from ..telemetry import count, span
from .mc_tables import CORNER_OFFSETS, CORNER_PAIRS, EDGE_TABLE, TRI_TABLE

_LEV_SHIFT = 54
_C_BITS = 18

# only the all-outside and all-inside cases cut no edge, so a dual cell is
# active iff its case is neither 0 nor 255 (no table lookup on the volume)
if set(np.nonzero(EDGE_TABLE == 0)[0]) != {0, 255}:
    raise ImportError("marching-cubes edge table: unexpected empty cases")

# per edge: its axis, its lower corner's offset, and the indices of its
# lower and upper corners in CORNER_OFFSETS
_E_AXIS = np.array([int(np.argmax(np.abs(CORNER_OFFSETS[b]
                                         - CORNER_OFFSETS[a])))
                    for a, b in CORNER_PAIRS])
_E_LOWER = np.minimum(CORNER_OFFSETS[CORNER_PAIRS[:, 0]],
                      CORNER_OFFSETS[CORNER_PAIRS[:, 1]])      # [12,3]


def _corner_index_of(off) -> int:
    return int(np.nonzero((CORNER_OFFSETS == off).all(axis=1))[0][0])


_E_LO_CORNER = np.array([_corner_index_of(_E_LOWER[e]) for e in range(12)])
_E_HI_CORNER = np.array([_corner_index_of(
    _E_LOWER[e] + np.eye(3, dtype=int)[_E_AXIS[e]]) for e in range(12)])
# [256, 5, 3] edge ids of each case's triangles, -1 past its count
_TRI_EDGES = TRI_TABLE[:, :15].reshape(256, 5, 3)


def _pack_key(lev: np.ndarray, gx, gy, gz) -> np.ndarray:
    return ((lev.astype(np.int64) + 1) << _LEV_SHIFT
            | (gx.astype(np.int64) << (2 * _C_BITS))
            | (gy.astype(np.int64) << _C_BITS)
            | gz.astype(np.int64))


# -- per-state inputs, built once per state -----------------------------------
def _cached(dstate: DenseAmrState, key, build):
    cache = dstate._iso_cache
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _coord_level(dstate: DenseAmrState, lev: int, win=None) -> torch.Tensor:
    """Level ``lev``'s ``[3, *bbox]`` cell-centre coordinates on the state's
    device: float64 on the host per axis, rounded to the state dtype, then
    broadcast.  A shard window (``win``) takes the global geometry, and a
    periodic image cell the coordinate of the cell it images, as the global
    fill gives it before the unwrap."""
    geom = dstate.meta.geoms[lev]
    bbox = dstate.lmeta[lev].bbox
    idx = [np.arange(bbox.lo[d], bbox.hi[d] + 1) for d in range(3)]
    if win is not None:
        geom = win.geoms[lev]
        idx = [win.wrap(lev, d, idx[d]) for d in range(3)]
    axes = [torch.from_numpy(
        geom.prob_lo[d] + (idx[d] - geom.domain.lo[d] + 0.5) * geom.dx[d])
            .to(dstate.device, dstate.dtype) for d in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


def _data_level(dstate: DenseAmrState, comps, lev: int,
                win=None) -> torch.Tensor:
    """``[coords | selected comps]`` of one level, ``[3 + nc, *bbox]``,
    concatenated once per (state, comps, level)."""
    return _cached(dstate, ("data", tuple(comps), lev), lambda: torch.cat(
        [_coord_level(dstate, lev, win), dstate.data[lev][list(comps)]]))


def _grown_masks(dstate: DenseAmrState, lev: int, win=None):
    """Host masks on the grown bbox: (covered_by_finer, in_level_padded).
    A shard window's (``win``) are the global run's: the global covered
    mask, and no in-level cell outside the global domain (its unrolled
    periodic images are the global run's grown ring)."""
    def build():
        if win is not None:
            return win.covered_ring[lev], np.pad(
                dstate.in_level_mask_np(lev) & win.in_domain[lev], 1)
        meta = dstate.meta
        gbox = dstate.lmeta[lev].bbox.grow(1)
        cov = np.zeros(gbox.shape, dtype=bool)
        if lev + 1 < meta.n_levels:
            per = meta.geoms[lev].is_periodic
            dom = meta.geoms[lev].domain
            for fb in meta.bas[lev + 1].coarsen(meta.ref_ratio[lev]):
                for sh in _periodic_shifts(per, dom):
                    isect = gbox.intersect(fb.shift(sh))
                    if not isect.is_empty():
                        cov[tuple(slice(isect.lo[d] - gbox.lo[d],
                                        isect.hi[d] - gbox.lo[d] + 1)
                                  for d in range(3))] = True
        return cov, np.pad(dstate.in_level_mask_np(lev), 1)
    return _cached(dstate, ("masks", lev), build)


def _corner_keys_at(dstate: DenseAmrState, lev: int, inlev_p: np.ndarray,
                    ii: np.ndarray, jj: np.ndarray, kk: np.ndarray,
                    win=None) -> np.ndarray:
    """Packed (level, global cell) keys for grown-bbox cell indices;
    collapsed ghost/hole corners are keyed by their coarse parent.  A
    shard window (``win``) keys by the global geometry."""
    meta = dstate.meta
    geom = meta.geoms[lev] if win is None else win.geoms[lev]
    dom = geom.domain
    gbox = dstate.lmeta[lev].bbox.grow(1)
    G = []
    for d, loc in enumerate((ii, jj, kk)):
        raw = loc + gbox.lo[d] - dom.lo[d]
        if geom.is_periodic[d]:
            G.append(raw % dom.shape[d])
        else:
            G.append(np.clip(raw, 0, dom.shape[d] - 1))
    lev_arr = np.full(ii.shape, lev)
    fine_key = _pack_key(lev_arr, *G)
    if lev == 0:
        return fine_key
    r = meta.ref_ratio[lev - 1]
    dom_c = dom.coarsen(r)
    Gc = [np.floor_divide(G[d] + dom.lo[d], r) - dom_c.lo[d]
          for d in range(3)]
    crse_key = _pack_key(lev_arr - 1, *Gc)
    return np.where(inlev_p[ii, jj, kk], fine_key, crse_key)


def _ok_mask(dstate: DenseAmrState, lev: int, win=None) -> torch.Tensor:
    """Iso-independent mask of the dual cells that may emit, on the device:
    no covered corner, at least one corner in the level, inside the
    (periodically grown) domain; in a shard window (``win``) also owned by
    the shard."""
    def build():
        geom = dstate.meta.geoms[lev]
        dom = geom.domain
        gbox = dstate.lmeta[lev].bbox.grow(1)
        cov, inlev_p = _grown_masks(dstate, lev, win)
        shp = tuple(s - 1 for s in cov.shape)
        ok = np.ones(shp, dtype=bool)
        touch = np.zeros(shp, dtype=bool)
        for o in CORNER_OFFSETS:
            sl = tuple(slice(o[d], cov.shape[d] - 1 + o[d]) for d in range(3))
            ok &= ~cov[sl]
            touch |= inlev_p[sl]
        for d in range(3):
            base = np.arange(gbox.lo[d], gbox.hi[d])
            per = geom.is_periodic[d]
            lo_ok = base >= (dom.lo[d] - 1 if per else dom.lo[d])
            hi_ok = base + 1 <= (dom.hi[d] + 1 if per else dom.hi[d])
            sh = [1, 1, 1]
            sh[d] = -1
            ok &= (lo_ok & hi_ok).reshape(sh)
            if win is not None:
                own_lo, own_hi = win.duals[lev]
                ok &= ((base >= own_lo[d]) & (base <= own_hi[d])).reshape(sh)
        return torch.from_numpy(ok & touch).to(dstate.device)
    return _cached(dstate, ("ok", lev), build)


def _inlev_dev(dstate: DenseAmrState, lev: int, win=None) -> torch.Tensor:
    return _cached(dstate, ("inlev", lev), lambda: torch.from_numpy(
        _grown_masks(dstate, lev, win)[1]).to(dstate.device))


def _unwraps(dstate: DenseAmrState, lev: int):
    """(comp d, index, +-L): periodic images of the ghost ring whose
    coordinate must move by a domain length (isosurface.cpp:1482-1507)."""
    geom = dstate.meta.geoms[lev]
    dom = geom.domain
    gbox = dstate.lmeta[lev].bbox.grow(1)
    out = []
    for d in range(3):
        if not geom.is_periodic[d]:
            continue
        L = float(geom.prob_hi[d] - geom.prob_lo[d])
        if gbox.lo[d] < dom.lo[d]:
            out.append((d, _axis_slice(d, 0, dom.lo[d] - gbox.lo[d]), -L))
        if gbox.hi[d] > dom.hi[d]:
            # every slot beyond the domain hi is a periodic image
            out.append((d, _axis_slice(d, dom.hi[d] + 1 - gbox.lo[d],
                                       gbox.shape[d]), L))
    return out


def _spans(dstate: DenseAmrState, lev: int):
    """Per dim (spans, N): the level covers the whole periodic domain along
    it, so the seam edges of its grown volume fold onto primary slots."""
    geom = dstate.meta.geoms[lev]
    bbox = dstate.lmeta[lev].bbox
    return tuple((bool(geom.is_periodic[d]) and bbox.lo[d] == geom.domain.lo[d]
                  and bbox.hi[d] >= geom.domain.hi[d], geom.domain.shape[d])
                 for d in range(3))


# -- volume masks -------------------------------------------------------------
def _axis_slice(d: int, start: int, stop: int):
    s = [slice(None)] * 3
    s[d] = slice(start, stop)
    return tuple(s)


def _classify(inside: torch.Tensor) -> torch.Tensor:
    """uint8 case index [S0-1, S1-1, S2-1] from the 8 corner flags
    (inside = value < isoVal, isosurface.cpp:747-755)."""
    inside = inside.to(torch.uint8)
    ci = None
    for b, (oi, oj, ok) in enumerate(CORNER_OFFSETS):
        term = inside[oi: inside.shape[0] - 1 + oi,
                      oj: inside.shape[1] - 1 + oj,
                      ok: inside.shape[2] - 1 + ok] << b
        ci = term if ci is None else ci | term
    return ci


def _edge_crossed(inside: torch.Tensor, a: int) -> torch.Tensor:
    n = inside.shape[a]
    return inside[_axis_slice(a, 0, n - 1)] ^ inside[_axis_slice(a, 1, n)]


def _ghost_pair(ghost: torch.Tensor, a: int) -> torch.Tensor:
    n = ghost.shape[a]
    return ghost[_axis_slice(a, 0, n - 1)] & ghost[_axis_slice(a, 1, n)]


def _dilate_active(act: torch.Tensor, a: int) -> torch.Tensor:
    """OR of the <= 4 dual cells around each axis-a edge.  act: dual cells
    [S-1]^3; the result has the axis-a edge volume's shape (S-1 along a, S
    along the others)."""
    p, q = [d for d in range(3) if d != a]
    shape = list(act.shape)
    shape[p] += 1
    shape[q] += 1
    out = torch.zeros(shape, dtype=torch.bool, device=act.device)
    for op in (0, 1):
        for oq in (0, 1):
            sl = [slice(None)] * 3
            sl[p] = slice(op, op + act.shape[p])
            sl[q] = slice(oq, oq + act.shape[q])
            out[tuple(sl)] |= act
    return out


def _fold_edge_mask(m: torch.Tensor, spans) -> torch.Tensor:
    """Fold periodic image slots onto their primaries and clear the images
    (in place)."""
    for d in range(3):
        span, N = spans[d]
        if not span:
            continue
        m[_axis_slice(d, N, N + 1)] |= m[_axis_slice(d, 0, 1)]
        m[_axis_slice(d, 0, 1)] = False
        if m.shape[d] > N + 1:           # a non-edge axis has slot N+1
            m[_axis_slice(d, 1, 2)] |= m[_axis_slice(d, N + 1, N + 2)]
            m[_axis_slice(d, N + 1, N + 2)] = False
    return m


def _fold_rank_vol(r: torch.Tensor, spans) -> None:
    """Give image slots of a rank volume their primaries' ranks (in
    place), so lookups need no coordinate remap."""
    for d in range(3):
        span, N = spans[d]
        if not span:
            continue
        r[_axis_slice(d, 0, 1)] = r[_axis_slice(d, N, N + 1)]
        if r.shape[d] > N + 1:
            r[_axis_slice(d, N + 1, N + 2)] = r[_axis_slice(d, 1, 2)]


def _coarsen_edge_mask(m: torch.Tensor, r: int, gbox_lo, cshape, cgbox_lo):
    """ANY-reduce a fine edge mask onto coarse edge slots (r-blocks aligned
    on global coordinates): (coarse mask, coarse slices), clipped to the
    coarse volume."""
    out = m
    starts = []
    for d in range(3):
        pad_lo = gbox_lo[d] % r
        pad_hi = (-(pad_lo + out.shape[d])) % r
        shape = list(out.shape)
        shape[d] += pad_lo + pad_hi
        padded = torch.zeros(shape, dtype=torch.bool, device=m.device)
        padded[_axis_slice(d, pad_lo, pad_lo + out.shape[d])] = out
        shape[d] //= r
        shape.insert(d + 1, r)
        out = padded.reshape(shape).any(dim=d + 1)
        starts.append((gbox_lo[d] - pad_lo) // r - cgbox_lo[d])
    slices = []
    for d in range(3):
        s0, s1 = starts[d], starts[d] + out.shape[d]
        if s0 < 0 or s1 > cshape[d]:
            # proper nesting keeps this in range; clipping keeps us safe
            lo_clip, hi_clip = max(0, -s0), max(0, s1 - cshape[d])
            out = out[_axis_slice(d, lo_clip, out.shape[d] - hi_clip)]
            s0, s1 = s0 + lo_clip, s1 - hi_clip
        slices.append(slice(s0, s1))
    return out, tuple(slices)


def _unravel(flat: torch.Tensor, shape):
    return (flat // (shape[1] * shape[2]), (flat // shape[2]) % shape[1],
            flat % shape[2])


# -- the engine ---------------------------------------------------------------
def _stage(name: str):
    """The span ``isosurface.<name>`` (a profiler range under a profiler)
    around one stage of the engine (fill, classify, masks, cumsum, compact,
    gather, copy)."""
    return span("isosurface." + name)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array; a copy from a card counts in ``d2h.bytes``."""
    if t.device.type != "cpu":
        count("d2h.bytes", t.numel() * t.element_size())
    return t.cpu().numpy()


def _node_keys(lev: int, a: int, cA, gbox_lo) -> torch.Tensor:
    """Global keys of nodes at grown-local lower cells cA on axis a:
    ``lev<<59 | a<<57 | i<<38 | j<<19 | k``, i, j, k the global cell + 1 (the
    JAX engine's ``_decode_packed`` keys)."""
    return _pack_keys(lev, a, [cA[d] + gbox_lo[d] for d in range(3)])


def _pack_keys(lev: int, a: int, pos) -> torch.Tensor:
    i, j, k = (p + 1 for p in pos)
    return (i << 38) | (j << 19) | k | ((lev << 59) | (a << 57))


def _canonical(win, lev: int, pos):
    """Global lower cells ``pos`` of a shard window's level-lev nodes,
    moved where the global run keeps them: along a periodic dim the global
    level spans, its seam folds (``_fold_edge_mask``) take the image slots
    -1 and N to N-1 and 0."""
    out = []
    for d in range(3):
        p = pos[d]
        if win.spans[lev][d]:
            dom = win.geoms[lev].domain
            p = torch.remainder(p - dom.lo[d], dom.shape[d]) + dom.lo[d]
        out.append(p)
    return out


def _unwrapped(win, lev: int, pos, row: torch.Tensor) -> torch.Tensor:
    """``row`` ([nf, n] corner values) with the periodic unwrap of the
    global run's grown ring (``_unwraps``) added to its coordinates at the
    global corner positions ``pos``."""
    geom = win.geoms[lev]
    for d in range(3):
        if not geom.is_periodic[d]:
            continue
        span = torch.full((), float(geom.prob_hi[d] - geom.prob_lo[d]),
                          dtype=row.dtype, device=row.device)
        dv = torch.where(pos[d] < geom.domain.lo[d], -span,
                         torch.where(pos[d] > geom.domain.hi[d], span,
                                     torch.zeros_like(span)))
        row[d] = torch.where(dv != 0, row[d] + dv, row[d])
    return row


def extract_isosurface_enum(dstate: DenseAmrState, iso_name: str,
                            iso_val: float, extra_names: Sequence[str] = (),
                            bc=None, label: Optional[str] = None,
                            emit_levels: Optional[Sequence[int]] = None,
                            want_eids: bool = False, defer: bool = False,
                            window=None):
    """Isosurface of ``iso_name`` at ``iso_val`` over all levels: a MEF with
    names ``X Y Z iso_name extra...`` (nodes in float64, computed in the
    state's dtype) whose node ids and elements are the JAX enum engine's.
    The host waits on the device four times: one read of all the counts,
    the triangle compaction and the two copies of the result.

    emit_levels restricts the triangles to those levels (the sparse path's
    cluster runs emit the finest); a level not emitted enumerates only the
    class-B seam parents that finer levels inject.  want_eids also returns
    each node's global key (``_node_keys``, int64 numpy) for the sparse
    path's merge of runs.  defer=True keeps the result on the device and
    returns a :class:`DeferredSurface` (not with want_eids: the sparse
    merge needs the keys on the host).

    ``window`` (a ``WindowInfo``, parallel/dense_shard.py) makes
    ``dstate`` a shard window: it emits the triangles of the dual cells it
    owns and returns ``(mef, keys, cells)``: its nodes keyed and valued as
    the global run keeps them (the seams folded by ``_canonical``, the
    coordinates unwrapped where the global ring is), and each triangle's
    dual cell as a key in the global run's order (``_merge_runs``)."""
    win = window
    if win is not None and defer:
        raise ValueError("defer is not supported with a window (the merge "
                         "of windows needs the keys on the host)")
    if defer and want_eids:
        raise ValueError("defer is not supported with want_eids (the "
                         "sparse merge needs the decoded edge ids)")
    meta = dstate.meta
    L = meta.n_levels
    emit = tuple(range(L)) if emit_levels is None else tuple(emit_levels)
    names = [iso_name] + [n for n in extra_names if n != iso_name]
    if bc is None:
        bc = default_bc(3)
    nf = 3 + len(names)
    dev = dstate.device
    inlevs = [_inlev_dev(dstate, lev, win) for lev in range(L)]
    spans = [_spans(dstate, lev) for lev in range(L)]
    rr = [meta.ref_ratio[lev - 1] if lev > 0 else 1 for lev in range(L)]
    gbox_los = [tuple(dstate.lmeta[lev].bbox.grow(1).lo) for lev in range(L)]

    with _stage("fill"):
        comps = [dstate.comp(n) for n in names]
        data_levels = [_data_level(dstate, comps, lev, win)
                       for lev in range(L)]
        masks = [dstate.in_level_mask(lev) for lev in range(L)]
        grown = fill_dense_multilevel(meta, dstate.lmeta, data_levels, masks,
                                      1, bc, "pc")
        for lev in range(L):
            # a window unwraps at the gather, where it knows each node's
            # global corner positions
            uw = _unwraps(dstate, lev) if win is None else None
            if uw:
                grown[lev] = grown[lev].clone()
                for d, sl, dv in uw:
                    grown[lev][(d,) + sl] += dv

    insides, acts, cis = {}, {}, {}
    with _stage("classify"):
        for lev in emit:
            inside = grown[lev][3] < iso_val
            ci = _classify(inside)
            insides[lev] = inside
            cis[lev] = ci
            acts[lev] = _ok_mask(dstate, lev, win) & (ci != 0) & (ci != 255)

    with _stage("masks"):
        # referenced crossings; refs[lev][a] = [own, class B]
        refs = []
        for lev in range(L):
            shape = grown[lev].shape[1:]
            if lev not in emit:
                # a level that emits no triangles enumerates ONLY the
                # class-B seam parents that finer levels inject below: its
                # own crossings would add nodes the global run does not
                # have (JAX :695-709)
                refs.append([[torch.zeros(
                    [n - (d == a) for d, n in enumerate(shape)],
                    dtype=torch.bool, device=dev), None] for a in range(3)])
                continue
            ghost = ~inlevs[lev]
            lev_refs = []
            for a in range(3):
                ref = (_edge_crossed(insides[lev], a)
                       & _dilate_active(acts[lev], a))
                if lev > 0:
                    gp = _ghost_pair(ghost, a)
                    lev_refs.append([ref & ~gp, ref & gp])
                else:
                    lev_refs.append([ref, None])
            refs.append(lev_refs)
        # class-B (ghost-ghost) seam edges become their coarse parents' nodes
        for lev in range(L - 1, 0, -1):
            for a in range(3):
                if refs[lev][a][1] is None:
                    continue
                ref_b = _fold_edge_mask(refs[lev][a][1], spans[lev])
                base = refs[lev - 1][a][0]
                co, slc = _coarsen_edge_mask(ref_b, rr[lev], gbox_los[lev],
                                             base.shape, gbox_los[lev - 1])
                base[slc] |= co
                refs[lev][a][1] = None
        refs = [[_fold_edge_mask(refs[lev][a][0], spans[lev])
                 for a in range(3)] for lev in range(L)]

    with _stage("cumsum"):
        # node ids: exclusive cumsum over each level's referenced edges,
        # axis after axis, offset by the previous levels' node counts
        rank_vols, node_incs, act_incs, parts = [], [], {}, []
        offset = torch.zeros((), dtype=torch.int32, device=dev)
        for lev in range(L):
            f = torch.cat([m.reshape(-1) for m in refs[lev]]).to(torch.int32)
            inc = torch.cumsum(f, 0, dtype=torch.int32)
            cs = inc - f + offset
            offset = offset + inc[-1]
            vols, p = [], 0
            for m in refs[lev]:
                v = cs[p: p + m.numel()].view(m.shape)
                _fold_rank_vol(v, spans[lev])
                vols.append(v)
                p += m.numel()
                parts.append(inc[p - 1])      # nodes through this axis
            rank_vols.append(vols)
            node_incs.append(inc)
        for lev in emit:
            act_incs[lev] = torch.cumsum(acts[lev].reshape(-1), 0,
                                         dtype=torch.int32)
            parts.append(act_incs[lev][-1])
        counts = torch.stack(parts).tolist()              # the one count read
    n_acts = dict(zip(emit, counts[3 * L:]))

    node_rows, node_keys, tri_nids, tri_valid, tri_cells = [], [], [], [], []
    tri_edges = _cached(dstate, "tri_edges",
                        lambda: torch.from_numpy(_TRI_EDGES).to(dev))
    for lev in range(L):
        through = [0] + counts[3 * lev: 3 * lev + 3]
        G = grown[lev]
        for a, m in enumerate(refs[lev]):
            with _stage("compact"):
                # flat index of the k-th referenced edge, ascending
                k = torch.arange(through[a] + 1, through[a + 1] + 1,
                                 dtype=torch.int32, device=dev)
                loc = (torch.searchsorted(node_incs[lev], k)
                       - sum(x.numel() for x in refs[lev][:a]))
            with _stage("gather"):
                cA = _unravel(loc, m.shape)
                cB = [cA[d] + 1 if d == a else cA[d] for d in range(3)]
                A = G[:, cA[0], cA[1], cA[2]]                 # [nf, n]
                B = G[:, cB[0], cB[1], cB[2]]
                if win is not None:
                    pA = _canonical(win, lev, [cA[d] + gbox_los[lev][d]
                                               for d in range(3)])
                    pB = [pA[d] + 1 if d == a else pA[d] for d in range(3)]
                    A = _unwrapped(win, lev, pA, A)
                    B = _unwrapped(win, lev, pB, B)
                    node_keys.append(_pack_keys(lev, a, pA))
                elif want_eids:
                    node_keys.append(_node_keys(lev, a, cA, gbox_los[lev]))
                fa, fb = A[3], B[3]
                denom = fb - fa
                t = torch.where(denom.abs() > 1e-30, (iso_val - fa)
                                / torch.where(denom == 0, 1.0, denom), 0.0)
                row = (A + t.clamp(0.0, 1.0)[None] * (B - A)).T
                row[:, 3] = iso_val   # the iso comp is isoVal by construction
                node_rows.append(row)                          # [n, nf]
        if lev not in emit:
            continue

        # elements: each active cell's 12 edges -> node ids -> triangles
        with _stage("compact"):
            k = torch.arange(1, n_acts[lev] + 1, dtype=torch.int32,
                             device=dev)
            idx = torch.searchsorted(act_incs[lev], k)
        with _stage("gather"):
            ai, aj, ak = _unravel(idx, acts[lev].shape)
            inl = inlevs[lev]
            gf = [inl[ai + int(o[0]), aj + int(o[1]), ak + int(o[2])]
                  for o in CORNER_OFFSETS]
            nid = []
            for e in range(12):
                a = int(_E_AXIS[e])
                c = (ai + int(_E_LOWER[e, 0]), aj + int(_E_LOWER[e, 1]),
                     ak + int(_E_LOWER[e, 2]))
                n_e = rank_vols[lev][a][c]
                if lev > 0:
                    sc = rank_vols[lev - 1][a].shape
                    u = [((c[d] + gbox_los[lev][d]) // rr[lev]
                          - gbox_los[lev - 1][d]).clamp(0, sc[d] - 1)
                         for d in range(3)]
                    class_b = ~gf[_E_LO_CORNER[e]] & ~gf[_E_HI_CORNER[e]]
                    n_e = torch.where(class_b,
                                      rank_vols[lev - 1][a][tuple(u)], n_e)
                nid.append(n_e)
            nid12 = torch.stack(nid, 1)                       # [n, 12]
            tri_e = tri_edges[cis[lev].reshape(-1)[idx].long()]   # [n, 5, 3]
            tri_valid.append(tri_e[..., 0] >= 0)
            if win is not None:
                cell = _pack_keys(lev, 0, [c.long() + gbox_los[lev][d]
                                           for d, c in enumerate(
                                               (ai, aj, ak))])
                tri_cells.append(cell[:, None].expand(-1, 5))
            tri_nids.append(torch.gather(
                nid12, 1, tri_e.clamp(min=0).reshape(-1, 15).long()
            ).reshape(-1, 5, 3))
    with _stage("compact"):
        elements = (torch.cat(tri_nids)[torch.cat(tri_valid)] if tri_nids
                    else torch.zeros((0, 3), dtype=torch.int32, device=dev))

    out_names = ["X", "Y", "Z"] + names
    if sum(counts[3 * lev + 2] for lev in range(L)) == 0:
        mef = MEF(label or "0", out_names, np.zeros((0, nf)),
                  np.zeros((0, 3), np.int32))
        if win is not None:
            return mef, np.zeros(0, np.int64), np.zeros(0, np.int64)
        return (mef, np.zeros(0, np.int64)) if want_eids else mef
    if defer:
        return DeferredSurface(label or "0", out_names, torch.cat(node_rows),
                               elements, counts=(
                                   sum(counts[3 * lev + 2]
                                       for lev in range(L)),
                                   int(elements.shape[0])))
    with _stage("copy"):
        nodes = _to_host(torch.cat(node_rows))
        elements = _to_host(elements)
        keys = _to_host(torch.cat(node_keys)) if node_keys else None
        if win is not None:
            cells = (_to_host(torch.cat(tri_cells)[torch.cat(tri_valid)])
                     if tri_cells else np.zeros(0, np.int64))
    mef = MEF(label or "0", out_names, nodes.astype(np.float64),
              elements.astype(np.int32))
    if win is not None:
        return mef, keys, cells
    return (mef, keys) if want_eids else mef


class DeferredSurface:
    """An enum-engine surface left on the device (counterpart of the JAX
    ``DeferredSurface``, ``geom/marching_cubes.py:930-972``).  ``n_nodes``
    and ``n_elts`` come from the engine's count read; ``positions()``
    copies the node xyz columns alone; ``to_mef()`` copies the rest once,
    keeps the MEF and drops the device tensors.  Duck-types ``MEF`` for
    downstream stages (positions, nodes, elements, names, n_nodes,
    n_elts); the copies equal the eager engine's MEF bitwise."""

    def __init__(self, label: str, names, nodes: torch.Tensor,
                 elements: torch.Tensor, counts):
        self.label = label
        self.names = list(names)
        self._nodes = nodes            # [n_nodes, nf] on the device
        self._elements = elements      # [n_elts, 3] int32 on the device
        self.n_nodes, self.n_elts = (int(c) for c in counts)
        self._xyz = None
        self._mef = None

    def positions(self) -> np.ndarray:
        if self._mef is not None:
            return self._mef.positions()
        if self._xyz is None:
            with _stage("copy"):
                self._xyz = _to_host(self._nodes[:, :3]).astype(np.float64)
        return self._xyz

    def to_mef(self) -> MEF:
        if self._mef is None:
            with _stage("copy"):
                nodes = _to_host(self._nodes)
                elements = _to_host(self._elements)
            self._mef = MEF(self.label, self.names, nodes.astype(np.float64),
                            elements.astype(np.int32))
            self._nodes = self._elements = self._xyz = None
        return self._mef

    @property
    def nodes(self) -> np.ndarray:
        return self.to_mef().nodes

    @property
    def elements(self) -> np.ndarray:
        return self.to_mef().elements


def _share_coarse_inputs(dst: DenseAmrState, base: DenseAmrState, comps,
                         levels) -> None:
    """Give ``dst`` the per-level inputs of ``base`` on ``levels`` (grown
    masks, ok mask, in-level mask, coordinates + comps): the coarse levels
    of a cluster substate and of the coarse-only state then see the GLOBAL
    covered masks (JAX :1610-1620, :1856-1860), else coarse triangles would
    be emitted under other clusters' fine regions; and every run uses one
    device copy of each."""
    for lev in levels:
        _ok_mask(base, lev)
        _inlev_dev(base, lev)
        _data_level(base, comps, lev)
        for key in (("masks", lev), ("ok", lev), ("inlev", lev),
                    ("data", tuple(comps), lev)):
            dst._iso_cache[key] = base._iso_cache[key]


def extract_isosurface_sparse(base: DenseAmrState, fin_fabs, iso_name: str,
                              iso_val: float,
                              extra_names: Sequence[str] = (), bc=None,
                              label: Optional[str] = None,
                              mesh=None) -> MEF:
    """Sparse refinement extraction (JAX :1753-1892): the finest level is
    processed as dense CLUSTERS (amr/cluster.py), so device memory scales
    with the coarse levels plus one cluster bbox instead of the finest
    union bbox.  ``base`` is the coarse-only state
    (``DenseAmrState.coarse_only``), ``fin_fabs`` the finest level's
    per-box host arrays.  One coarse pass emits levels 0..fin-1
    (fine-covered cells excluded by the full hierarchy's covered masks);
    each cluster's run, one after another, emits only its finest
    triangles.  Nodes are identified across runs by their global keys
    (``_node_keys``): ``np.unique`` orders them as the JAX merge does, a
    later run overwriting an earlier one's row for a repeated key, so the
    elements equal JAX's.  ``mesh``: the clusters dealt over its shards,
    each over the copy of ``base`` on its device
    (``parallel/cluster_shard.py``)."""
    fin = base.meta.n_levels - 1
    names = [iso_name] + [n for n in extra_names if n != iso_name]
    comps = [base.comp(n) for n in names]
    _, subs = sharded_substates(base, fin_fabs, mesh)
    bases = getattr(subs, "bases", {base.device: base})
    coarse = coarse_only_state(base)
    _share_coarse_inputs(coarse, base, comps, range(fin))
    results = [extract_isosurface_enum(coarse, iso_name, iso_val,
                                       extra_names, bc, label,
                                       want_eids=True)]
    del coarse
    for sub in subs:
        _share_coarse_inputs(sub, bases[sub.device], comps, range(fin))
        results.append(extract_isosurface_enum(
            sub, iso_name, iso_val, extra_names, bc, label,
            emit_levels=(fin,), want_eids=True))
        del sub
    return _merge_runs(results, label)


def _merge_runs(results, label: Optional[str] = None,
                cells=None) -> MEF:
    """One MEF from ``(mef, keys)`` runs: nodes ordered by key
    (``np.unique``), a later run's row overwriting an earlier one's for a
    repeated key, each run's elements renumbered.  With ``cells`` (the
    runs of shard windows: each run's triangles' dual-cell keys), the
    triangles go in the order of their dual cells' keys (a stable sort
    keeps a cell's in the case table's order): the global run's order."""
    uniq, inv = np.unique(np.concatenate([r[1] for r in results]),
                          return_inverse=True)
    nodes = np.zeros((len(uniq), results[0][0].nodes.shape[1]))
    elements, off = [], 0
    for mef, keys in results:
        gid = inv[off: off + len(keys)]
        nodes[gid] = mef.nodes
        elements.append(gid[mef.elements])
        off += len(keys)
    elements = np.concatenate(elements).astype(np.int32)
    if cells is not None:
        elements = elements[np.argsort(np.concatenate(cells),
                                       kind="stable")]
    return MEF(label or "0", results[0][0].names, nodes, elements)


def extract_isosurface_windows(windows, iso_name: str, iso_val: float,
                               extra_names: Sequence[str] = (), bc=None,
                               label: Optional[str] = None) -> MEF:
    """The isosurface over a hierarchy cut into shard windows
    (``parallel/dense_shard.py`` ``ShardedDenseState`` with
    ``ISO_HALO``): each window, built on its shard's device when visited,
    emits the triangles of the dual cells its shard owns; the runs merge
    by global node key and dual-cell order into the unsharded run's MEF."""
    results, cells = [], []
    for s, win in windows:
        mef, keys, cell = extract_isosurface_enum(
            win, iso_name, iso_val, extra_names, bc, label,
            window=windows.window_info(s))
        results.append((mef, keys))
        cells.append(cell)
        del win
    return _merge_runs(results, label, cells)


def check_engine(classify: str) -> None:
    """Refuse an engine other than enum, the only one ported."""
    if classify != "enum":
        raise NotImplementedError(
            f"engine={classify}: only the enum engine is ported; the device, "
            "fused and numpy engines are not to be ported (ROADMAP.md Queue 1 "
            "item 2)")


def extract_isosurface(dstate: DenseAmrState, iso_name: str, iso_val: float,
                       extra_names: Sequence[str] = (), bc=None,
                       label: Optional[str] = None, classify: str = "enum",
                       defer: bool = False) -> MEF:
    """Marching-cubes isosurface over all levels -> MEF, through the enum
    engine (the only engine ported); defer=True returns a
    :class:`DeferredSurface`."""
    check_engine(classify)
    return extract_isosurface_enum(dstate, iso_name, iso_val, extra_names,
                                   bc, label, defer=defer)


def surface_area(mef: MEF) -> float:
    """computeArea analog (isosurface.cpp:2237-2264)."""
    return mef.total_area()
