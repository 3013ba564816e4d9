"""Marching-squares iso-line extraction for DIM=2 plotfiles: the 2-D path of
the reference's isosurface tool (Segmentise + MakeCLines polyline assembly,
Src/isosurface.cpp:303-410, 1159-1271, 1571-1580).

Counterpart of ``peleanalysis_tpu/geom/marching_squares.py``.  DIM=2
plotfiles are promoted in memory to nz=1 3-D arrays (``io/plotfile.py``
``promote_2d``), so the dense fill, the grown-bbox masks and the integer
edge keys of the 3-D engine apply; the per-dual-cell segments are found on
the host (DIM=2 levels are small).

Over shard windows (``extract_isolines_windows``, the windows of
``parallel/dense_shard.py`` with ``ISO_HALO``) each window emits the
segments of the dual cells its shard owns, keyed by the global geometry
and each tagged with its place in the one-device run's order (level,
segment of the cell, dual cell); the merge sorts them into that order and
numbers the nodes as one device does, so the MEF is byte-equal.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..amr.dense import DenseAmrState
from ..io.mef import MEF
from ..parallel.dense_shard import ShardedDenseState
from ..ops.dense_fill import fill_dense_multilevel
from ..ops.fill import default_bc
from .marching_cubes import _coord_level, _corner_keys_at, _grown_masks

# corner offsets in (i,j): c0..c3 counter-clockwise
SQ_CORNERS = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], dtype=np.int64)
# edge e connects SQ_EDGES[e]
SQ_EDGES = np.array([(0, 1), (1, 2), (2, 3), (3, 0)], dtype=np.int64)
# segments (pairs of crossed edges) per 4-bit case; cases 5/10 take the
# standard disambiguation (two separate corners)
SEG_TABLE = {
    0: [], 15: [],
    1: [(3, 0)], 14: [(0, 3)],
    2: [(0, 1)], 13: [(1, 0)],
    4: [(1, 2)], 11: [(2, 1)],
    8: [(2, 3)], 7: [(3, 2)],
    3: [(3, 1)], 12: [(1, 3)],
    6: [(0, 2)], 9: [(2, 0)],
    5: [(3, 0), (1, 2)],
    10: [(0, 1), (2, 3)],
}


def extract_isolines(
    dstate: DenseAmrState,
    iso_name: str,
    iso_val: float,
    extra_names: Sequence[str] = (),
    bc=None,
    label: str = "0",
    window=None,
) -> MEF:
    """Iso-lines over all levels of a promoted-2D state -> segment MEF
    (names X Y + fields; elements are 2-node segments).  ``window`` (a
    ``WindowInfo``) makes ``dstate`` a shard window: it returns the
    segments of the dual cells its shard owns as ``(keys, values,
    order)`` for ``extract_isolines_windows``."""
    win = window
    meta = dstate.meta
    names = [iso_name] + [n for n in extra_names if n != iso_name]
    comps = [dstate.comp(n) for n in names]
    if bc is None:
        bc = default_bc(3)
    coord_levels = [_coord_level(dstate, lev, win)
                    for lev in range(dstate.meta.n_levels)]
    data_levels = [torch.cat([coord_levels[lev][:2], dstate.data[lev][comps]])
                   for lev in range(meta.n_levels)]
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]
    grown_all = fill_dense_multilevel(meta, dstate.lmeta, data_levels, masks,
                                      1, bc, "pc")
    all_keys, all_vals, all_order = [], [], []
    nf = 2 + len(names)
    for lev in range(meta.n_levels):
        # z mid plane, to the host in float64
        g = grown_all[lev][:, :, :, 1].cpu().numpy().astype(np.float64)
        geom = meta.geoms[lev] if win is None else win.geoms[lev]
        dom = geom.domain
        gbox = dstate.lmeta[lev].bbox.grow(1)
        cov, inlev_p = _grown_masks(dstate, lev, win)
        cov2, inlev2 = cov[:, :, 1], inlev_p[:, :, 1]
        f = g[2]  # iso field is comp 2 (after X,Y)

        inside = (f < iso_val).astype(np.int32)
        case = np.zeros((f.shape[0] - 1, f.shape[1] - 1), dtype=np.int32)
        for b, (oi, oj) in enumerate(SQ_CORNERS):
            case |= (inside[oi: f.shape[0] - 1 + oi,
                            oj: f.shape[1] - 1 + oj] << b)

        ok = np.ones(case.shape, dtype=bool)
        touch = np.zeros(case.shape, dtype=bool)
        for (oi, oj) in SQ_CORNERS:
            sl = (slice(oi, cov2.shape[0] - 1 + oi),
                  slice(oj, cov2.shape[1] - 1 + oj))
            ok &= ~cov2[sl]
            touch |= inlev2[sl]
        for d in range(2):
            base = np.arange(gbox.lo[d], gbox.hi[d])
            lo_ok = base >= (dom.lo[d] - 1 if geom.is_periodic[d]
                             else dom.lo[d])
            hi_ok = base + 1 <= (dom.hi[d] + 1 if geom.is_periodic[d]
                                 else dom.hi[d])
            sh = [1, 1]
            sh[d] = -1
            ok &= (lo_ok & hi_ok).reshape(sh)
            if win is not None:
                own_lo, own_hi = win.duals[lev]
                ok &= ((base >= own_lo[d]) & (base <= own_hi[d])).reshape(sh)
        active = ok & touch & (case > 0) & (case < 15)
        ai, aj = np.nonzero(active)
        if len(ai) == 0:
            continue
        ca = case[ai, aj]

        # corner values / keys / data
        cf = np.empty((4, len(ai)))
        ck = np.empty((4, len(ai)), dtype=np.int64)
        cd = np.empty((4, len(ai), nf))
        for b, (oi, oj) in enumerate(SQ_CORNERS):
            ii, jj = ai + oi, aj + oj
            cf[b] = f[ii, jj]
            ck[b] = _corner_keys_at(dstate, lev, inlev_p, ii, jj,
                                    np.ones_like(ii), win)
            cd[b] = np.moveaxis(g[:, ii, jj], 0, -1)

        ekeys = np.empty((len(ai), 4, 2), dtype=np.int64)
        evals = np.empty((len(ai), 4, nf))
        for e, (a, b) in enumerate(SQ_EDGES):
            fa, fb = cf[a], cf[b]
            denom = np.where(np.abs(fb - fa) > 1e-300, fb - fa, 1.0)
            t = np.clip((iso_val - fa) / denom, 0.0, 1.0)
            evals[:, e] = cd[a] + t[:, None] * (cd[b] - cd[a])
            ekeys[:, e, 0] = np.minimum(ck[a], ck[b])
            ekeys[:, e, 1] = np.maximum(ck[a], ck[b])

        # segments per case (at most 2)
        for which in (0, 1):
            has = np.array([len(SEG_TABLE[c]) > which for c in ca])
            if not has.any():
                continue
            sel = np.nonzero(has)[0]
            e0 = np.array([SEG_TABLE[c][which][0] for c in ca[sel]])
            e1 = np.array([SEG_TABLE[c][which][1] for c in ca[sel]])
            all_keys.append(np.stack([ekeys[sel, e0], ekeys[sel, e1]],
                                     axis=1))
            all_vals.append(np.stack([evals[sel, e0], evals[sel, e1]],
                                     axis=1))
            if win is not None:
                # the one-device order: level, segment of the cell, dual
                # cell in raster order of the global grown bbox
                gi = ai[sel].astype(np.int64) + gbox.lo[0] + 1
                gj = aj[sel].astype(np.int64) + gbox.lo[1] + 1
                all_order.append((lev << 59) | (which << 57) | (gi << 38)
                                 | (gj << 19))

    if win is not None:
        if not all_keys:
            return (np.zeros((0, 2, 2), np.int64), np.zeros((0, 2, nf)),
                    np.zeros(0, np.int64))
        return (np.concatenate(all_keys), np.concatenate(all_vals),
                np.concatenate(all_order))
    return _segments_mef(label, names, nf, all_keys, all_vals)


def _segments_mef(label, names, nf, all_keys, all_vals) -> MEF:
    """The MEF of segments in emission order: nodes numbered by their
    sorted keys, each valued by the first segment that reaches it."""
    out_names = ["X", "Y"] + names
    if not all_keys:
        return MEF(label, out_names, np.zeros((0, nf)),
                   np.zeros((0, 2), np.int32))
    seg_keys = np.concatenate(all_keys)
    seg_vals = np.concatenate(all_vals)
    flat = seg_keys.reshape(-1, 2)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    first = np.full(len(uniq), len(flat), dtype=np.int64)
    np.minimum.at(first, inv, np.arange(len(flat)))
    nodes = seg_vals.reshape(-1, nf)[first]
    elements = inv.reshape(-1, 2).astype(np.int32)
    return MEF(label, out_names, nodes, elements)


def extract_isolines_windows(sd: ShardedDenseState, iso_name: str,
                             iso_val: float, extra_names: Sequence[str] = (),
                             bc=None, label: str = "0") -> MEF:
    """``extract_isolines`` over the shard windows of ``sd`` (``ISO_HALO``),
    each built on its shard's device when visited: every window's
    segments, sorted into the one-device run's order."""
    keys, vals, order = [], [], []
    for s, win in sd:
        k, v, o = extract_isolines(win, iso_name, iso_val, extra_names, bc,
                                   label, window=sd.window_info(s))
        keys.append(k)
        vals.append(v)
        order.append(o)
        del win
    names = [iso_name] + [n for n in extra_names if n != iso_name]
    perm = np.argsort(np.concatenate(order), kind="stable")
    k, v = np.concatenate(keys)[perm], np.concatenate(vals)[perm]
    return _segments_mef(label, names, 2 + len(names),
                         [k] if len(k) else [], [v])
