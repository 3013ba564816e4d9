"""Ghost fill for the dense level representation (plain PyTorch).

Counterpart of ``peleanalysis_tpu/ops/dense_fill.py``: slices, concats and
fixed-weight separable upsamples.  Semantics follow FillPatchTwoLevels +
PCInterp / CellBilinear and the physical-BC conventions of the reference
(grad.cpp:136-144, isosurface.cpp:1509-1527, stream.cpp:860-874).

The arithmetic is written in the JAX version's order so that float32 results
round the same way; weights multiply as Python floats, which PyTorch rounds
to the tensor dtype first, as ``jnp.asarray(w, dtype)`` does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..amr.box import Box
from ..amr.geometry import Geometry
from ..telemetry import span
from .fill import BCSpec, FOEXTRAP, REFLECT_EVEN, REFLECT_ODD, default_bc


def _ax(a: torch.Tensor, d: int) -> int:
    return a.ndim - 3 + d


def _slc(a: torch.Tensor, d: int, sl: slice) -> torch.Tensor:
    idx = [slice(None)] * a.ndim
    idx[_ax(a, d)] = sl
    return a[tuple(idx)]


def _index(a: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=a.device)


def _grow_axis_asym(a: torch.Tensor, d: int, g_lo: int, g_hi: int,
                    lo_mode: str, hi_mode: str,
                    periodic: bool) -> torch.Tensor:
    """Extend ``a`` by g_lo / g_hi ghost layers along spatial dim d (level-0
    BC fill).  Assumes the array spans the full domain along periodic
    dims."""
    if g_lo == 0 and g_hi == 0:
        return a
    ax = _ax(a, d)
    n = a.shape[ax]
    if periodic:
        # a ghost band wider than the domain extent wraps more than once: a
        # single slice would clip, so gather by mod index instead
        def wrap(g, is_lo):
            if g <= n:
                return _slc(a, d, slice(-g, None) if is_lo else slice(0, g))
            idx = (np.arange(-g, 0) if is_lo else np.arange(n, n + g)) % n
            return torch.index_select(a, ax, _index(a, idx))

        lo = wrap(g_lo, True) if g_lo else None
        hi = wrap(g_hi, False) if g_hi else None
    else:
        def side(mode, g, is_lo):
            if mode == FOEXTRAP:
                edge = _slc(a, d, slice(0, 1) if is_lo else slice(-1, None))
                reps = [1] * a.ndim
                reps[ax] = g
                return edge.repeat(*reps)
            if mode in (REFLECT_EVEN, REFLECT_ODD):
                if g > n:
                    raise ValueError(
                        f"reflecting BC needs ghost width {g} <= the "
                        f"level-0 extent {n} along dim {d}")
                blk = _slc(a, d, slice(0, g) if is_lo else slice(-g, None))
                blk = torch.flip(blk, dims=(ax,))
                return -blk if mode == REFLECT_ODD else blk
            raise ValueError(f"unknown BC mode {mode}")

        lo = side(lo_mode, g_lo, True) if g_lo else None
        hi = side(hi_mode, g_hi, False) if g_hi else None
    parts = [p for p in (lo, a, hi) if p is not None]
    return torch.cat(parts, dim=ax) if len(parts) > 1 else a


def _grow_level0(data: torch.Tensor, bbox: Box, geom: Geometry, g: int,
                 bc: BCSpec) -> torch.Tensor:
    """Grow a level-0 array by g ghost layers from the domain edges (a bbox
    larger than the domain is sliced back to it first).  Result covers
    bbox.grow(g)."""
    dom = geom.domain
    out = data
    for d in range(3):
        pad_lo = dom.lo[d] - bbox.lo[d]
        pad_hi = bbox.hi[d] - dom.hi[d]
        if pad_lo < 0 or pad_hi < 0:
            raise ValueError("level 0 must cover the domain")
        if pad_lo or pad_hi:
            ax = _ax(out, d)
            out = _slc(out, d, slice(pad_lo, out.shape[ax] - pad_hi))
        out = _grow_axis_asym(out, d, g + pad_lo, g + pad_hi,
                              bc[d][0], bc[d][1], geom.is_periodic[d])
    return out


def _upsample_axis(c: torch.Tensor, d: int, r: int, interp) -> torch.Tensor:
    """Refine along dim d by factor r.  Fine center sits at coarse coord
    (p+0.5)/r - 0.5 relative to its parent.
      pc:        repeat (PCInterp)
      linear:    2-point lerp (CellBilinear weights)
      quadratic: 3-point Lagrange through parent±1 (CellQuadratic analog)
    Edges are clamped; callers provide one spare coarse cell so clamped
    values are sliced away."""
    ax = _ax(c, d)
    linear = interp is True or interp == "linear"
    quad = interp == "quadratic"
    if not (linear or quad):
        return torch.repeat_interleave(c, r, dim=ax)
    c_m1 = torch.cat([_slc(c, d, slice(0, 1)), _slc(c, d, slice(0, -1))],
                     dim=ax)
    c_p1 = torch.cat([_slc(c, d, slice(1, None)), _slc(c, d, slice(-1, None))],
                     dim=ax)
    phases = []
    for p in range(r):
        off = (p + 0.5) / r - 0.5
        if quad:
            wl = off * (off - 1.0) / 2.0
            wc = (1.0 - off) * (1.0 + off)
            wr = off * (off + 1.0) / 2.0
            phases.append(c_m1 * wl + c * wc + c_p1 * wr)
        elif off < 0:
            w = off + 1.0  # weight on c; (1-w) on c[i-1]
            phases.append(c * w + c_m1 * (1.0 - w))
        else:
            w = off      # weight on c[i+1]
            phases.append(c * (1.0 - w) + c_p1 * w)
    out = torch.stack(phases, dim=ax + 1)
    shape = list(c.shape)
    shape[ax] = shape[ax] * r
    return out.reshape(shape)


def _bc_block(inner: torch.Tensor, d: int, n: int, mode: str, is_lo: bool,
              ax: int) -> torch.Tensor:
    if mode == FOEXTRAP:
        edge = _slc(inner, d, slice(0, 1) if is_lo else slice(-1, None))
        reps = [1] * inner.ndim
        reps[ax] = n
        return edge.repeat(*reps)
    if mode in (REFLECT_EVEN, REFLECT_ODD):
        blk = _slc(inner, d, slice(0, n) if is_lo else slice(-n, None))
        blk = torch.flip(blk, dims=(ax,))
        return -blk if mode == REFLECT_ODD else blk
    raise ValueError(f"unknown BC mode {mode}")


def _apply_exterior_bc(grown: torch.Tensor, gbox: Box, geom: Geometry,
                       bc: BCSpec) -> torch.Tensor:
    """Overwrite layers of ``grown`` (covering gbox) that lie outside the
    physical domain with BC-mapped copies of in-domain data.  Periodic dims
    are skipped (they wrapped at the coarse level already)."""
    dom = geom.domain
    for d in range(3):
        if geom.is_periodic[d]:
            continue
        n_lo = max(0, dom.lo[d] - gbox.lo[d])
        n_hi = max(0, gbox.hi[d] - dom.hi[d])
        ax = _ax(grown, d)
        if n_lo > 0:
            inner = _slc(grown, d, slice(n_lo, None))
            blk = _bc_block(inner, d, n_lo, bc[d][0], True, ax)
            grown = torch.cat([blk, inner], dim=ax)
        if n_hi > 0:
            inner = _slc(grown, d, slice(0, grown.shape[ax] - n_hi))
            blk = _bc_block(inner, d, n_hi, bc[d][1], False, ax)
            grown = torch.cat([inner, blk], dim=ax)
    return grown


def _merge_fine_level(data: torch.Tensor, mask: torch.Tensor,
                      up: torch.Tensor, gbox: Box, geom: Geometry,
                      ngrow: int) -> torch.Tensor:
    """where(mask, fine, coarse-upsample) over gbox, honouring SAME-LEVEL
    periodic images: a grown position outside the domain along periodic
    dims takes the fine value at its wrapped image whenever that image lies
    inside the level's stored extent and is covered by the level's boxes
    (AMReX FillBoundary periodic copies run before coarse interpolation).
    Images outside the stored extent or uncovered fall through to the
    coarse upsample, exactly as a hole would."""
    pad = (ngrow,) * 6
    fine_p = F.pad(data, pad)
    mask_p = F.pad(mask, pad)
    dom = geom.domain
    for d in range(3):
        if not geom.is_periodic[d]:
            continue
        pos = np.arange(gbox.lo[d], gbox.hi[d] + 1)
        w = dom.lo[d] + (pos - dom.lo[d]) % dom.shape[d]
        if np.array_equal(w, pos):
            continue                   # grown box inside the domain: free
        idx = w - gbox.lo[d]
        valid = (idx >= 0) & (idx < len(pos))
        take = _index(data, np.where(valid, idx, 0))
        fine_p = torch.index_select(fine_p, _ax(fine_p, d), take)
        vshape = [1, 1, 1]
        vshape[d] = len(pos)
        mask_p = (torch.index_select(mask_p, d, take)
                  & torch.as_tensor(valid, device=data.device).reshape(vshape))
    return torch.where(mask_p[None], fine_p, up)


def interp_stencil(interp: str) -> int:
    """Coarse cells an upsample reads beyond a fine cell's parent, each
    way: one for linear and quadratic, none for pc."""
    return 1 if interp in ("linear", "quadratic") else 0


def _coarse_window(meta, lmeta, lev: int, ngrow: int, interp: str):
    """(gbox, cbox): the level's grown box and the coarse cells its
    upsample reads (``interp_stencil`` spare cells per side)."""
    r = meta.ref_ratio[lev - 1]
    gbox = lmeta[lev].bbox.grow(ngrow)
    return gbox, gbox.coarsen(r).grow(interp_stencil(interp))


def _upsampled(crse_grown: torch.Tensor, cg_box: Box, cbox: Box, gbox: Box,
               r: int, interp: str) -> torch.Tensor:
    """Slice cbox out of the grown coarse array, refine it by r, and slice
    the result to gbox."""
    sl = tuple(slice(cbox.lo[d] - cg_box.lo[d],
                     cbox.hi[d] - cg_box.lo[d] + 1) for d in range(3))
    c = crse_grown[(slice(None),) + sl]
    for d in range(3):
        c = _upsample_axis(c, d, r, interp)
    # c now covers [cbox.lo*r, (cbox.hi+1)*r); slice to gbox
    sl = tuple(slice(gbox.lo[d] - cbox.lo[d] * r,
                     gbox.hi[d] + 1 - cbox.lo[d] * r) for d in range(3))
    return c[(slice(None),) + sl]


def _combine_two_level(meta, lmeta, lev: int, ngrow: int, data, mask,
                       crse_grown: torch.Tensor, crse_g: int,
                       bc: BCSpec, interp: str) -> torch.Tensor:
    """One two-level fill: combine level data with a coarse grown array that
    already has crse_g ghosts."""
    geom = meta.geoms[lev]
    gbox, cbox = _coarse_window(meta, lmeta, lev, ngrow, interp)
    cg_box = lmeta[lev - 1].bbox.grow(crse_g)
    if not cg_box.contains_box(cbox):
        raise ValueError("coarse grown array too small for this fill")
    up = _upsampled(crse_grown, cg_box, cbox, gbox, meta.ref_ratio[lev - 1],
                    interp)
    grown = _merge_fine_level(data, mask, up, gbox, geom, ngrow)
    return _apply_exterior_bc(grown, gbox, geom, bc)


def coarse_ghost_requirement(meta, lmeta, lev: int, ngrow: int,
                             interp: str) -> int:
    """Ghost width the coarse level must carry to serve this level's fill."""
    _, cbox = _coarse_window(meta, lmeta, lev, ngrow, interp)
    bbox_c = lmeta[lev - 1].bbox
    gc = 0
    for d in range(3):
        gc = max(gc, bbox_c.lo[d] - cbox.lo[d], cbox.hi[d] - bbox_c.hi[d])
    return max(gc, 0)


def fill_dense_multilevel(meta, lmeta, data_list, mask_list, ngrow,
                          bc: Optional[BCSpec] = None,
                          interp: str = "linear"):
    """Grown dense arrays for ALL levels in one bottom-up pass, each level
    filled exactly once.  ngrow: int or per-level list.  Returns a list of
    [ncomp, *(bbox.grow(ngrow).shape)] tensors (views where a level carried
    extra ghosts for the next finer one)."""
    with span("fill.dense"):
        return _fill_multilevel(meta, lmeta, data_list, mask_list, ngrow, bc,
                                interp)


def _fill_multilevel(meta, lmeta, data_list, mask_list, ngrow, bc, interp):
    L = meta.n_levels
    if bc is None:
        bc = default_bc(3)
    if np.isscalar(ngrow):
        ngrow = [int(ngrow)] * L
    need = [int(g) for g in ngrow]
    for lev in range(L - 1, 0, -1):
        gc = coarse_ghost_requirement(meta, lmeta, lev, need[lev], interp)
        need[lev - 1] = max(need[lev - 1], gc)

    grown = [None] * L
    grown[0] = _grow_level0(data_list[0], lmeta[0].bbox, meta.geoms[0],
                            need[0], bc)
    for lev in range(1, L):
        grown[lev] = _combine_two_level(meta, lmeta, lev, need[lev],
                                        data_list[lev], mask_list[lev],
                                        grown[lev - 1], need[lev - 1],
                                        bc, interp)
    # shrink to the requested ghost widths
    outs = []
    for lev in range(L):
        extra = need[lev] - ngrow[lev]
        if extra > 0:
            sl = (slice(None),) + tuple(slice(extra, grown[lev].shape[1 + d]
                                              - extra) for d in range(3))
            outs.append(grown[lev][sl])
        else:
            outs.append(grown[lev])
    return outs


def fill_dense_arrays(meta, lmeta, data_list, mask_list, lev: int, ngrow: int,
                      bc: Optional[BCSpec] = None,
                      interp: str = "linear") -> torch.Tensor:
    """Grown dense array of ONE level, recursing through the coarser levels
    (each coarse level grown just wide enough for its finer neighbour).

    data_list[lev]: [ncomp, *bbox_shape]; mask_list[lev]: bool [*bbox_shape]
    (True where the level's boxes cover).  Returns
    [ncomp, *(bbox.grow(ngrow).shape)]."""
    with span("fill.dense"):
        return _fill_level(meta, lmeta, data_list, mask_list, lev, ngrow, bc,
                           interp)


def _fill_level(meta, lmeta, data_list, mask_list, lev, ngrow, bc, interp):
    geom = meta.geoms[lev]
    if bc is None:
        bc = default_bc(3)
    data = data_list[lev]
    bbox = lmeta[lev].bbox
    if lev == 0:
        return _grow_level0(data, bbox, geom, ngrow, bc)
    gc = coarse_ghost_requirement(meta, lmeta, lev, ngrow, interp)
    crse_grown = _fill_level(meta, lmeta, data_list, mask_list, lev - 1, gc,
                             bc, interp)
    gbox, cbox = _coarse_window(meta, lmeta, lev, ngrow, interp)
    up = _upsampled(crse_grown, lmeta[lev - 1].bbox.grow(gc), cbox, gbox,
                    meta.ref_ratio[lev - 1], interp)
    grown = _merge_fine_level(data, mask_list[lev], up, gbox, geom, ngrow)
    return _apply_exterior_bc(grown, gbox, geom, bc)
