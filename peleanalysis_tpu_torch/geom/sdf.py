"""Signed-distance fields from triangulated surfaces on the device.

Counterpart of ``peleanalysis_tpu/geom/sdf.py``, the SDFGen replacement
(the reference's Tools/SDFGen/makelevelset3.{h,cpp}, used per box by
isosurface.cpp:1595-1654 and buildDistance.cpp).  The same steps:

  1. exact point-triangle distances in a band around each triangle
     (makelevelset3.cpp:20-41): each triangle's window of cells, its span
     rounded up to a power of two per dimension, evaluated in buckets of
     equal spans and min-reduced into ``phi``/``closest`` on the device.
     Among equal distances the triangle met first wins, in the JAX
     version's order (buckets in lexicographic order of their spans, then
     triangle ids): a first ``amin`` scatter finds each cell's distance, a
     second, over the same windows recomputed, the least such rank;
  2. axis-sequential plane sweeps (makelevelset3.cpp:58-81): each of the
     six directions walks its planes in order (the Gauss-Seidel order
     decides which triangle id is carried), re-evaluating the exact
     distance to the ids of the previous plane under the 9 in-plane
     shifts, all 9 in one batched evaluation whose first least distance
     wins, as the JAX loop's strict updates in shift order pick it.  A
     round of six sweeps repeats until nothing changed; the flag stays on
     the device and is read once a round;
  3. the sign by x-row crossing parity (makelevelset3.cpp:84-99,125-186):
     the (y, z) hits of every triangle, in buckets of equal spans, with
     the JAX version's float64 barycentric formula and its 1.3e-7 / 2.9e-7
     perturbations of the rows; each hit adds +1 at x-index 0 and -1 at
     ``searchsorted(xc, x)`` of its row, a cumsum along x counts the
     crossings and their parity is the sign (integer counts: exact) — or
     the sign of ``field - isoVal`` (isosurface.cpp:1644);
  4. distances clamped to [0, dmax] (isosurface.cpp:1614-1646).

Precision follows the JAX package: the seeding runs on float32-rounded
triangles, with cell centres and arithmetic in ``seed_dtype`` — float32 as
in a JAX CLI process (x64 off, where the ``> 1e-300`` guards compare in
float32 and so against 0), or float64 as with ``dtype=float64`` (x64 on:
the edge vectors are float32 differences, everything after them float64).
The seeded distances are widened to float64; the sweeps re-evaluate in
float64 on the float64 triangles, so ``phi`` mixes the two as in JAX.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# window cells per dispatch of the band seeding and the parity hits: a few
# GB of float64 temporaries at the limit, far inside an 80 GB card
MAX_CELLS = 1 << 22


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of length 3, in numpy's order."""
    w = u * v
    return w[..., 0] + w[..., 1] + w[..., 2]


def point_tri_distance(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """Exact unsigned distance from points ``p[..., 3]`` to triangles
    ``a/b/c[..., 3]`` (broadcasting): the region-based closest point, in
    the JAX version's order of operations and type promotion."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.where(torch.abs(va + vb + vc) > 1e-300, va + vb + vc, 1.0)
    v = vb / denom
    w = vc / denom
    closest = a + v[..., None] * ab + w[..., None] * ac

    # vertex regions
    cond_a = (d1 <= 0) & (d2 <= 0)
    cond_b = (d3 >= 0) & (d4 <= d3)
    cond_c = (d6 >= 0) & (d5 <= d6)
    # edge regions
    v_ab = torch.where(torch.abs(d1 - d3) > 1e-300, d1 / (d1 - d3), 0.0)
    cond_ab = (~cond_a) & (~cond_b) & (d1 >= 0) & (d3 <= 0) & (vc <= 0)
    v_ac = torch.where(torch.abs(d2 - d6) > 1e-300, d2 / (d2 - d6), 0.0)
    cond_ac = (~cond_a) & (~cond_c) & (d2 >= 0) & (d6 <= 0) & (vb <= 0)
    t_bc = torch.where(torch.abs((d4 - d3) + (d5 - d6)) > 1e-300,
                       (d4 - d3) / ((d4 - d3) + (d5 - d6)), 0.0)
    cond_bc = (~cond_b) & (~cond_c) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0) \
        & (va <= 0)

    closest = torch.where(cond_bc[..., None],
                          b + t_bc[..., None] * (c - b), closest)
    closest = torch.where(cond_ac[..., None], a + v_ac[..., None] * ac,
                          closest)
    closest = torch.where(cond_ab[..., None], a + v_ab[..., None] * ab,
                          closest)
    closest = torch.where(cond_c[..., None], c.to(closest.dtype), closest)
    closest = torch.where(cond_b[..., None], b.to(closest.dtype), closest)
    closest = torch.where(cond_a[..., None], a.to(closest.dtype), closest)
    e = p - closest
    return torch.sqrt(_dot(e, e))


def _span_buckets(lo: np.ndarray, hi: np.ndarray, pad: int):
    """Per-dim power-of-two window spans of ``hi - lo + 1 + 2 pad`` and the
    triangles of each, buckets in lexicographic order of their spans (the
    JAX version's ``np.unique(axis=0)``), ids ascending within each."""
    spans = hi - lo + 1 + 2 * pad
    keys = 1 << np.ceil(np.log2(np.maximum(spans, 1))).astype(int)
    ukeys, kinv = np.unique(keys, axis=0, return_inverse=True)
    kinv = kinv.reshape(-1)
    return [(tuple(int(v) for v in ukeys[k]), np.nonzero(kinv == k)[0])
            for k in range(len(ukeys))]


def _offsets(span, device) -> torch.Tensor:
    """[prod(span), len(span)] window offsets in C order."""
    grids = torch.meshgrid(*[torch.arange(s, device=device) for s in span],
                           indexing="ij")
    return torch.stack(grids, -1).reshape(-1, len(span))


def _band_windows(tri: torch.Tensor, tlo: np.ndarray, buckets, origin, dx,
                  shape, dmax: float, exact_band: int,
                  seed_dtype: torch.dtype):
    """Yield (flat cell index, float64 distance, window rank) of every
    window cell inside the grid whose distance is below dmax, bucket by
    bucket and chunk by chunk in the JAX version's order."""
    dev = tri.device
    tri32 = tri.to(torch.float32)
    lo_t = torch.from_numpy(tlo - exact_band).to(dev)
    shp = torch.tensor(shape, device=dev)
    org = torch.tensor(origin, dtype=seed_dtype, device=dev)
    dxt = torch.tensor(dx, dtype=seed_dtype, device=dev)
    rank0 = 0
    for span, sel in buckets:
        offs = _offsets(span, dev)
        m = offs.shape[0]
        chunk = max(16, MAX_CELLS // m)
        for s in range(0, len(sel), chunk):
            ids = torch.from_numpy(sel[s: s + chunk]).to(dev)
            idx = lo_t[ids][:, None, :] + offs[None]           # [C, M, 3]
            ok = ((idx >= 0) & (idx < shp)).all(-1)
            idxc = torch.minimum(torch.clamp(idx, min=0), shp - 1)
            p = org + (idxc.to(seed_dtype) + 0.5) * dxt
            t = tri32[ids]
            d = point_tri_distance(p, t[:, None, 0], t[:, None, 1],
                                   t[:, None, 2]).to(torch.float64)
            keep = ok & (d < dmax)
            flat = (idxc[..., 0] * shape[1] + idxc[..., 1]) * shape[2] \
                + idxc[..., 2]
            rank = (rank0 + s + torch.arange(len(ids), device=dev))[:, None] \
                .expand(-1, m)
            yield flat[keep], d[keep], rank[keep]
        rank0 += len(sel)


def band_seed(tri_verts: np.ndarray, tri: torch.Tensor, origin, dx,
              shape: Tuple[int, int, int], dmax: float, exact_band: int = 1,
              seed_dtype: torch.dtype = torch.float32):
    """Exact-band seeding on the device of ``tri`` (the float64 triangles
    ``tri_verts`` there): (phi float64, closest int64) of ``shape``, dmax
    and -1 where no window reaches."""
    dev = tri.device
    n = int(np.prod(shape))
    phi = torch.full((n,), dmax, dtype=torch.float64, device=dev)
    closest = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if len(tri_verts) == 0:
        return phi.reshape(shape), closest.reshape(shape)
    oa, dxa = np.asarray(origin, np.float64), np.asarray(dx, np.float64)
    tlo = np.floor((tri_verts.min(axis=1) - oa) / dxa - 0.5).astype(np.int64)
    thi = np.floor((tri_verts.max(axis=1) - oa) / dxa - 0.5).astype(np.int64)
    buckets = _span_buckets(tlo, thi, exact_band)
    args = (tri, tlo, buckets, tuple(oa), tuple(dxa), shape, dmax,
            exact_band, seed_dtype)
    for flat, d, _ in _band_windows(*args):
        phi.scatter_reduce_(0, flat, d, "amin")
    # ties: the least rank among the windows reaching each cell's minimum
    big = torch.iinfo(torch.int64).max
    best = torch.full((n,), big, dtype=torch.int64, device=dev)
    for flat, d, rank in _band_windows(*args):
        hit = d == phi[flat]
        best.scatter_reduce_(0, flat[hit], rank[hit], "amin")
    # rank -> triangle id: the buckets' id lists in order
    ids = torch.from_numpy(np.concatenate([sel for _, sel in buckets])).to(dev)
    found = best != big
    closest[found] = ids[best[found]]
    return phi.reshape(shape), closest.reshape(shape)


def _plane_shifts(a: torch.Tensor, fill) -> torch.Tensor:
    """[9, n1, n2]: a plane shifted by (d1, d2) in (-1, 0, 1)^2, d1 outer;
    entry [k, x, y] is a[x + d1, y + d2], ``fill`` outside."""
    n1, n2 = a.shape
    pad = torch.full((n1 + 2, n2 + 2), fill, dtype=a.dtype, device=a.device)
    pad[1:-1, 1:-1] = a
    return torch.stack([pad[1 + d1: 1 + d1 + n1, 1 + d2: 1 + d2 + n2]
                        for d1 in (-1, 0, 1) for d2 in (-1, 0, 1)])


class _AxisSweep:
    """The plane step of the sweeps along ``axis`` over float64 ``phi`` and
    ``closest`` (views of one grid): read plane ``prev``, update plane
    ``cur``, or ``changed`` with whether a cell changed, then move both
    indices by ``step``.  The indices are device tensors, so on a card the
    step is captured once as a CUDA graph and replayed plane after plane
    (one launch a plane instead of ~170) when ``pool`` is a graph memory
    pool; otherwise it runs op by op."""

    def __init__(self, phi, closest, tri, centers, axis: int, dmax: float,
                 changed, pool=None):
        dev = phi.device
        self.phi, self.closest, self.axis = phi, closest, axis
        self.A, self.B, self.C = tri[:, 0], tri[:, 1], tri[:, 2]
        perp = [d for d in range(3) if d != axis]
        g1, g2 = torch.meshgrid(centers[perp[0]], centers[perp[1]],
                                indexing="ij")
        self.p_base = torch.zeros(g1.shape + (3,), dtype=torch.float64,
                                  device=dev)
        self.p_base[..., perp[0]] = g1
        self.p_base[..., perp[1]] = g2
        self.on_axis = torch.tensor([d == axis for d in range(3)], device=dev)
        self.coord = centers[axis]
        self.dmax, self.changed = dmax, changed
        self.shift_no = torch.arange(9, device=dev)[:, None, None]
        self.prev, self.cur, self.step = (
            torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(3))
        self.graph, self.pool = None, pool

    def _plane_step(self) -> None:
        ax, dmax = self.axis, self.dmax
        src_ph = self.phi.index_select(ax, self.prev).squeeze(ax)
        src_cl = self.closest.index_select(ax, self.prev).squeeze(ax)
        cur_ph = self.phi.index_select(ax, self.cur).squeeze(ax)
        cur_cl = self.closest.index_select(ax, self.cur).squeeze(ax)
        cand = _plane_shifts(src_cl, -1)
        have = (cand >= 0) & (_plane_shifts(src_ph, dmax) < dmax)
        t = torch.where(have, cand, 0)
        p = torch.where(self.on_axis, self.coord.index_select(0, self.cur),
                        self.p_base)
        d = point_tri_distance(p, self.A[t], self.B[t], self.C[t])
        d = torch.where(have & ~torch.isnan(d), d, float("inf"))
        # the first of the least distances, as the JAX loop's strict
        # updates in shift order keep it
        best = d.amin(dim=0)
        k = torch.where(d == best, self.shift_no, 9).amin(dim=0)
        upd = best < cur_ph
        self.phi.index_copy_(ax, self.cur,
                             torch.where(upd, best, cur_ph).unsqueeze(ax))
        self.closest.index_copy_(ax, self.cur, torch.where(
            upd, torch.gather(t, 0, k[None])[0], cur_cl).unsqueeze(ax))
        self.changed |= upd.any()
        self.prev += self.step
        self.cur += self.step

    def run(self, first: int, step: int, n: int) -> None:
        """``n`` plane steps from plane ``first`` in direction ``step``."""
        self.prev.fill_(first - step)
        self.cur.fill_(first)
        self.step.fill_(step)
        if self.pool is None or n == 0:
            for _ in range(n):
                self._plane_step()
            return
        if self.graph is None:
            # one step eagerly (every kernel loaded), the next captured on a
            # side stream, not run, into the sweep's memory pool (without
            # torch.cuda.graph's emptying of the allocator's cache); the
            # replays run the rest
            self._plane_step()
            n -= 1
            self.graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool=self.pool)
                self._plane_step()
                self.graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
        for _ in range(n):
            self.graph.replay()


def sweep(phi: torch.Tensor, closest: torch.Tensor, tri: torch.Tensor,
          centers, dmax: float, max_rounds: int = 8,
          graphs: bool = True) -> int:
    """The axis-sequential plane sweeps, in place on float64 ``phi`` and
    ``closest`` (module docstring) with the cell centres ``centers[d]``
    along each axis; phi and closest may be views of a larger grid whose
    cells outside them never come within dmax.  On a card the plane steps
    replay as CUDA graphs unless ``graphs`` is False (op by op, as on the
    CPU; chip_smoke.py holds the two bitwise equal).  Returns the rounds
    run."""
    dev = phi.device
    shape = phi.shape
    changed = torch.zeros((), dtype=torch.bool, device=dev)
    # the three axes' graphs share one pool: they never run at once
    pool = (torch.cuda.graph_pool_handle()
            if dev.type == "cuda" and graphs else None)
    axes = [_AxisSweep(phi, closest, tri, centers, a, dmax, changed, pool)
            for a in range(3)]
    for rnd in range(max_rounds):
        changed.fill_(False)
        for a, sw in enumerate(axes):
            n = shape[a]
            sw.run(1, 1, n - 1)
            sw.run(n - 2, -1, n - 1)
        if not bool(changed):
            return rnd + 1
    return max_rounds


def _reach(tri_verts: np.ndarray, origin, dx, shape, dmax: float):
    """Index slices of the cells within dmax of some triangle's bounding
    box (two cells to spare): the only cells the sweeps can change or read
    from, since every other cell stays at dmax."""
    lo = np.floor((tri_verts.min(axis=(0, 1)) - origin) / dx - 0.5)
    hi = np.floor((tri_verts.max(axis=(0, 1)) - origin) / dx - 0.5)
    m = np.ceil(dmax / dx) + 2
    lo = np.clip(lo - m, 0, np.array(shape) - 1).astype(int)
    hi = np.clip(hi + m, 0, np.array(shape) - 1).astype(int)
    return tuple(slice(int(a), int(b) + 1) for a, b in zip(lo, hi))


def sweep_reach(tri_verts: np.ndarray, tri: torch.Tensor,
                phi: torch.Tensor, closest: torch.Tensor, origin, dx,
                dmax: float, graphs: bool = True) -> int:
    """The sweeps, in place, over the cells of the grid (``origin``,
    ``dx``) within reach of the triangles (``_reach``); ``tri`` are
    ``tri_verts`` on phi's device.  Returns the rounds run."""
    origin, dx = np.asarray(origin, np.float64), np.asarray(dx, np.float64)
    shape = phi.shape
    box = _reach(tri_verts, origin, dx, shape, dmax)
    centers = [torch.tensor(origin[d] + (np.arange(shape[d]) + 0.5) * dx[d],
                            dtype=torch.float64, device=phi.device)[box[d]]
               for d in range(3)]
    return sweep(phi[box], closest[box], tri, centers, dmax,
                 graphs=graphs)


def unsigned_distance_grid(tri_verts: np.ndarray, origin, dx,
                           shape: Tuple[int, int, int], dmax: float,
                           exact_band: int = 1,
                           seed_dtype: torch.dtype = torch.float32,
                           device="cpu"):
    """|phi| (float64) and the closest triangle id on a uniform grid of
    ``shape`` cells from ``origin`` with spacing ``dx``, on ``device``:
    band seeding, the sweeps, the clamp to [0, dmax].  ``tri_verts``:
    float64 ``[T, 3, 3]`` host triangles."""
    tri = torch.from_numpy(np.ascontiguousarray(tri_verts, np.float64)) \
        .to(device)
    phi, closest = band_seed(tri_verts, tri, origin, dx, shape, dmax,
                             exact_band, seed_dtype)
    if len(tri_verts):
        sweep_reach(tri_verts, tri, phi, closest, origin, dx, dmax)
    return torch.clamp(phi, 0.0, dmax), closest


def parity_sign(tri_verts: np.ndarray, origin, dx,
                shape: Tuple[int, int, int], device="cpu") -> torch.Tensor:
    """-1 inside / +1 outside (float64, on ``device``) by the parity of
    the triangles crossed along +x from each cell (module docstring).  The
    query rows are perturbed by 1.3e-7 / 2.9e-7 of a cell, the same
    (y, z) against every triangle, so a row through an edge shared by two
    triangles counts once (the reference breaks such ties by simulation
    of simplicity, makelevelset3.cpp:125-160)."""
    nx, ny, nz = shape
    dev = torch.device(device)
    origin = np.asarray(origin, np.float64)
    dx = np.asarray(dx, np.float64)
    f64 = dict(dtype=torch.float64, device=dev)
    yc = torch.tensor(origin[1] + (np.arange(ny) + 0.5 + 1.3e-7) * dx[1],
                      **f64)
    zc = torch.tensor(origin[2] + (np.arange(nz) + 0.5 + 2.9e-7) * dx[2],
                      **f64)
    xc = torch.tensor(origin[0] + (np.arange(nx) + 0.5) * dx[0], **f64)
    # each crossing: +1 at x-index 0 and -1 at the first cell right of it
    diff = torch.zeros((ny, nz, nx + 1), dtype=torch.int32, device=dev)
    tv = np.asarray(tri_verts, np.float64)
    if len(tv):
        lo = np.stack([np.maximum(np.ceil((tv[:, :, d].min(1) - origin[d])
                                          / dx[d] - 0.5), 0)
                       for d in (1, 2)], 1).astype(np.int64)
        hi = np.stack([np.minimum(np.floor((tv[:, :, d].max(1) - origin[d])
                                           / dx[d] - 0.5), n - 1)
                       for d, n in ((1, ny), (2, nz))], 1).astype(np.int64)
        a, b, c = tv[:, 0], tv[:, 1], tv[:, 2]
        det = ((b[:, 1] - a[:, 1]) * (c[:, 2] - a[:, 2])
               - (b[:, 2] - a[:, 2]) * (c[:, 1] - a[:, 1]))
        live = np.all(lo <= hi, axis=1) & ~(np.abs(det) < 1e-300)
        tri = torch.from_numpy(np.ascontiguousarray(tv)).to(dev)
        det_t = torch.from_numpy(det).to(dev)
        lo_t, hi_t = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
        for span, sel in _span_buckets(lo, hi, 0):
            sel = sel[live[sel]]
            if len(sel) == 0:
                continue
            offs = _offsets(span, dev)
            chunk = max(16, MAX_CELLS // offs.shape[0])
            for s in range(0, len(sel), chunk):
                ids = torch.from_numpy(sel[s: s + chunk]).to(dev)
                jk = lo_t[ids][:, None, :] + offs[None]          # [C, M, 2]
                inside = (jk <= hi_t[ids][:, None, :]).all(-1)
                j = jk[..., 0].clamp(max=ny - 1)
                k = jk[..., 1].clamp(max=nz - 1)
                Y, Z = yc[j], zc[k]
                t = tri[ids][:, None]                            # [C,1,3,3]
                ta, tb, tc = t[..., 0, :], t[..., 1, :], t[..., 2, :]
                dd = det_t[ids][:, None]
                w1 = ((Y - ta[..., 1]) * (tc[..., 2] - ta[..., 2])
                      - (Z - ta[..., 2]) * (tc[..., 1] - ta[..., 1])) / dd
                w2 = ((tb[..., 1] - ta[..., 1]) * (Z - ta[..., 2])
                      - (tb[..., 2] - ta[..., 2]) * (Y - ta[..., 1])) / dd
                w0 = 1.0 - w1 - w2
                hit = inside & (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
                xh = w0 * ta[..., 0] + w1 * tb[..., 0] + w2 * tc[..., 0]
                jh, kh = j[hit], k[hit]
                past = torch.searchsorted(xc, xh[hit].contiguous())
                one = torch.ones_like(jh, dtype=torch.int32)
                diff.index_put_((jh, kh, torch.zeros_like(jh)), one,
                                accumulate=True)
                diff.index_put_((jh, kh, past), -one, accumulate=True)
    cnt = torch.cumsum(diff, dim=2)[..., :nx].permute(2, 0, 1)
    return torch.where(cnt % 2 == 1, -1.0, 1.0).to(torch.float64)


def signed_distance_dense(ds, tri_verts: np.ndarray, lev: int, dmax: float,
                          sign_field: Optional[str] = None,
                          iso_val: float = 0.0,
                          seed_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Signed distance (float64) on one dense level's bbox grid, on the
    state's device, to the float64 host triangles ``tri_verts`` ``[T, 3,
    3]`` (``mef.positions()[mef.elements]``).  The sign is the crossing
    parity, or -1 where ``sign_field`` < iso_val."""
    geom = ds.meta.geoms[lev]
    bbox = ds.lmeta[lev].bbox
    dx = np.array(geom.dx)
    origin = np.array(geom.prob_lo) + (np.array(bbox.lo)
                                       - np.array(geom.domain.lo)) * dx
    phi, _ = unsigned_distance_grid(tri_verts, origin, dx, bbox.shape, dmax,
                                    seed_dtype=seed_dtype, device=ds.device)
    if sign_field is not None:
        f = ds.data[lev][ds.comp(sign_field)]
        sgn = torch.where(f < iso_val, -1.0, 1.0).to(torch.float64)
    else:
        sgn = parity_sign(tri_verts, origin, dx, bbox.shape, ds.device)
    return phi * sgn
