"""The flame isosurface's reference in z slabs of the finest level: the
semantics of ``flame.isosurface`` on ``flame.curvature`` (that module's
docstring), for a finest level too large to hold with the whole-level
reference's temporaries (about 30 float64 fields of the level, a meshgrid
and an int64 case index: 50-60 GB at 226 M cells).

* The progress bounds are taken over every level's valid cells first, as
  ``flame.curvature`` takes them.
* A slab of rows ``[z0, z1)`` computes the curvature chain on rows grown
  by the chain's 2 cells (one fill-and-stencil stage each) and 1 more for
  the dual cells above its last row.  Along z a ghost layer is added only
  at the level's own ends, where ``flame._fill`` adds it; inside the level
  the grown rows stand in for it, so every value is the whole level's, to
  the bit.
* The slab emits the nodes of the edges whose lower cell lies in its rows
  and the triangles of the dual cells whose lower corner does; the areas
  of the slabs are summed.

Plain torch, nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..amr import box_shape, cell_centres
from . import accumulate_dtype, rounded
from .flame import CORNERS, EDGES, TRI_TABLE, _grad, _t

# the card's bytes a slab may take, and the slab's bytes a cell: the
# chain's ~25 float64 fields of the grown slab, the coordinates and
# sampled fields, the case index and the masks
SLAB_BYTES = 8 << 30
SLAB_CELL_BYTES = 400
GROW = 2


def slab_height(st) -> int:
    """Rows of the finest level a slab takes within ``SLAB_BYTES``."""
    nx, ny, _ = box_shape(st.h.bboxes[-1])
    return max(1, SLAB_BYTES // (SLAB_CELL_BYTES * nx * ny) - 2 * GROW - 1)


def bounds(st, pname: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The progress bounds: min and max of ``pname`` over the valid cells
    of every level."""
    T = [st.levels[k][pname] for k in range(st.h.n_levels)]
    lo = min(t[m].min() for t, m in zip(T, st.valid))
    hi = max(t[m].max() for t, m in zip(T, st.valid))
    return lo, hi


def _pad(f: torch.Tensor, face, at_lo: bool, at_hi: bool) -> torch.Tensor:
    """``flame._fill`` of rows of the level: x and y as there; along z a
    ghost layer only on a side that is the level's own end."""
    for d in range(3):
        n = f.shape[d]
        sides = []
        for s, src in enumerate((0, n - 1)):
            if d == 2 and not (at_lo, at_hi)[s]:
                sides.append(None)
                continue
            g = f.narrow(d, src, 1)
            sides.append(g if face[d][s]
                         else torch.full_like(g, float("nan")))
        f = torch.cat([x for x in (sides[0], f, sides[1])
                       if x is not None], d)
    return f


def _stage(f: torch.Tensor, a: int, b: int, nz: int, face, dx: float
           ) -> Tuple[List[torch.Tensor], int, int]:
    """One fill-and-stencil step of rows ``[a, b)``: the centred
    differences and the rows ``[a', b')`` they are exact on."""
    at_lo, at_hi = a == 0, b == nz
    g = _grad(_pad(f, face, at_lo, at_hi), dx)
    return g, a + (0 if at_lo else 1), b - (0 if at_hi else 1)


def curvature_rows(st, pname: str, lo, hi, z0: int, z1: int
                   ) -> Dict[str, torch.Tensor]:
    """Mean and Gaussian curvature of ``pname`` on the finest level's rows
    ``[z0, z1)``, as ``flame.curvature`` gives them there."""
    h = st.h
    lev = h.n_levels - 1
    box, dom = h.bboxes[lev], h.domains[lev]
    face = [(box[0][d] == dom[0][d], box[1][d] == dom[1][d])
            for d in range(3)]
    dx = h.dx(lev)
    T = st.levels[lev][pname]
    nz = T.shape[2]
    a, b = max(0, z0 - GROW), min(nz, z1 + GROW)
    c = (T[:, :, a:b] - lo) * (1.0 / (hi - lo))
    G, ga, gb = _stage(c, a, b, nz, face, dx)
    del c
    mag = torch.sqrt(G[0] * G[0] + G[1] * G[1] + G[2] * G[2])
    ng = -torch.clamp_min(mag, 1e-14)
    N = [g / ng for g in G]
    km, ka, kb = None, ga, gb
    for d in range(3):
        g, ka, kb = _stage(N[d], ga, gb, nz, face, dx)
        km = g[d] if km is None else km + g[d]
    km = 0.5 * km
    del N
    H = [_stage(G[i], ga, gb, nz, face, dx)[0] for i in range(3)]
    rows = slice(ka - ga, kb - ga)
    Gk = [g[:, :, rows] for g in G]
    num = 0.0
    for i in range(3):
        for j in range(3):
            i1, i2, j1, j2 = (i + 1) % 3, (i + 2) % 3, (j + 1) % 3, \
                (j + 2) % 3
            adj = H[i1][j1] * H[i2][j2] - H[i1][j2] * H[i2][j1]
            num = num + Gk[i] * adj * Gk[j]
    n2 = ng[:, :, rows] * ng[:, :, rows]
    kg = num / (n2 * n2)
    out = slice(z0 - ka, z1 - ka)
    return {f"MeanCurvature_{pname}": km[:, :, out],
            f"GaussianCurvature_{pname}": kg[:, :, out]}


def isosurface(st, iso_name: str, iso_val: float, extras: Sequence[str],
               slab: Optional[int] = None, pname: str = "temp") -> dict:
    """``flame.isosurface(st, iso_name, iso_val, extras)``, computed in
    slabs of ``slab`` rows (``slab_height`` by default); the curvatures
    among ``extras`` are of ``pname``."""
    h = st.h
    lev = h.n_levels - 1
    if not h.owned(lev).all():
        raise ValueError("the reference's surface needs a finest level "
                         "that fills its bounding box")
    slab = slab or slab_height(st)
    dt, dev = st.dtype, st.device
    nz = st.levels[lev][iso_name].shape[2]
    lo, hi = bounds(st, pname)
    xs = [torch.from_numpy(c).to(dev, dt) for c in cell_centres(h, lev)]
    iso = torch.tensor(iso_val, dtype=dt, device=dev)
    acc = accumulate_dtype(dt)
    nodes, area = [], torch.zeros((), dtype=acc, device=dev)
    for z0 in range(0, nz, slab):
        z1 = min(z0 + slab, nz)
        z1e = min(z1 + 1, nz)
        derived = None
        fields = []
        for n in [iso_name] + list(extras):
            if n in st.cfg["components"]:
                fields.append(st.finest(n)[:, :, z0:z1e])
                continue
            if derived is None:
                derived = curvature_rows(st, pname, lo, hi, z0, z1e)
            fields.append(derived[n])
        got, a = _slab(fields, xs, iso, z0, z1e, z1 - z0)
        nodes.append(got)
        area = area + a
        del derived, fields
    return {"nodes": torch.cat(nodes).to(torch.float64).cpu().numpy(),
            "area": float(rounded(area, dt)),
            "names": ["X", "Y", "Z"] + list(extras)}


def _slab(fields: List[torch.Tensor], xs, iso, z0: int, z1e: int,
          own: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nodes and summed triangle area of rows ``[z0, z1e)``: the edges
    whose lower cell lies in the first ``own`` rows, the dual cells whose
    lower corner does (``flame.isosurface``'s arithmetic)."""
    v = fields[0]
    X = torch.stack(torch.meshgrid(xs[0], xs[1], xs[2][z0:z1e],
                                   indexing="ij"))
    F = torch.cat([X] + [f[None] for f in fields[1:]])
    inside = v < iso
    nodes = []
    for a in range(3):
        n = v.shape[a]
        lo = [slice(None), slice(None), slice(0, own)]
        hi = [slice(None), slice(None), slice(0, own)]
        lo[a], hi[a] = slice(0, n - 1), slice(1, n)
        lo, hi = tuple(lo), tuple(hi)
        cross = inside[lo] ^ inside[hi]
        fa, fb = v[lo][cross], v[hi][cross]
        A = F[(slice(None),) + lo][:, cross]
        B = F[(slice(None),) + hi][:, cross]
        nodes.append((A + _t(fa, fb, iso)[None] * (B - A)).T)
    dev = v.device
    ci = torch.zeros(tuple(s - 1 for s in v.shape), dtype=torch.int64,
                     device=dev)
    corner = []
    for b, o in enumerate(CORNERS):
        sl = tuple(slice(int(o[d]), v.shape[d] - 1 + int(o[d]))
                   for d in range(3))
        ci |= inside[sl].long() << b
        corner.append(sl)
    act = (ci != 0) & (ci != 255)
    cv = torch.stack([v[sl][act] for sl in corner], 1)
    cx = torch.stack([X[(slice(None),) + sl][:, act] for sl in corner],
                     1).permute(2, 1, 0)
    pts = []
    for c0, c1 in EDGES:
        if (CORNERS[c0] > CORNERS[c1]).any():
            c0, c1 = c1, c0
        t = _t(cv[:, c0], cv[:, c1], iso)[:, None]
        pts.append(cx[:, c0] + t * (cx[:, c1] - cx[:, c0]))
    pts = torch.stack(pts, 1)
    tri = torch.from_numpy(TRI_TABLE[:, :15]).to(dev)[ci[act]]
    tri = tri.reshape(-1, 5, 3)
    ok = tri[..., 0] >= 0
    m = torch.arange(tri.shape[0], device=dev)[:, None].expand(-1, 5)[ok]
    p = pts[m[:, None], tri[ok]]
    cr = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    area = 0.5 * torch.sqrt((cr * cr).sum(1))
    return torch.cat(nodes), area.to(accumulate_dtype(v.dtype)).sum()
