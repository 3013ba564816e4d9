"""Plain references of the flame jobs: the curvature chain, marching cubes
with its sampling, and the conditional mean and joint PDF.

Semantics (those of PeleAnalysis's ``curvature``, ``isosurface``,
``conditionalMean`` and ``jpdf``):

* progress ``c = (T - min T) / (max T - min T)`` over the valid cells of
  every level; ``G = grad c`` by centred differences; ``N = -G / max(|G|,
  1e-14)``; ``MeanCurvature = div(N) / 2``; ``GaussianCurvature = (G .
  adj(H) . G) / |G|^4`` with ``H_ij = dG_i / dx_j``.
* the isosurface lives on the dual grid of cell centres: a node on every
  edge between two cells whose values lie on either side of the iso value
  (a cell is inside where its value is below it), at ``t = (iso - f_A) /
  (f_B - f_A)`` from the lower cell, every other field interpolated at the
  same ``t``; triangles by the standard case tables (``mc_tables.npz``, a
  copy of Paul Bourke's public tables), over the dual cells between the
  domain's own cells (no periodic image).  The flame configurations keep
  every iso value of their traffic inside the finest level, more cells
  from its coarse-fine edges than the curvature stencils reach, so the
  finest level's cells alone give the surface and its samples: no ghost
  cell filled from a coarser level reaches an output.
* the conditional mean bins the valid cells of every level over ``[lo,
  hi)`` (out-of-range cells dropped), each weighted by the finest-level
  cells it stands for; the joint PDF clamps into the edge bins and weights
  each cell by its volume, divided by the domain volume.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..amr import cell_centres
from . import accumulate_dtype, rounded

_TABLES = np.load(os.path.join(os.path.dirname(__file__), "mc_tables.npz"))
TRI_TABLE = _TABLES["tri_table"].astype(np.int64)
CORNERS = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)])
EDGES = np.array([(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                  (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)])


def curvature(st, pname: str) -> Dict[str, torch.Tensor]:
    """Mean and Gaussian curvature of ``pname`` on the finest level's box,
    as the tools run them by default (``is_per=0 0 0``): each field's one
    ghost layer repeats its edge value on a face of the domain, and is NaN
    where a coarser level would fill it (no output of the cells reaches
    such a layer).  ``st`` is a kind's ``State``: ``levels``, ``valid``,
    ``h``."""
    h = st.h
    lev = h.n_levels - 1
    T = [st.levels[k][pname] for k in range(h.n_levels)]
    lo = min(t[m].min() for t, m in zip(T, st.valid))
    hi = max(t[m].max() for t, m in zip(T, st.valid))
    c = (T[lev] - lo) * (1.0 / (hi - lo))
    box, dom = h.bboxes[lev], h.domains[lev]
    face = [(box[0][d] == dom[0][d], box[1][d] == dom[1][d])
            for d in range(3)]
    dx = h.dx(lev)

    def grad(f):
        return _grad(_fill(f, face), dx)

    G = grad(c)
    mag = torch.sqrt(G[0] * G[0] + G[1] * G[1] + G[2] * G[2])
    ng = -torch.clamp_min(mag, 1e-14)
    N = [g / ng for g in G]
    km = 0.5 * sum(grad(N[d])[d] for d in range(3))
    H = [grad(G[i]) for i in range(3)]                    # H[i][j]
    num = 0.0
    for i in range(3):
        for j in range(3):
            i1, i2, j1, j2 = (i + 1) % 3, (i + 2) % 3, (j + 1) % 3, \
                (j + 2) % 3
            adj = H[i1][j1] * H[i2][j2] - H[i1][j2] * H[i2][j1]
            num = num + G[i] * adj * G[j]
    n2 = ng * ng
    kg = num / (n2 * n2)
    return {f"MeanCurvature_{pname}": km, f"GaussianCurvature_{pname}": kg}


def _fill(f: torch.Tensor, face) -> torch.Tensor:
    """``f`` with one ghost layer a side: its edge value repeated where
    ``face[d][side]`` (a face of the domain), NaN elsewhere."""
    for d in range(3):
        n = f.shape[d]
        sides = []
        for s, (at, src) in enumerate(((0, 0), (n - 1, n - 1))):
            g = f.narrow(d, src, 1)
            sides.append(g if face[d][s] else torch.full_like(g, float("nan")))
        f = torch.cat([sides[0], f, sides[1]], d)
    return f


def _grad(f: torch.Tensor, dx: float) -> List[torch.Tensor]:
    """Centred differences on the interior (each axis shrunk by one)."""
    inner = (slice(1, -1),) * 3
    out = []
    for d in range(3):
        hi = list(inner)
        lo = list(inner)
        hi[d], lo[d] = slice(2, None), slice(None, -2)
        out.append((f[tuple(hi)] - f[tuple(lo)]) / (2.0 * dx))
    return out


def isosurface(st, iso_name: str, iso_val: float,
               extras: Sequence[str]) -> dict:
    """Nodes (``[n, 3 + len(extras)]``: X, Y, Z, the extras) and the total
    triangle area of the finest level's isosurface, float64 numpy."""
    lev = st.h.n_levels - 1
    if not st.h.owned(lev).all():
        raise ValueError("the reference's surface needs a finest level "
                         "that fills its bounding box")
    dt, dev = st.dtype, st.device
    v = st.finest(iso_name)
    iso = torch.tensor(iso_val, dtype=dt, device=dev)
    xs = [torch.from_numpy(c).to(dev, dt) for c in cell_centres(st.h, lev)]
    X = torch.stack(torch.meshgrid(*xs, indexing="ij"))
    F = torch.cat([X] + [st.finest(n)[None] for n in extras])   # [nf, ...]
    inside = v < iso
    nodes = []
    for a in range(3):
        n = v.shape[a]
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[a], hi[a] = slice(0, n - 1), slice(1, n)
        lo, hi = tuple(lo), tuple(hi)
        cross = inside[lo] ^ inside[hi]
        fa, fb = v[lo][cross], v[hi][cross]
        A = F[(slice(None),) + lo][:, cross]
        B = F[(slice(None),) + hi][:, cross]
        nodes.append((A + _t(fa, fb, iso)[None] * (B - A)).T)
    nodes = torch.cat(nodes)
    # triangles: each dual cell's crossed edges, by the case table
    ci = torch.zeros(tuple(s - 1 for s in v.shape), dtype=torch.int64,
                     device=dev)
    corner = []
    for b, o in enumerate(CORNERS):
        sl = tuple(slice(int(o[d]), v.shape[d] - 1 + int(o[d]))
                   for d in range(3))
        ci |= inside[sl].long() << b
        corner.append(sl)
    act = (ci != 0) & (ci != 255)
    cv = torch.stack([v[sl][act] for sl in corner], 1)          # [m, 8]
    cx = torch.stack([X[(slice(None),) + sl][:, act] for sl in corner],
                     1).permute(2, 1, 0)                        # [m, 8, 3]
    pts = []
    for c0, c1 in EDGES:
        if (CORNERS[c0] > CORNERS[c1]).any():      # lerp from the lower cell
            c0, c1 = c1, c0
        t = _t(cv[:, c0], cv[:, c1], iso)[:, None]
        pts.append(cx[:, c0] + t * (cx[:, c1] - cx[:, c0]))
    pts = torch.stack(pts, 1)                                   # [m, 12, 3]
    tri = torch.from_numpy(TRI_TABLE[:, :15]).to(dev)[ci[act]]
    tri = tri.reshape(-1, 5, 3)
    ok = tri[..., 0] >= 0
    m = torch.arange(tri.shape[0], device=dev)[:, None].expand(-1, 5)[ok]
    p = pts[m[:, None], tri[ok]]                                # [k, 3, 3]
    cr = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    area = 0.5 * torch.sqrt((cr * cr).sum(1))
    acc = accumulate_dtype(dt)
    return {"nodes": nodes.to(torch.float64).cpu().numpy(),
            "area": float(rounded(area.to(acc).sum(), dt)),
            "names": ["X", "Y", "Z"] + list(extras)}


def _t(fa: torch.Tensor, fb: torch.Tensor, iso: torch.Tensor) -> torch.Tensor:
    d = fb - fa
    t = torch.where(d.abs() > 0, (iso - fa) / torch.where(d == 0, 1.0, d),
                    torch.zeros_like(d))
    return t.clamp(0.0, 1.0)


def _weights(st, lev: int, kind: str) -> float:
    h = st.h
    if kind == "cells":
        return float(h.ref_ratio ** (3 * (h.n_levels - 1 - lev)))
    # the cell's share of the domain's volume
    return 1.0 / (float(np.prod(h.n_cell)) * h.ref_ratio ** (3 * lev))


def _bin(v: torch.Tensor, lo: float, hi: float, nbins: int) -> torch.Tensor:
    dt = v.dtype
    lo_t = torch.tensor(lo, dtype=dt, device=v.device)
    span = torch.tensor(hi, dtype=dt, device=v.device) - lo_t
    return torch.floor((v - lo_t) / span * nbins)


def conditional_mean(st, bin_name: str, avg_names: Sequence[str],
                     nbins: int, lo: float, hi: float) -> np.ndarray:
    """The rows of the conditional-mean table: bin centre, then per
    averaged field sum, sumSq, avg, std, then N and p (float64)."""
    acc = accumulate_dtype(st.dtype)
    na = len(avg_names)
    hits = torch.zeros(nbins, dtype=acc, device=st.device)
    sums = torch.zeros((nbins, na), dtype=acc, device=st.device)
    sq = torch.zeros((nbins, na), dtype=acc, device=st.device)
    for lev, f in enumerate(st.levels):
        b = _bin(f[bin_name], lo, hi, nbins)
        ok = st.valid[lev] & (b >= 0) & (b < nbins)
        idx = b[ok].long()
        w = _weights(st, lev, "cells")
        hits.index_add_(0, idx, torch.full(idx.shape, w, dtype=acc,
                                           device=st.device))
        for j, n in enumerate(avg_names):
            x = f[n][ok]
            sums[:, j].index_add_(0, idx, (w * x).to(acc))
            sq[:, j].index_add_(0, idx, (w * (x * x)).to(acc))
    H = rounded(hits, st.dtype)
    S, Q = rounded(sums, st.dtype), rounded(sq, st.dtype)
    Hs = torch.where(H > 0, H, torch.ones_like(H))[:, None]
    avg = torch.where(H[:, None] > 0, S / Hs, torch.zeros_like(S))
    std = torch.where(H[:, None] > 0,
                      torch.sqrt(torch.clamp_min(Q / Hs - avg * avg, 0.0)),
                      torch.zeros_like(S))
    dv = (hi - lo) / nbins
    centre = torch.tensor(lo + dv * (0.5 + np.arange(nbins)),
                          dtype=torch.float64, device=st.device)
    p = H / torch.clamp_min(H.sum(), 1.0)
    return torch.cat([centre[:, None], S, Q, avg, std, H[:, None],
                      p[:, None]], 1).cpu().numpy()


def joint_pdf(st, n1: str, n2: str, nbins: int,
              b1: Sequence[float], b2: Sequence[float]) -> np.ndarray:
    """The ``[nbins, nbins]`` PDF (float64)."""
    acc = accumulate_dtype(st.dtype)
    pdf = torch.zeros(nbins * nbins, dtype=acc, device=st.device)
    for lev, f in enumerate(st.levels):
        i = _bin(f[n1], b1[0], b1[1], nbins).clamp(0, nbins - 1).long()
        j = _bin(f[n2], b2[0], b2[1], nbins).clamp(0, nbins - 1).long()
        ok = st.valid[lev]
        idx = i[ok] * nbins + j[ok]
        pdf.index_add_(0, idx, torch.full(idx.shape, _weights(st, lev, "vol"),
                                          dtype=acc, device=st.device))
    return rounded(pdf, st.dtype).reshape(nbins, nbins).cpu().numpy()
