"""MEF surface toolbox: the shared implementation behind the
combine/merge/mult/scale/slice/smooth/trim/bin/iso/check MEF tools
(reference Src/{combineMEF,mergeMEF,multMEF,scaleMEF,sliceMEF,smoothMEF,
trimMEFgen,binMEF,isoMEF,checkIso}.cpp).

Counterpart of ``peleanalysis_tpu/geom/mef_tools.py``.  The array work
runs in torch on the device the caller names, always in float64 (the MEF's
own type, as the JAX package's numpy computes): node tables [Nnodes, nvars]
and connectivity [Nelts, 3] go to the device, the results come back as
host MEFs.  The triangle-clipping core (linear field variation within each
triangle) serves sliceMEF, isoMEF, trimMEFgen and binMEF alike.  The
arithmetic is the JAX module's, operation for operation (products and
differences in the same order, 3-term sums as ((a + b) + c) like numpy's
reductions, ``ops/vec3.py``), so on the CPU the geometry is bitwise the
same; scattered sums (``index_add_``) follow the order of the device's
atomics.
``assemble_polylines`` stays host numpy: it builds a Python list of
chains for a text writer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..io.mef import MEF
from ..ops.vec3 import sqrt, sum3, triangle_areas

F64 = torch.float64


def nodes_on(mef: MEF, device) -> torch.Tensor:
    """The node table on ``device`` as float64 (a copy)."""
    return torch.tensor(np.asarray(mef.nodes, np.float64), dtype=F64,
                        device=device)


def elements_on(mef: MEF, device) -> torch.Tensor:
    """The connectivity on ``device`` as int64."""
    return torch.as_tensor(np.asarray(mef.elements, np.int64), device=device)


def host_mef(label: str, names, nodes: torch.Tensor,
             elements: torch.Tensor) -> MEF:
    return MEF(label, list(names), nodes.cpu().numpy(),
               elements.cpu().numpy().astype(np.int32))


def element_areas(nodes: torch.Tensor, elements: torch.Tensor,
                  ndim: int) -> torch.Tensor:
    """``MEF.triangle_areas``: per-element area (3-D triangles) or length
    (segments)."""
    p = nodes[:, :ndim]
    if elements.shape[1] == 3 and ndim == 3:
        return triangle_areas(p[elements[:, 0]], p[elements[:, 1]],
                              p[elements[:, 2]])
    if elements.shape[1] == 2:
        d = p[elements[:, 1]] - p[elements[:, 0]]
        return sqrt(sum3(d * d)) if ndim == 3 else sqrt(
            d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    raise ValueError(f"unsupported element type {elements.shape[1]}-node")


# ---------------------------------------------------------------------------
# simple algebra (combineMEF.cpp, mergeMEF.cpp, multMEF.cpp, scaleMEF.cpp)
# ---------------------------------------------------------------------------

def combine_mef(a: MEF, b: MEF, comps_a: Sequence[str],
                comps_b: Sequence[str], device) -> MEF:
    """Union of components of two MEFs with identical nodes+connectivity
    (combineMEF.cpp; Docs/source/surfMEFtools.rst)."""
    ea, eb = elements_on(a, device), elements_on(b, device)
    if a.n_nodes != b.n_nodes or not torch.equal(ea, eb):
        raise ValueError("combineMEF: MEFs have different structure")
    na, nb = nodes_on(a, device), nodes_on(b, device)
    names = [n for n in a.names[: a.ndim]]
    cols = [na[:, : a.ndim]]
    for src, mef, comps in ((na, a, comps_a), (nb, b, comps_b)):
        for n in comps:
            if n not in names:
                names.append(n)
                cols.append(src[:, mef.names.index(n), None])
    return host_mef(a.label, names, torch.cat(cols, dim=1), ea)


def merge_mef(a: MEF, b: MEF) -> MEF:
    """Concatenate two triangle sets, renumbering b's nodes (mergeMEF.cpp).
    A copy on the host: no arithmetic."""
    if a.names != b.names:
        raise ValueError("mergeMEF: component lists differ")
    nodes = np.concatenate([a.nodes, b.nodes])
    elems = np.concatenate([a.elements, b.elements + a.n_nodes])
    return MEF(a.label, a.names, nodes, elems.astype(np.int32))


def mult_mef(a: MEF, b: MEF, comps: Sequence[str], device) -> MEF:
    """Pointwise multiply selected comps of a by the same comps of b
    (multMEF.cpp)."""
    out = nodes_on(a, device)
    nb = nodes_on(b, device)
    for n in comps:
        out[:, a.names.index(n)] *= nb[:, b.names.index(n)]
    return host_mef(a.label, a.names, out, elements_on(a, device))


def scale_mef(a: MEF, comps: Sequence[str], factors: Sequence[float],
              device) -> MEF:
    """Scale selected comps by constants (scaleMEF.cpp)."""
    out = nodes_on(a, device)
    for n, f in zip(comps, factors):
        out[:, a.names.index(n)] *= float(f)
    return host_mef(a.label, a.names, out, elements_on(a, device))


# ---------------------------------------------------------------------------
# watertightness (checkIso.cpp:33ff)
# ---------------------------------------------------------------------------

def check_iso(mef: MEF, device) -> Dict[str, int]:
    """Edge->element incidence counts; watertight closed surfaces have every
    edge shared by exactly 2 elements."""
    e = elements_on(mef, device)
    nondeg = (e[:, 0] != e[:, 1]) & (e[:, 1] != e[:, 2]) & (e[:, 0] != e[:, 2])
    en = e[nondeg]
    ed = torch.cat([en[:, [0, 1]], en[:, [1, 2]], en[:, [2, 0]]])
    ed = torch.sort(ed, dim=1).values
    key = ed[:, 0] * mef.n_nodes + ed[:, 1]
    counts = torch.unique(key, return_counts=True)[1]
    return {
        "n_elements": int(mef.n_elts),
        "n_degenerate": int((~nondeg).sum()),
        "n_edges": int(counts.numel()),
        "n_boundary_edges": int((counts == 1).sum()),
        "n_nonmanifold_edges": int((counts > 2).sum()),
        "watertight": bool((counts == 2).all()) if counts.numel() else False,
    }


# ---------------------------------------------------------------------------
# triangle clipping in field space (the shared core)
# ---------------------------------------------------------------------------

def clip_tris_halfspace(tris: torch.Tensor, comp: int, val: float,
                        keep_ge: bool) -> torch.Tensor:
    """Clip triangles (tris [N,3,nvars]) against field[comp] >= val (or <=).
    Assumes linear variation within each triangle (trimMEFgen's slicing
    assumption, Docs/source/surfMEFtools.rst).  Returns new [M,3,nvars]:
    the triangles wholly inside, then those with one vertex inside, then
    the two halves of the quads of those with two."""
    f = tris[:, :, comp]
    inside = (f >= val) if keep_ge else (f <= val)
    cnt = inside.sum(dim=1)
    out = [tris[cnt == 3]]
    nv = tris.shape[2]

    def lerp(a, b):
        fa, fb = a[:, comp], b[:, comp]
        denom = torch.where(torch.abs(fb - fa) > 1e-300, fb - fa, 1.0)
        t = torch.clamp((val - fa) / denom, 0.0, 1.0)[:, None]
        return a + t * (b - a)

    for k in (1, 2):
        sel = cnt == k
        T = tris[sel]
        if T.shape[0] == 0:
            continue
        ins = inside[sel].to(torch.int32)
        # rotate each triangle so the "lonely" vertex is first (the first
        # inside vertex of k=1, the first outside one of k=2)
        lone = torch.argmax(ins, dim=1) if k == 1 else torch.argmin(ins,
                                                                    dim=1)
        idx = (lone[:, None] + torch.arange(3, device=tris.device)) % 3
        T = torch.gather(T, 1, idx[:, :, None].expand(-1, -1, nv))
        A, B, C = T[:, 0], T[:, 1], T[:, 2]
        pab, pac = lerp(A, B), lerp(A, C)
        if k == 1:  # keep vertex A only -> one clipped triangle
            out.append(torch.stack([A, pab, pac], dim=1))
        else:  # drop A, keep B and C -> quad (pab, B, C, pac) -> 2 tris
            out.append(torch.stack([pab, B, C], dim=1))
            out.append(torch.stack([pab, C, pac], dim=1))
    return torch.cat(out)


def tri_areas(tris: torch.Tensor, ndim: int) -> torch.Tensor:
    """Areas of [N,3,nvars] triangles from their first ``ndim`` comps (the
    2-D determinant for ndim 2)."""
    if ndim == 3:
        return triangle_areas(tris[:, 0, :3], tris[:, 1, :3], tris[:, 2, :3])
    u = tris[:, 1, :2] - tris[:, 0, :2]
    v = tris[:, 2, :2] - tris[:, 0, :2]
    return 0.5 * torch.abs(u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0])


def tris_to_mef(tris: torch.Tensor, names, label="trimmed",
                dedup: bool = True) -> MEF:
    """Triangles [N,3,nvars] to a host MEF; with ``dedup`` the vertices
    that agree to 12 decimals become one node (rows in lexicographic
    order, each the first of its copies)."""
    flat = tris.reshape(-1, tris.shape[-1])
    n = flat.shape[0]
    if dedup and n:
        # positional dedup on coordinates only (clipped vertices are new)
        uniq, inv = torch.unique(torch.round(flat, decimals=12), dim=0,
                                 return_inverse=True)
        first = torch.full((uniq.shape[0],), n, dtype=torch.int64,
                           device=flat.device)
        first.scatter_reduce_(0, inv, torch.arange(n, device=flat.device),
                              reduce="amin")
        nodes = flat[first]
        elems = inv.reshape(-1, 3)
    else:
        nodes = flat
        elems = torch.arange(n, device=flat.device).reshape(-1, 3)
    return host_mef(label, names, nodes, elems)


# ---------------------------------------------------------------------------
# trimMEFgen (trimMEFgen.cpp:434-469)
# ---------------------------------------------------------------------------

def trim_mef(mef: MEF, comps: Sequence[str], signs: Sequence[str],
             vals: Sequence[float], device, rxy: Optional[float] = None,
             sign_rxy: str = "+", rem_comps: Sequence[str] = ()) -> MEF:
    tris = nodes_on(mef, device)[elements_on(mef, device)]
    names = list(mef.names)
    if rxy is not None:
        # cylindrical-radius cut RXY (trimMEFgen.cpp:453-456): clip on a
        # temporary radius component
        x, y = tris[:, :, 0], tris[:, :, 1]
        r = sqrt(x * x + y * y)
        tris = torch.cat([tris, r[:, :, None]], dim=2)
        tris = clip_tris_halfspace(tris, len(names), rxy,
                                   keep_ge=(sign_rxy in ("+", "gt")))
        tris = tris[:, :, : len(names)]
    for n, s, v in zip(comps, signs, vals):
        tris = clip_tris_halfspace(tris, names.index(n), float(v),
                                   keep_ge=(s in ("+", "gt")))
    if rem_comps:
        keep = [i for i, n in enumerate(names) if n not in rem_comps]
        tris = tris[:, :, keep]
        names = [names[i] for i in keep]
    return tris_to_mef(tris, names, mef.label)


# ---------------------------------------------------------------------------
# binMEF (binMEF.cpp:419-474; data.rst "N-dimensional bins")
# ---------------------------------------------------------------------------

def bin_mef(mef: MEF, bin_comps: Sequence[str], bin_min: Sequence[float],
            bin_max: Sequence[float], n_bins: Sequence[int], device,
            cond_comp: Optional[str] = None, cond_val: float = 0.0,
            cond_sgn: str = "+", area_eps: float = 0.0,
            normalize: bool = False) -> np.ndarray:
    """N-coordinate area binning: each fragment landing in a bin of
    coordinate n is re-chopped in coordinate n+1.  Returns the dense host
    [n_bins...] float64 area array.

    Each pass assigns the fragments wholly inside one bin by index
    arithmetic (numpy's ``floor((v - lo) / w)``, w = (hi - lo) / nb, a
    vertex exactly at hi in the last bin) and clips only the fragments
    that cross a bin boundary, bin by bin; the accumulated flat bin index
    rides along as an extra component column (the clipper lerps it
    exactly because it is vertex-constant).  The area sums run on the
    device; the few bins' threshold and normalisation on the host."""
    tris = nodes_on(mef, device)[elements_on(mef, device)]
    if cond_comp is not None:
        tris = clip_tris_halfspace(tris, mef.names.index(cond_comp),
                                   cond_val, keep_ge=(cond_sgn in ("+",
                                                                   "gt")))
    ci = [mef.names.index(n) for n in bin_comps]
    nt = tris.shape[0]
    cur = torch.cat([tris, torch.zeros((nt, 3, 1), dtype=F64,
                                       device=tris.device)], dim=2)
    ID = cur.shape[2] - 1
    for depth, c in enumerate(ci):
        if cur.shape[0] == 0:
            break
        nb = int(n_bins[depth])
        lo, hi = float(bin_min[depth]), float(bin_max[depth])
        edges = np.linspace(lo, hi, nb + 1)
        w = (hi - lo) / nb
        vc = cur[:, :, c]
        bv = torch.floor((vc - lo) / w)
        bv = torch.where(vc == hi, float(nb - 1), bv).to(torch.int64)
        blo = bv.min(dim=1).values
        bhi = bv.max(dim=1).values
        inside = (blo == bhi) & (blo >= 0) & (blo < nb)
        keep = cur[inside]
        keep[:, :, ID] = keep[:, :, ID] * nb + blo[inside, None].to(F64)
        parts = [keep]
        crossing = ~inside & (bhi >= 0) & (blo < nb)
        ct = cur[crossing]
        if ct.shape[0]:
            cblo = torch.clamp(blo[crossing], min=0)
            cbhi = torch.clamp(bhi[crossing], max=nb - 1)
            for b in range(nb):
                m = (cblo <= b) & (cbhi >= b)
                frag = ct[m]
                if frag.shape[0] == 0:
                    continue
                frag = clip_tris_halfspace(frag, c, float(edges[b]),
                                           keep_ge=True)
                frag = clip_tris_halfspace(frag, c, float(edges[b + 1]),
                                           keep_ge=False)
                frag[:, :, ID] = frag[:, :, ID] * nb + b
                parts.append(frag)
        cur = torch.cat(parts)
    prod = int(np.prod(n_bins))
    out = np.zeros(prod)
    if cur.shape[0]:
        ids = torch.round(cur[:, 0, ID]).to(torch.int64)
        tot = torch.zeros(prod, dtype=F64, device=cur.device).index_add_(
            0, ids, tri_areas(cur, mef.ndim)).cpu().numpy()
        out = np.where(tot > area_eps, tot, 0.0)
    out = out.reshape(tuple(int(n) for n in n_bins))
    if normalize and out.sum() > 0:
        out /= out.sum()
    return out


# ---------------------------------------------------------------------------
# sliceMEF / isoMEF: iso-lines of a nodal field on the triangulation
# (isoMEF.cpp:33-132 marching triangles; sliceMEF.cpp:216-412)
# ---------------------------------------------------------------------------

EDGE_PAIRS = ((0, 1), (1, 2), (2, 0))


def iso_lines(nodes: torch.Tensor, elements: torch.Tensor, c: int,
              value: float):
    """Marching triangles: the segment where field ``c`` == value in each
    triangle whose edges it crosses twice.  Returns (seg_nodes [Ns,2,nvars],
    keys [Ns,2]): each end is the lerp along its crossed edge, taken in
    edge order (0,1), (1,2), (2,0), its key the edge's node pair
    lo * n_nodes + hi (the reference's PMap keyed by node pairs,
    isoMEF.cpp:33-100)."""
    f = nodes[:, c]
    fe = f[elements]                                    # [ne,3]
    cross = torch.stack([(fe[:, i] - value) * (fe[:, j] - value) < 0.0
                         for i, j in EDGE_PAIRS], dim=1)
    sel = cross.sum(dim=1) == 2
    e = elements[sel]
    cs = cross[sel]
    nn = nodes.shape[0]
    pairs = torch.tensor(EDGE_PAIRS, device=nodes.device)
    ci = cs.to(torch.int32)
    csum = torch.cumsum(ci, dim=1)
    vals, keys = [], []
    for s in range(2):
        # the s-th crossed edge of each selected triangle
        which = torch.argmax(((csum == s + 1) & cs).to(torch.int32), dim=1)
        ni = torch.gather(e, 1, pairs[which, 0:1])[:, 0]
        nj = torch.gather(e, 1, pairs[which, 1:2])[:, 0]
        fi, fj = f[ni], f[nj]
        t = torch.clamp((value - fi) / torch.where(
            torch.abs(fj - fi) > 1e-300, fj - fi, 1.0), 0.0, 1.0)
        vals.append(nodes[ni] + t[:, None] * (nodes[nj] - nodes[ni]))
        keys.append(torch.minimum(ni, nj) * nn + torch.maximum(ni, nj))
    return torch.stack(vals, dim=1), torch.stack(keys, dim=1)


def iso_mef(mef: MEF, comp_name: str, value: float, device) -> MEF:
    """Contour-on-surface -> segment MEF with exact edge-key node dedup
    (nodes in key order)."""
    nodes = nodes_on(mef, device)
    vals, keys = iso_lines(nodes, elements_on(mef, device),
                           mef.names.index(comp_name), value)
    flat_k = keys.reshape(-1)
    n = flat_k.shape[0]
    uniq, inv = torch.unique(flat_k, return_inverse=True)
    first = torch.full((uniq.shape[0],), n, dtype=torch.int64,
                       device=nodes.device)
    first.scatter_reduce_(0, inv, torch.arange(n, device=nodes.device),
                          reduce="amin")
    out = vals.reshape(-1, vals.shape[-1])[first]
    return host_mef(f"{comp_name}={value:g}", mef.names, out,
                    inv.reshape(-1, 2))


def slice_mef(mef: MEF, direction: int, locs: Sequence[float],
              device) -> List[MEF]:
    """Slice with axis-aligned planes -> polyline contour MEFs per location
    (sliceMEF.cpp:216-221,368-412)."""
    coord = mef.names[direction]
    return [iso_mef(mef, coord, loc, device) for loc in locs]


def assemble_polylines(seg_mef: MEF) -> List[np.ndarray]:
    """Chain segments into polylines (MakeCLines analog,
    isosurface.cpp:1159-1271).  Returns node-index chains; closed loops
    repeat their first node at the end.  Host numpy, a copy of the JAX
    package's.

    Array-based for manifold contours (every node on <=2 segments — the
    marching-squares output): directed-edge successor arrays + pointer
    doubling give each segment its (chain root, position) in O(ne log ne)
    vectorized work, no per-segment Python.  Junction nodes (degree >=3)
    fall back to the greedy walk."""
    segs = np.asarray(seg_mef.elements, dtype=np.int64)
    ne = len(segs)
    if ne == 0:
        return []
    n_nodes = int(segs.max()) + 1
    deg = np.bincount(segs.ravel(), minlength=n_nodes)
    if deg.max() > 2:
        return _assemble_polylines_walk(seg_mef)

    # directed edge ids: 2s = a->b (tail a, head b); 2s+1 = b->a.
    # incidence slot ids coincide: slot 2s holds a (tail of 2s, head of
    # 2s+1), slot 2s+1 holds b — so slot sl is the head of (sl^1) and the
    # tail of sl.
    m = 2 * ne
    order = np.argsort(segs.ravel(), kind="stable")
    starts_of = np.concatenate([[0], np.cumsum(deg)])[:-1]
    nxt = np.full(m, -1, dtype=np.int64)
    two = np.nonzero(deg == 2)[0]
    if len(two):
        s1 = order[starts_of[two]]       # the node's two incidence slots
        s2 = order[starts_of[two] + 1]
        nxt[s1 ^ 1] = s2                 # arrive via s1's segment, leave s2
        nxt[s2 ^ 1] = s1

    def _pred_of(nx):
        pr = np.full(m, -1, dtype=np.int64)
        has = nx >= 0
        pr[nx[has]] = np.nonzero(has)[0]
        return pr

    rounds = max(1, int(np.ceil(np.log2(max(m, 2)))) + 1)

    def _roots_depths(pr):
        """(root, depth) per directed edge by pointer doubling; edges in
        cycles come back with root == -1."""
        root = np.full(m, -1, dtype=np.int64)
        is_root = pr < 0
        root[is_root] = np.nonzero(is_root)[0]
        ptr = pr.copy()
        dist = (pr >= 0).astype(np.int64)
        for _ in range(rounds):
            live = np.nonzero(ptr >= 0)[0]
            if len(live) == 0:
                break
            p = ptr[live]
            rp = root[p]
            done = rp >= 0
            root[live[done]] = rp[done]
            dist[live] += dist[p]
            ptr[live] = ptr[p]
        return root, dist

    pred = _pred_of(nxt)
    root, depth = _roots_depths(pred)

    dropped_roots: set = set()
    closed_roots: set = set()
    if (root < 0).any():
        # cycles: each loop appears as two directed cycles with
        # complementary ids.  The cycle containing 2*min_segment has an
        # EVEN min id (the mirror's min is that id + 1) — keep even-min
        # cycles, cut every cycle just before its min edge, re-ladder.
        cyc = np.nonzero(root < 0)[0]
        mn = np.arange(m, dtype=np.int64)
        jump = nxt.copy()
        for _ in range(rounds):
            ok = jump[cyc] >= 0
            c = cyc[ok]
            mn[c] = np.minimum(mn[c], mn[jump[c]])
            jump[c] = jump[jump[c]]
        cyc_roots = np.unique(mn[cyc])
        closed_roots = set(int(r) for r in cyc_roots[(cyc_roots & 1) == 0])
        dropped_roots = set(int(r) for r in cyc_roots[(cyc_roots & 1) == 1])
        nxt[pred[cyc_roots]] = -1
        pred = _pred_of(nxt)
        root, depth = _roots_depths(pred)

    # one direction per open chain: the mirror chain's root is
    # (terminal ^ 1); keep the smaller root.  Loops already emit once.
    ordered = np.lexsort((depth, root))
    r_sorted = root[ordered]
    bounds = np.nonzero(np.diff(r_sorted))[0] + 1
    chain_starts = np.concatenate([[0], bounds])
    chain_ends = np.concatenate([bounds, [len(ordered)]]) - 1
    out: List[np.ndarray] = []
    for cs, ce in zip(chain_starts, chain_ends):
        r = int(r_sorted[cs])
        if r in dropped_roots:
            continue
        if r not in closed_roots and (int(ordered[ce]) ^ 1) < r:
            continue                     # mirror chain wins
        edges = ordered[cs: ce + 1]
        chain = np.empty(len(edges) + 1, dtype=np.int64)
        chain[0] = segs[r >> 1, r & 1]                  # tail of root
        chain[1:] = segs[edges >> 1, 1 - (edges & 1)]   # heads in order
        out.append(chain)
    return out


def _assemble_polylines_walk(seg_mef: MEF) -> List[np.ndarray]:
    """Greedy walk (handles junction nodes of any degree)."""
    from collections import defaultdict
    adj = defaultdict(list)
    for si, (a, b) in enumerate(seg_mef.elements):
        adj[int(a)].append((int(b), si))
        adj[int(b)].append((int(a), si))
    used = np.zeros(seg_mef.n_elts, dtype=bool)
    lines = []
    # start at odd-degree nodes (open lines) then loops
    starts = [n for n, nb in adj.items() if len(nb) == 1]
    starts += list(adj.keys())
    for s in starts:
        for nxt, si in adj[s]:
            if used[si]:
                continue
            chain = [s]
            cur, edge = nxt, si
            used[edge] = True
            chain.append(cur)
            progressing = True
            while progressing:
                progressing = False
                for nb, si2 in adj[cur]:
                    if not used[si2]:
                        used[si2] = True
                        cur = nb
                        chain.append(cur)
                        progressing = True
                        break
            lines.append(np.array(chain))
    return lines


# ---------------------------------------------------------------------------
# smoothMEF (smoothMEF.cpp:95-180)
# ---------------------------------------------------------------------------

def smooth_mef(mef: MEF, comps: Sequence[str], device,
               n_iter: int = 1) -> MEF:
    """Area-weighted neighbor averaging of node values: each node takes the
    area-weighted mean of the element averages of its incident elements."""
    nodes = nodes_on(mef, device)
    e = elements_on(mef, device)
    areas = element_areas(nodes, e, mef.ndim)
    ci = [mef.names.index(n) for n in comps]
    nn = mef.n_nodes
    for _ in range(n_iter):
        for c in ci:
            elt_mean = sum3(nodes[:, c][e]) / 3.0
            num = torch.zeros(nn, dtype=F64, device=nodes.device)
            den = torch.zeros(nn, dtype=F64, device=nodes.device)
            for k in range(3):
                num.index_add_(0, e[:, k], elt_mean * areas)
                den.index_add_(0, e[:, k], areas)
            nodes[:, c] = num / torch.clamp(den, min=1e-300)
    return host_mef(mef.label, mef.names, nodes, e)
