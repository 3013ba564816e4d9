"""``streamTubeStats`` — statistics over triangular-prism "stream tubes"
bounded by 3 neighboring streamlines (reference
Src/streamTubeStats.cpp, serial-only there, streamTubeStats.cpp:306-307).

Counterpart of ``peleanalysis_tpu/tools/stream_tube_stats.py``, in torch
on ``device=`` (default ``cuda``), float64.  Per element (a seed-surface
triangle whose corners are streamlines):
  * volume: sum over arclength stations of the wedge volumes (3-tet
    decomposition of each triangular prism; wedge_volume_int analog,
    streamTubeStats.cpp:666-686), all stations of a chunk at once
  * area: seed-triangle area (wedge_surf_area at the seed station, :665)
  * per intComp: volume integral of the field, divided by the seed area
    (:694-698); area_wtAvg accumulates int*mid-area for the first intComp
  * smoothedInt: nSmooth passes of area-weighted node-neighbor averaging of
    the first intComp (smoothVals, :275-299, 784-790)
  * per avgComp: mean of the 3 lines' SEED values (:703-712)
  * per gradComp: mean over corners of each line's max |d(comp)/ds|
  * per peakComp: mean over corners of each line's max value, with a
    "<name>_peakOK" flag = 1 when every corner's peak is interior
  * compsAtPeakFCR: line values at the FCRComp peak station, averaged
Output: MEF with element-centered values duplicated at the element's nodes
(Docs/source/streamTubeStats.rst), and/or Tecplot.  The station sums run
in another order than the JAX tool's station loop (each chunk's stations
summed at once), so volumes and integrals agree with it to rounding.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..io.mef import MEF, read_mef, write_mef, write_mef_tecplot
from ..ops.vec3 import cross, sum3, triangle_areas
from ..parmparse import ParmParse
from ..session import read_stream
from ..stream.surface import arc_length

F64 = torch.float64
# device bytes a chunk of stations may take in wedge_volumes_ints: the
# gathered corners and about twenty element-by-station temporaries
CHUNK_BYTES = 1 << 30


def _tet_vol(a, b, c, d):
    return sum3(cross(b - a, c - a) * (d - a)) / 6.0


def stations_per_chunk(ne: int, n_cols: int) -> int:
    """Station intervals a chunk of ``wedge_volumes_ints`` holds for ``ne``
    elements and ``n_cols`` gathered components, within CHUNK_BYTES."""
    per_station = ne * 8 * (3 * n_cols + 24)
    return max(1, CHUNK_BYTES // max(per_station, 1))


def wedge_volumes_ints(lines: torch.Tensor, elements: torch.Tensor,
                       comp_idx: Sequence[int]):
    """Per element: total tube volume, per-comp volume integrals and the
    first comp's integral weighted by the mid-station area.
    lines [nl, npts, nv]; elements [ne, 3] int64 on the lines' device.
    The station intervals go in chunks of ``stations_per_chunk``: each
    chunk gathers its element corners [ne, 3, s+1, 3 + len(comp_idx)]
    once and sums its stations' wedges."""
    ne = elements.shape[0]
    npts = lines.shape[1]
    dev = lines.device
    cols = [0, 1, 2, *comp_idx]
    vol = torch.zeros(ne, dtype=F64, device=dev)
    ints = torch.zeros((ne, len(comp_idx)), dtype=F64, device=dev)
    wa = torch.zeros(ne, dtype=F64, device=dev)
    step = stations_per_chunk(ne, len(cols))
    for j0 in range(0, npts - 1, step):
        j1 = min(j0 + step, npts - 1)
        C = lines[:, j0: j1 + 1][:, :, cols][elements]  # [ne,3,s+1,nc]
        p = [C[:, k, :-1, :3] for k in range(3)]       # [ne,s,3]
        q = [C[:, k, 1:, :3] for k in range(3)]
        tets = ((p[0], p[1], p[2], q[0]),
                (p[1], p[2], q[0], q[1]),
                (p[2], q[0], q[1], q[2]))
        vjs = [torch.abs(_tet_vol(*t)) for t in tets]   # [ne,s] each
        vol += ((vjs[0] + vjs[1]) + vjs[2]).sum(dim=1)
        if not comp_idx:
            continue
        a_mid = 0.5 * (triangle_areas(*p) + triangle_areas(*q))
        for kk in range(len(comp_idx)):
            fp = [C[:, k, :-1, 3 + kk] for k in range(3)]
            fq = [C[:, k, 1:, 3 + kk] for k in range(3)]
            corners = ((fp[0], fp[1], fp[2], fq[0]),
                       (fp[1], fp[2], fq[0], fq[1]),
                       (fp[2], fq[0], fq[1], fq[2]))
            acc = torch.zeros_like(vjs[0])
            for vj, (f0, f1, f2, f3) in zip(vjs, corners):
                acc = acc + vj * ((((f0 + f1) + f2) + f3) / 4.0)
            ints[:, kk] += acc.sum(dim=1)
            if kk == 0:
                # area_wtAvg: int * mid-area for the first intComp
                # (:680-686)
                wa += (acc * a_mid).sum(dim=1)
    return vol, ints, wa


def element_adjacency_pairs(elements: torch.Tensor,
                            n_nodes: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Deduplicated element-adjacency pair list (a, b): element b shares at
    least one node with element a (self included once).  Group
    node->element incidence, emit all within-group pairs, unique.
    Pair count ~ ne x mean 1-ring size (~13 for a manifold
    triangulation)."""
    ne, k = elements.shape
    dev = elements.device
    inc_n = elements.reshape(-1)
    inc_e = torch.arange(ne, device=dev).repeat_interleave(k)
    order = torch.argsort(inc_n, stable=True)
    n_sorted = inc_n[order]
    e_sorted = inc_e[order]
    counts = torch.bincount(n_sorted, minlength=n_nodes)
    starts = torch.cumsum(counts, 0) - counts
    # each incidence slot (node g, element a) contributes a run of that
    # node's full element list: a repeated s times, b the group's slots
    rep = counts[n_sorted]
    tot = int(rep.sum())
    a = e_sorted.repeat_interleave(rep)
    run_off = torch.cumsum(rep, 0) - rep
    idx = (torch.arange(tot, device=dev) - run_off.repeat_interleave(rep)
           + starts[n_sorted].repeat_interleave(rep))
    b = e_sorted[idx]
    # dedup (a,b) across shared nodes — the reference's per-element `seen`
    # set (streamTubeStats.cpp:284-293) counts each neighbor once even
    # when it shares 2-3 nodes
    key = torch.unique(a * ne + b)
    return key // ne, key % ne


def _scatter_sum(ids: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=F64, device=w.device).index_add_(0, ids, w)


def smooth_values(vals: torch.Tensor, areas: torch.Tensor,
                  elements: torch.Tensor, n_nodes: int,
                  n_smooth: int) -> torch.Tensor:
    """Area-weighted node-neighbor elemental smoothing (smoothVals,
    streamTubeStats.cpp:275-299): each element averages over elements
    sharing any of its nodes, each neighbor counted ONCE even when it
    shares 2-3 nodes (the reference's per-element `seen` set).

    By inclusion-exclusion over segment sums: a neighbor sharing m nodes
    appears m times in the node-incidence sum, C(m,2) times in the
    edge-incidence sum and C(m,3) times in the same-triple sum, and
    m - C(m,2) + C(m,3) = 1 for m in {1,2,3} — so acc = sum_nodes S_n -
    sum_edges S_e + S_triple, three scatter/gather passes, O(ne) per
    iteration.  Degenerate elements (repeated nodes) take an explicit
    deduplicated pair list."""
    if n_smooth <= 0:
        return vals.clone()
    ne = elements.shape[0]
    e = elements
    degenerate = bool(((e[:, 0] == e[:, 1]) | (e[:, 1] == e[:, 2])
                       | (e[:, 0] == e[:, 2])).any())
    if degenerate:
        pa, pb = element_adjacency_pairs(e, n_nodes)
        wacc = torch.clamp(_scatter_sum(pa, areas[pb], ne), min=1e-300)
        out = vals.clone()
        for _ in range(n_smooth):
            out = _scatter_sum(pa, out[pb] * areas[pb], ne) / wacc
        return out
    # segment ids: nodes (given), undirected edges, sorted node triples
    es = torch.sort(e, dim=1).values
    edge_keys = torch.stack([es[:, 0] * n_nodes + es[:, 1],
                             es[:, 1] * n_nodes + es[:, 2],
                             es[:, 0] * n_nodes + es[:, 2]], dim=1)
    ue, edge_id = torch.unique(edge_keys, return_inverse=True)
    pair12 = torch.unique(es[:, 0] * n_nodes + es[:, 1],
                          return_inverse=True)[1]
    ut, tri_id = torch.unique(pair12 * n_nodes + es[:, 2],
                              return_inverse=True)
    n_edges, n_tris = ue.shape[0], ut.shape[0]
    flat_e, flat_edge = e.reshape(-1), edge_id.reshape(-1)

    def one_ring_sum(w):
        w3 = w.repeat_interleave(3)
        s_node = _scatter_sum(flat_e, w3, n_nodes)
        s_edge = _scatter_sum(flat_edge, w3, n_edges)
        s_tri = _scatter_sum(tri_id, w, n_tris)
        return sum3(s_node[e]) - sum3(s_edge[edge_id]) + s_tri[tri_id]

    wacc = torch.clamp(one_ring_sum(areas), min=1e-300)
    out = vals.clone()
    for _ in range(n_smooth):
        out = one_ring_sum(out * areas) / wacc
    return out


def corner_mean(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The mean of a per-line value over each element's 3 corners."""
    return sum3(x[e]) / 3.0


def main(args: dict) -> None:
    """CLI: streamTubeStats infile=<StreamData> [intComps=] [avgComps=]
    [gradComps=] [peakComp=] [FCRComp= compsAtPeakFCR= namesAtPeakFCR=]
    [aux_mef= aux_mef_comps=] [nSmooth=0] [jlo=] [write_mef=1]
    [write_tec=0] [outfile=] [device=cuda|cpu]"""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    dev = config.get_device(pp.query_str("device", "cuda"))
    sd = read_stream(args, infile)
    names = sd.names
    if len(sd.elements) == 0:
        raise ValueError("streamTubeStats requires element connectivity")
    lines = torch.as_tensor(sd.lines, dtype=F64, device=dev)
    elements = torch.as_tensor(np.asarray(sd.elements, np.int64),
                               device=dev)
    mid = (lines.shape[1] - 1) // 2
    if pp.contains("jlo"):
        # restrict stations to j in [jlo, -jlo] around the seed
        # (streamTubeStats.cpp:566-567: nPts = -2*jlo + 1)
        jlo = pp.get_int("jlo")
        if jlo > 0:
            jlo = -jlo
        if -jlo < mid:
            lines = lines[:, mid + jlo: mid - jlo + 1]
            mid = (lines.shape[1] - 1) // 2

    def resolve(toks):
        return [names[int(t)] if t.isdigit() else t for t in toks]

    int_names = resolve(pp.query_str_list("intComps", []))
    avg_names = resolve(pp.query_str_list("avgComps", []))
    grad_names = resolve(pp.query_str_list("gradComps", []))
    peak_names = resolve(pp.query_str_list("peakComp", []))
    fcr = pp.query_int("FCRComp", -1)
    pfcr_names = resolve(pp.query_str_list("compsAtPeakFCR", []))
    pfcr_out = pp.query_str_list("namesAtPeakFCR", pfcr_names)
    n_smooth = pp.query_int("nSmooth", 0)

    ci_int = [names.index(n) for n in int_names]
    vol, ints, wa = wedge_volumes_ints(lines, elements, ci_int)
    p = lines[:, mid, :3]
    e = elements
    area = triangle_areas(p[e[:, 0]], p[e[:, 1]], p[e[:, 2]])
    ints_n = ints / torch.clamp(area[:, None], min=1e-300)

    # per-line quantities
    nl, npts = lines.shape[0], lines.shape[1]
    r = torch.arange(nl, device=dev)
    s = arc_length(lines)
    ds = torch.clamp(s[:, 1:] - s[:, :-1], min=1e-300)
    per_line = {}
    for n in grad_names:
        c = names.index(n)
        g = torch.abs(lines[:, 1:, c] - lines[:, :-1, c]) / ds
        per_line[("grad", n)] = g.max(dim=1).values
    for n in peak_names:
        c = names.index(n)
        jpk = torch.argmax(lines[:, :, c], dim=1)
        per_line[("peak", n)] = lines[r, jpk, c]
        per_line[("peakOK", n)] = ((jpk > 0) & (jpk < npts - 1)).to(F64)
    if fcr >= 0:
        jf = torch.argmax(lines[:, :, fcr], dim=1)
        for n in pfcr_names:
            per_line[("pfcr", n)] = lines[r, jf, names.index(n)]

    aux_vals = {}
    if pp.contains("aux_mef") and pp.query_str("aux_mef", "null") != "null":
        aux = read_mef(pp.get_str("aux_mef"))
        for t in pp.get_str_list("aux_mef_comps"):
            n = aux.names[int(t)] if t.isdigit() else t
            aux_vals[n] = torch.as_tensor(aux.field(n), dtype=F64,
                                          device=dev)

    out_names = ["volume", "area", "area_wtAvg", "smoothedInt"]
    first = ints_n[:, 0] if ci_int else vol
    sm = smooth_values(first, area, e, nl, n_smooth) if n_smooth > 0 \
        else first
    cols = [vol, area, wa, sm]
    for i, n in enumerate(int_names):
        out_names.append(n + "_int")
        cols.append(ints_n[:, i])
    for n in avg_names:
        out_names.append(n + "_avg")
        cols.append(corner_mean(lines[:, mid, names.index(n)], e))
    for n in aux_vals:
        out_names.append(n + "_avg")
        cols.append(corner_mean(aux_vals[n], e))
    for n in grad_names:
        out_names.append(n + "_gradMax")
        cols.append(corner_mean(per_line[("grad", n)], e))
    for n in peak_names:
        out_names.append(n + "_peak")
        cols.append(corner_mean(per_line[("peak", n)], e))
    for n in peak_names:
        out_names.append(n + "_peakOK")
        cols.append(per_line[("peakOK", n)][e].min(dim=1).values)
    for n, on in zip(pfcr_names, pfcr_out):
        out_names.append(on + "_at_peakFCR")
        cols.append(corner_mean(per_line[("pfcr", n)], e))

    # element-centered MEF: duplicate values at each element's 3 nodes
    ne = e.shape[0]
    pos = p[e.reshape(-1)]                               # [3*ne, 3]
    evals = torch.stack(cols, dim=1)                     # [ne, ncomp]
    nodes = torch.cat([pos, evals.repeat_interleave(3, dim=0)], dim=1)
    conn = np.arange(3 * ne, dtype=np.int32).reshape(ne, 3)
    mef = MEF("streamTubeStats", ["X", "Y", "Z"] + out_names,
              nodes.cpu().numpy(), conn)
    outfile = pp.query_str("outfile", infile + "_tubeStats")
    if pp.query_bool("write_mef", True):
        write_mef(outfile + ".mef", mef)
        print(f"wrote {outfile}.mef")
    if pp.query_bool("write_tec", False):
        write_mef_tecplot(outfile + ".dat", mef)
        print(f"wrote {outfile}.dat")
