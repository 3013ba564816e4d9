"""``sampleStreamlines`` — re-sample plotfile fields onto existing
streamlines (the reference's Src/sampleStreamlines.cpp +
sampleStreamlines_nd.f90 interpstream).

Counterpart of ``peleanalysis_tpu/tools/sample_streamlines.py`` (dense
path).  Each line is sampled in the level that owns its seed, from a grown
dense array covering the line extents (the reference's nGrow strategy),
with the same trilinear math as tracing.  Memory-limited component groups
(nCompsPerPass) chunk the sampled variable list.  Sparse refinement (the
finest union bbox wasting >4x its cells) samples cluster by cluster
(``sample_onto_lines_sparse``; JAX :64-101).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..amr.cluster import cluster_substates, clustered
from ..amr.dense import DenseAmrState
from ..io.stream_data import StreamData, write_stream_data
from ..ops.dense_fill import fill_dense_arrays
from ..parmparse import ParmParse
from ..session import dense_state, load_state, read_stream, var_names
from ..stream.surface import arc_length
from ..stream.trace import (_sample_fields, assign_seeds_to_levels,
                            finest_cluster_of)
from .grad import refuse_unported
from .stream import write_tecplot_lines


def sample_onto_lines(ds: DenseAmrState, lines: np.ndarray,
                      names) -> np.ndarray:
    """Sample components ``names`` of ds at every line point.
    Returns float64 [nl, npts, len(names)]."""
    meta = ds.meta
    comps = [ds.comp(n) for n in names]
    masks = [ds.in_level_mask(l) for l in range(meta.n_levels)]
    data = [d[comps] for d in ds.data]
    seeds = lines[:, (lines.shape[1] - 1) // 2, :3]
    owner = assign_seeds_to_levels(ds, seeds)
    out = np.zeros(lines.shape[:2] + (len(names),))
    for lev in range(meta.n_levels):
        sel = np.nonzero(owner == lev)[0]
        if len(sel) == 0:
            continue
        geom = meta.geoms[lev]
        dx = np.array(geom.dx)
        bbox = ds.lmeta[lev].bbox
        # ghost radius covering the selected lines' extents
        pts = lines[sel][:, :, :3].reshape(-1, 3)
        plo = np.array(geom.prob_lo)
        lo_cell = np.floor((pts.min(axis=0) - plo) / dx).astype(int) \
            + np.array(geom.domain.lo)
        hi_cell = np.floor((pts.max(axis=0) - plo) / dx).astype(int) \
            + np.array(geom.domain.lo)
        g = int(max(np.maximum(np.array(bbox.lo) - lo_cell, 0).max(),
                    np.maximum(hi_cell - np.array(bbox.hi), 0).max())) + 2
        grown = fill_dense_arrays(meta, ds.lmeta, data, masks, lev, g,
                                  None, "linear")
        gbox = bbox.grow(g)
        plo_g = plo + (np.array(gbox.lo) - np.array(geom.domain.lo)) * dx
        pos = torch.from_numpy(np.ascontiguousarray(lines[sel][:, :, :3]))
        vals = _sample_fields(grown, plo_g, dx, pos.to(ds.device, ds.dtype))
        out[sel] = vals.cpu().numpy()
    return out


def sample_onto_lines_sparse(base: DenseAmrState, fin_fabs,
                             lines: np.ndarray, names) -> np.ndarray:
    """Sparse refinement sampling (JAX :64-101): the lines are partitioned
    by the finest-level cluster holding their seed, and each cluster's lines
    are sampled on its substate of the coarse-only ``base`` (``fin_fabs``
    the finest level's per-box host arrays).  Clusters are separated by the
    largest distance any line wanders from its seed, in finest cells, + 3,
    so each cluster's grown fill is exact.  Lines with no owning cluster are
    sampled on the first cluster's substate, as in the JAX package: its
    coarse levels are the global ones."""
    meta = base.meta
    fin = meta.n_levels - 1
    out = np.zeros(lines.shape[:2] + (len(names),))
    if lines.shape[0] == 0:
        return out
    seeds = lines[:, (lines.shape[1] - 1) // 2, :3]
    reach = np.abs(lines[:, :, :3] - seeds[:, None]).max() \
        / min(meta.geoms[fin].dx)
    groups, subs = cluster_substates(base, fin_fabs,
                                     dist=int(np.ceil(reach)) + 3)
    cluster_of = finest_cluster_of(meta, groups, seeds)
    for gi in range(len(groups)):
        sels = [np.nonzero(cluster_of == gi)[0]]
        if gi == 0:
            sels.append(np.nonzero(cluster_of < 0)[0])
        sels = [sel for sel in sels if len(sel)]
        if sels:
            sub = subs[gi]
            for sel in sels:
                out[sel] = sample_onto_lines(sub, lines[sel], names)
            del sub
    return out


def main(args: dict) -> None:
    """CLI: sampleStreamlines plotfile= pathFile= [comps=... | sComp= nComp=]
    [nCompsPerPass=-1] [streamSampleFile= | outfile= | outFile=]
    [is_per=1 1 1] [finestLevel=] [force_dense=0] [cluster_batch=0]
    [device=cuda|cpu].  Loads float64."""
    pp = ParmParse(args)
    plotfile = pp.get_str("plotfile")
    path_file = pp.get_str("pathFile")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    sd = read_stream(args, path_file)

    avail = var_names(args, plotfile)
    if pp.contains("comps"):
        names = [avail[int(c)] if c.isdigit() else c
                 for c in pp.get_str_list("comps")]
    else:
        s = pp.query_int("sComp", 0)
        n = pp.query_int("nComp", len(avail))
        names = avail[s: s + n]

    per_pass = pp.query_int("nCompsPerPass", -1)
    if per_pass <= 0:
        per_pass = len(names)
    # reference default: periodic in every dim (sampleStreamlines.cpp:163)
    is_per = [bool(p) for p in pp.query_int_list("is_per", [1, 1, 1])]
    finest = pp.query_int("finestLevel", None)
    sampled = []
    for i in range(0, len(names), per_pass):
        grp = names[i: i + per_pass]
        src = load_state(args, plotfile, names=grp, max_level=finest,
                         is_periodic=is_per, dtype=torch.float64,
                         device=device)
        if clustered(src.meta, pp, [src.meta.n_levels - 1]):
            print("sampleStreamlines: sparse refinement -> clustered path")
            base = DenseAmrState.coarse_only(src.meta, src.names, src.fabs,
                                             device, torch.float64)
            sampled.append(sample_onto_lines_sparse(base, src.fabs[-1],
                                                    sd.lines, grp))
        else:
            ds = dense_state(args, src, device, torch.float64)
            sampled.append(sample_onto_lines(ds, sd.lines, grp))
    # the reference schema is X,Y,Z, distance_from_seed, <vars>
    # (sampleStreamlines.cpp:145,203): signed arclength, zero at the seed
    s = arc_length(sd.lines)
    mid = (sd.lines.shape[1] - 1) // 2
    dist = (s - s[:, mid:mid + 1])[:, :, None]
    new_lines = np.concatenate([sd.lines[:, :, :3], dist] + sampled, axis=2)
    new_names = ["X", "Y", "Z", "distance_from_seed"] + names
    out_sd = StreamData(new_names, sd.elements, sd.inside_nodes, new_lines)
    if pp.contains("streamSampleFile") or pp.contains("outfile"):
        dst = pp.query_str("streamSampleFile", None) \
            or pp.get_str("outfile")   # reference key (sampleStreamlines.cpp:130)
        write_stream_data(dst, out_sd)
        print(f"wrote {dst}")
    elif pp.contains("outFile"):
        write_tecplot_lines(pp.get_str("outFile"), new_names, new_lines)
        print(f"wrote {pp.get_str('outFile')}")
    else:
        raise ValueError("Must specify streamSampleFile or outFile")
