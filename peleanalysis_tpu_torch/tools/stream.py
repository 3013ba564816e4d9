"""``stream`` — streamlines from seed points through AMR fields.

Counterpart of ``peleanalysis_tpu/tools/stream.py`` (dense path), itself the
replacement for the reference's Src/stream.cpp + stream_nd.f90.  CLI keys
follow stream.cpp:409-969: plotfile, seeds from isoFile (MEF) / seedLoc /
seedRakeL+seedRakeR(+seedRakeNum), progressName (gradient tracing) or
traceAlongV, nRKsteps, hRK, aux_comps sampled onto lines, streamFile
(StreamData out) and/or outFile (Tecplot dump); buildAltSurf + altVal + dt +
thermal-thickness / cold-strain / angle decorators (stream.cpp:973-1107).
Every march runs the CUDA kernel on the card (``stream/march_kernels.py``).
Sparse refinement (the finest union bbox wasting >4x its cells) traces
cluster by cluster (``trace_streamlines_sparse``; JAX :132-185).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..amr.cluster import clustered
from ..amr.dense import DenseAmrState
from ..io.mef import MEF, read_mef, write_mef
from ..io.stream_data import StreamData, compute_inside_nodes, write_stream_data
from ..native import tecplot_zones
from ..parmparse import ParmParse
from ..session import (dense_state, get_session, load_state, stage_submit_io,
                       stage_writes, var_names)
from ..stream import surface as surf
from ..stream.trace import (seed_rake, trace_streamlines,
                            trace_streamlines_sparse)
from .grad import refuse_unported


def get_seeds(pp: ParmParse, sess=None):
    """Seed cloud and a thunk of its connectivity (stream.cpp:450-532).  A
    surface registered in ``sess`` under the isoFile name serves it: from
    a ``DeferredSurface`` the positions copy only the xyz columns, and the
    elements are copied only when an output needs them."""
    if pp.contains("isoFile"):
        name = pp.get_str("isoFile")
        mef = sess.get_surface(name) if sess is not None else None
        if mef is None:
            mef = read_mef(name)
        return mef.positions(), (lambda: mef.elements)
    empty = np.zeros((0, 3), np.int32)
    if pp.contains("seedLoc"):
        loc = pp.get_float_list("seedLoc")
        return np.array([loc[:3]]), (lambda: empty)
    if pp.contains("seedRakeL"):
        n = pp.query_int("seedRakeNum", 10)
        seeds = seed_rake(pp.get_float_list("seedRakeL")[:3],
                          pp.get_float_list("seedRakeR")[:3], n)
        return seeds, (lambda: empty)
    raise ValueError("must specify one of isoFile / seedLoc / seedRakeL+R")


def write_tecplot_lines(path: str, names, lines: np.ndarray) -> None:
    """Per-line Tecplot zones (dump_ml_streamline_data analog,
    stream.cpp:2227-2302), formatted in one native snprintf pass
    (``native/fmt.cpp``): the JAX tool's ``%.9g`` text byte for byte."""
    with open(path, "wb") as f:
        f.write(("VARIABLES = " + " ".join(names) + "\n").encode())
        f.write(tecplot_zones(np.asarray(lines, np.float64)))


def main(args: dict) -> None:
    """CLI: stream plotfile= (isoFile=<MEF> | seedLoc=x y z |
    seedRakeL=.. seedRakeR=.. [seedRakeNum=10]) [progressName=temp |
    traceAlongV=1] [nRKsteps=51] [hRK=0.1] [aux_comps=...] [nGrow=]
    [bounds=lo..hi..] [marchEngine=auto|pallas|xla|cuda|torch (the
    kernel on the card, the plain version on the CPU; cuda and torch only
    assert the device)] [marchPrecision=bfloat16] [fetch_precision=auto|exact|
    compressed] (streamFile=<StreamData out> and/or outFile=<Tecplot out>)
    [sd_version=0|1.0] [buildAltSurf=1 altVal= dt= thickCompName= thickLo=
    thickHi= strainCompName= TCompName= TVal= addAngle= altIsoFile=]
    [force_dense=0] [cluster_batch=0] [device=cuda|cpu].  The plotfile
    loads in float64 whatever dtype=."""
    pp = ParmParse(args)
    verbose = pp.query_int("verbose", 0)
    plotfile = pp.get_str("plotfile")
    progress_name = pp.query_str("progressName", "temp")
    trace_along_v = pp.query_bool("traceAlongV", False)
    n_rk = pp.query_int("nRKsteps", 51)
    h_rk = pp.query_float("hRK", 0.1)
    finest = pp.query_int("finestLevel", None)
    is_per = pp.query_int_list("is_per", [0, 0, 0])
    aux = pp.query_str_list("aux_comps", [])
    build_alt = pp.query_bool("buildAltSurf", False)
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    if not pp.contains("streamFile") and not pp.contains("outFile"):
        raise ValueError("Must specify streamFile or outFile")

    avail = var_names(args, plotfile)
    if pp.contains("aux_sComp") or pp.contains("aux_nComp"):
        # reference-style aux comp range (stream.cpp:645-653)
        s = pp.query_int("aux_sComp", 0)
        aux = aux + [v for v in avail[s: s + pp.query_int("aux_nComp", 0)]
                     if v not in aux]
    vel = [v for v in ("x_velocity", "y_velocity", "z_velocity")
           if v in avail]
    load = ([progress_name] if not trace_along_v else list(vel))
    sample = [progress_name] + [a for a in aux if a != progress_name]
    if build_alt:
        for v in vel:
            if v not in sample:
                sample.append(v)
        for extra in (pp.query_str("thickCompName", ""),
                      pp.query_str("strainCompName", ""),
                      pp.query_str("TCompName", "")):
            if extra and extra not in sample:
                sample.append(extra)
    load = load + [s for s in sample if s not in load]

    sess = get_session(args)
    src = load_state(args, plotfile, names=load, max_level=finest,
                     is_periodic=[bool(p) for p in is_per],
                     dtype=torch.float64, device=device)
    meta = src.meta
    sparse = clustered(meta, pp, [meta.n_levels - 1])
    if sparse:
        print("stream: sparse refinement detected -> clustered path")
        ds = DenseAmrState.coarse_only(meta, src.names, src.fabs, device,
                                       torch.float64)
    else:
        ds = dense_state(args, src, device, torch.float64, load)
    seeds, get_elts = get_seeds(pp, sess)
    if pp.contains("bounds"):
        # limit seed points to a physical sub-box, dropping elements that
        # lose a node (trim_surface, stream.cpp:217-291 + 543-560)
        barr = pp.get_float_list("bounds")
        keep = np.all((seeds >= np.asarray(barr[:3]))
                      & (seeds <= np.asarray(barr[3:6])), axis=1)
        renum = np.cumsum(keep) - 1
        elements = np.asarray(get_elts())
        if len(elements):
            e_keep = keep[elements].all(axis=1)
            elements = renum[elements[e_keep]]
        get_elts = (lambda e=elements: e)
        seeds = seeds[keep]
        if verbose:
            print(f"bounds trim: {keep.sum()}/{len(keep)} seeds kept")

    # fetch_precision=exact forces exact line payloads; auto packs them
    # lossily exactly when the field is marched in bfloat16
    fcomp = {"exact": False, "compressed": True, "auto": None}[
        pp.query_str("fetch_precision", "auto")]
    kw = dict(trace_field=None if trace_along_v else progress_name,
              sample_names=sample,
              march_dtype=pp.query_str("marchPrecision", None),
              march_engine=pp.query_str("marchEngine", "auto"),
              ngrow=pp.query_int("nGrow", None), fetch_compress=fcomp)
    if sparse:
        lines = trace_streamlines_sparse(ds, src.fabs[-1], seeds, n_rk,
                                         h_rk, **kw)
    else:
        lines = trace_streamlines(ds, seeds, n_rk, h_rk, **kw)
    del ds
    names = ["X", "Y", "Z"] + sample

    if sess is not None:
        out_name = (pp.query_str("streamFile", None)
                    or pp.query_str("outFile", None))
        sess.put_lines(out_name, names, lines, get_elts, meta)
    writes = stage_writes(args)
    if pp.contains("streamFile") and writes:
        inside = compute_inside_nodes(meta, lines[:, lines.shape[1] // 2, :3])
        sd = StreamData(names, np.asarray(get_elts(), np.int32), inside,
                        lines)
        sf, sv = pp.get_str("streamFile"), pp.query_str("sd_version", "0")
        # host work over host arrays: write-back eligible
        stage_submit_io(args, sf, lambda: write_stream_data(
            sf, sd, meta=meta, version=sv))
        print(f"wrote {sf}")
    if pp.contains("outFile") and writes:
        of = pp.get_str("outFile")
        stage_submit_io(args, of,
                        lambda: write_tecplot_lines(of, names, lines))
        print(f"wrote {of}")

    if build_alt:
        alt_val = pp.get_float("altVal")
        dt = pp.query_float("dt", 0.0)
        pts, found, dist = surf.build_surface_at_isoval(
            lines, names, progress_name, alt_val, with_distance=True)
        out_names = list(names) + ["distance_iso_to_alt"]
        cols = [pts, dist[:, None]]
        if pp.query_str("thickCompName", ""):
            th = surf.thermal_thickness(lines, names,
                                        pp.get_str("thickCompName"),
                                        pp.get_float("thickLo"),
                                        pp.get_float("thickHi"))
            cols.append(th[:, None])
            out_names.append("thermal_thickness")
        if pp.query_str("strainCompName", ""):
            cs = surf.cold_strain(lines, names,
                                  pp.get_str("strainCompName"),
                                  pp.get_str("TCompName"),
                                  pp.get_float("TVal"))
            cols.append(cs[:, None])
            out_names.append("cold_strain")
        if pp.query_bool("addAngle", False):
            cols.append(surf.inclination_angle(lines)[:, None])
            out_names.append("angle")
        nodes = np.concatenate(cols, axis=1)
        if dt != 0.0:
            nodes[:, : len(names)] = surf.advect_points(
                nodes[:, : len(names)], names, dt)
        mef = MEF(f"{meta.time:g}", out_names, nodes,
                  np.asarray(get_elts(), np.int32))
        # advectColdIso names the intent (stream.cpp:979-1001): the alt
        # surface is the cold iso advected by u*dt, the dt!=0 path above
        pp.query_bool("advectColdIso", False)
        alt_file = pp.query_str(
            "altIsoFile", pp.query_str("altSurfFile",
                                       plotfile + "_altSurf.mef"))
        if sess is not None:
            sess.put_surface(alt_file, mef)
        if writes:
            write_mef(alt_file, mef)
            print(f"wrote {alt_file}")
