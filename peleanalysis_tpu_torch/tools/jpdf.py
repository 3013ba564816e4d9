"""``jpdf`` — joint PDFs of every pair of variables.

Counterpart of ``peleanalysis_tpu/tools/jpdf.py`` (dense path), itself the
replacement for the reference's Src/jpdf.cpp: for each of the n(n-1)/2
variable pairs, a volume-weighted nBins^2 joint histogram over all
uncovered cells of all levels (out-of-range values clamp into the edge
bins, jpdf.cpp:489-496), plus the conditional-mean accumulators
binX1/binX2.  Reproduced:

  * per-variable min/max scan with ``useminmax%i`` overrides
    (jpdf.cpp:296-326)
  * conditioning window on cVar incl. normalized (norm_cVal) and c(1-c)
    (do_conditioning=2) modes (jpdf.cpp:110-152, 476-487)
  * derived "Stoichiometry" variable 0.5*sum(X*H)/sum(X*O) from per-variable
    H/O atom counts (jpdf.cpp:193-243, 388-420)
  * writers: gnuplot/matlab/tecplot/fab/scatter/2-D plotfile with the
    reference's normalization — binX /= bin then bin /= domainVol
    (jpdf.cpp:560-740); multi-file ``do_average`` pass (jpdf.cpp:935-1049)

All pairs of a level are one launch of the stats kernel on the card
(``ops/stats_kernels.joint_hist``).  ``prefetch=N`` (default 1) reads the
next N files of a series on a background thread while the current one is
binned (``io/prefetch.iter_states``); ``prefetch=0`` reads them one after
another, and the outputs do not depend on it.  Sparse
refinement (the finest union bbox wasting >4x its cells) accumulates the
coarse levels once and the finest level cluster by cluster (JAX :294-332):
one pass over the parts for the variables' min/max, a second for the
histograms; the weights are physical cell volumes, so no part is rescaled.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..amr.box import Box, BoxArray
from ..amr.dense import DenseAmrState
from ..amr.geometry import Geometry
from ..io.fab import write_fab
from ..io.plotfile import write_plotfile
from ..ops.stats import joint_pdf, joint_pdf_multi, masked_mean
from ..ops.stencil import _const
from ..io.prefetch import iter_states, query_prefetch
from ..parmparse import ParmParse
from ..telemetry import span
from .conditional_mean import _fetch, stats_parts
from .curvature import _masked_minmax
from .grad import refuse_unported


def _jpdf_all(f1s, f2s, ms, vols, bounds, nbins):
    """One pair over all levels, on the device: the level-0 masked means as
    moment shifts (float32-safe X1/X2 accumulation), then the shifted
    histogram of every level, summed.  The bounds are the JAX tools'
    compile-time constants (``folded``).  Returns (b, bx1', bx2', c1, c2)."""
    v1min, v1max, v2min, v2max = bounds
    c1 = masked_mean(f1s[0], ms[0], vols[0])
    c2 = masked_mean(f2s[0], ms[0], vols[0])
    b = bx1 = bx2 = 0.0
    for lev in range(len(f1s)):
        bb, b1, b2 = joint_pdf(f1s[lev], f2s[lev], vols[lev], ms[lev],
                               v1min, v1max, v2min, v2max, nbins,
                               shift1=c1, shift2=c2, folded=True)
        b, bx1, bx2 = b + bb, bx1 + b1, bx2 + b2
    return b, bx1, bx2, c1, c2


def _jpdf_multi_all(vals_list, ms, vols, lo, hi, nbins, pairs):
    """All levels x all pairs: per-variable shifts from the level-0 masked
    means, then joint_pdf_multi per level, summed.  Returns (b, bx1', bx2',
    shifts)."""
    sh = torch.stack([masked_mean(v, ms[0], vols[0]) for v in vals_list[0]])
    b = bx1 = bx2 = 0.0
    for lev in range(len(vals_list)):
        bb, b1, b2 = joint_pdf_multi(vals_list[lev], vols[lev], ms[lev], lo,
                                     hi, nbins, pairs, shifts=sh)
        b, bx1, bx2 = b + bb, bx1 + b1, bx2 + b2
    return b, bx1, bx2, sh


def _masks(dstate: DenseAmrState, cond_levels):
    masks = []
    for lev in range(dstate.meta.n_levels):
        m = dstate.valid_mask(lev)
        if cond_levels is not None:
            m = m & cond_levels[lev]
        masks.append(m)
    return masks


def _vols(dstate: DenseAmrState):
    return [float(np.prod(dstate.meta.geoms[lev].dx))
            for lev in range(dstate.meta.n_levels)]


def compute_jpdf_pairs(dstate: DenseAmrState, field_levels, lo, hi, nbins,
                       pairs, cond_levels=None):
    """All-pairs jpdf accumulation over all levels, one host fetch.
    field_levels: [nv] of [lev] -> [*bbox]; lo/hi: [nv].  Returns (b, bx1,
    bx2) each [npairs, nbins, nbins] float64 numpy with raw (unshifted) bx
    columns."""
    nv = len(field_levels)
    vals_list = [[field_levels[v][lev] for v in range(nv)]
                 for lev in range(dstate.meta.n_levels)]
    with span("stats.accumulate"):
        b, bx1_s, bx2_s, sh = _fetch(list(_jpdf_multi_all(
            vals_list, _masks(dstate, cond_levels), _vols(dstate), lo, hi,
            nbins, [tuple(p) for p in pairs])))
    ii = np.asarray([p[0] for p in pairs])
    jj = np.asarray([p[1] for p in pairs])
    bx1 = bx1_s + sh[ii][:, None, None] * b
    bx2 = bx2_s + sh[jj][:, None, None] * b
    return b, bx1, bx2


SMALL = 1.0e-7


def valid_minmax(dstate: DenseAmrState, comp: int) -> Tuple[float, float]:
    """(min, max) of a component over the valid cells of all levels."""
    lo_hi = _masked_minmax([d[comp] for d in dstate.data],
                           [dstate.valid_mask(lev)
                            for lev in range(dstate.meta.n_levels)]).cpu()
    return float(lo_hi[0]), float(lo_hi[1])


def stoichiometry_field(dstate: DenseAmrState, var_names: Sequence[str],
                        h_list: Sequence[int], o_list: Sequence[int]):
    """0.5 * sum_v X_v*H_v / sum_v X_v*O_v per level (jpdf.cpp:410-417)."""
    idx = [dstate.comp(n) for n in var_names]
    out = []
    for d in dstate.data:
        X = d[idx]
        h = torch.as_tensor(np.asarray(h_list, np.float64), device=X.device
                            ).to(X.dtype)
        o = torch.as_tensor(np.asarray(o_list, np.float64), device=X.device
                            ).to(X.dtype)
        out.append(0.5 * torch.tensordot(h, X, dims=1)
                   / torch.tensordot(o, X, dims=1))
    return out


def compute_jpdf_pair(dstate: DenseAmrState, f1_levels, f2_levels,
                      v1min, v1max, v2min, v2max, nbins, cond_levels=None):
    """One pair over all levels, one host fetch.  f*_levels: [lev] ->
    [*bbox].  Returns float64 numpy (b, bx1, bx2)."""
    with span("stats.accumulate"):
        b, bx1_s, bx2_s, c1, c2 = _fetch(list(_jpdf_all(
            list(f1_levels), list(f2_levels), _masks(dstate, cond_levels),
            _vols(dstate), (float(v1min), float(v1max), float(v2min),
                            float(v2max)), nbins)))
    return b, bx1_s + c1 * b, bx2_s + c2 * b


def normalize_pair(b, bx1, bx2, v1min, v1max, v2min, v2max, domain_vol):
    """Reference normalization (jpdf.cpp:572-588): binX/=bin (bin centers
    where empty), then bin/=domainVol."""
    nbins = b.shape[0]
    dv1 = (v1max - v1min) / nbins
    dv2 = (v2max - v2min) / nbins
    c1 = v1min + dv1 * (0.5 + np.arange(nbins))
    c2 = v2min + dv2 * (0.5 + np.arange(nbins))
    C1, C2 = np.meshgrid(c1, c2, indexing="ij")
    nz = b > 0
    bx1 = np.where(nz, bx1 / np.where(nz, b, 1.0), C1)
    bx2 = np.where(nz, bx2 / np.where(nz, b, 1.0), C2)
    return b / domain_vol, bx1, bx2, C1, C2


# ---------------------------------------------------------------------------
# writers (formats per jpdf.cpp:595-740)

def write_gnuplot(path, C1, C2, b):
    with open(path, "w") as f:
        for i in range(b.shape[0]):
            for j in range(b.shape[1]):
                f.write(f"{C1[i, j]:e} {C2[i, j]:e} {b[i, j]:e}\n")


def write_matlab(base, n1, n2, C1, C2, b, bx1, bx2):
    np.savetxt(f"{base}/Pdf_{n1}_{n2}.dat", b, fmt="%e")
    np.savetxt(f"{base}/Pdf_{n1}_x.dat", C1[:, 0], fmt="%e")
    np.savetxt(f"{base}/Pdf_{n2}_x.dat", C2[0, :], fmt="%e")
    np.savetxt(f"{base}/PdfX1_{n1}_{n2}.dat", bx1, fmt="%e")
    np.savetxt(f"{base}/PdfX2_{n1}_{n2}.dat", bx2, fmt="%e")


def write_tecplot(path, n1, n2, C1, C2, b):
    nbins = b.shape[0]
    with open(path, "w") as f:
        f.write(f"VARIABLES = {n1} {n2} logpdf pdf\n")
        f.write(f"ZONE N={nbins*nbins} E={(nbins-1)*(nbins-1)} "
                "F=FEPOINT ET=QUADRILATERAL\n")
        for i in range(nbins):
            for j in range(nbins):
                p = b[i, j]
                f.write(f"{C1[i,j]:e} {C2[i,j]:e} {np.log(p + SMALL):e} "
                        f"{p:e}\n")
        for i in range(nbins - 1):
            for j in range(nbins - 1):
                i1 = i * nbins + j + 1
                i2 = (i + 1) * nbins + j + 1
                i3 = (i + 1) * nbins + (j + 1) + 1
                i4 = i * nbins + (j + 1) + 1
                f.write(f"{i1} {i2} {i3} {i4}\n")


def write_fab_pdf(path, C1, C2, b):
    nbins = b.shape[0]
    data = np.stack([C1, C2, np.log(b + SMALL), b])[..., None]  # z extent 1
    with open(path, "wb") as f:
        write_fab(f, Box((0, 0, 0), (nbins - 1, nbins - 1, 0)), data)


def write_scatter(path, C1, C2, b):
    with open(path, "w") as f:
        for i in range(b.shape[0]):
            for j in range(b.shape[1]):
                if b[i, j] > 0:
                    f.write(f"{C1[i,j]:e} {C2[i,j]:e}\n")


def write_pdf_plotfile(path, n1, n2, v1min, v1max, v2min, v2max, b):
    """2-D plotfile rendering of the pdf (jpdf.cpp:733-.. analog): a
    single-level nbins x nbins x 1 grid in (v1,v2) space."""
    nbins = b.shape[0]
    dom = Box((0, 0, 0), (nbins - 1, nbins - 1, 0))
    geom = Geometry(dom, (v1min, v2min, 0.0), (v1max, v2max, 1.0),
                    (False, False, False))
    fab = np.stack([np.log(b + SMALL), b])[..., None]
    write_plotfile(path, ["logpdf", "pdf"], 0.0, [geom], [],
                   [BoxArray([dom])], [[fab]])


def _protect(name: str) -> str:
    return name.replace("/", "_")


def _emit(outputs, base, p1, p2, n1, n2, C1, C2, b, bx1, bx2,
          v1min, v1max, v2min, v2max):
    with span("write.text"):
        if outputs["gnuplot"]:
            write_gnuplot(f"{base}/Pdf_{p1}_{p2}.gpd", C1, C2, b)
        if outputs["matlab"]:
            write_matlab(base, p1, p2, C1, C2, b, bx1, bx2)
        if outputs["tecplot"]:
            write_tecplot(f"{base}/Pdf_{p1}_{p2}.tpd", n1, n2, C1, C2, b)
        if outputs["fab"]:
            write_fab_pdf(f"{base}/Pdf_{p1}_{p2}.fab", C1, C2, b)
        if outputs["scatter"]:
            write_scatter(f"{base}/Scatter_{p1}_{p2}.dat", C1, C2, b)
    if outputs["plotfile"]:
        write_pdf_plotfile(f"{base}/Pdf_{p1}_{p2}_plt", n1, n2,
                           v1min, v1max, v2min, v2max, b)


def main(args: dict) -> None:
    """CLI: jpdf infile=<plt>... vars=<name>... [nBins=64] [useminmax%i=lo hi]
    [do_conditioning=0|1|2 cVar=i norm_cVal=0 cNormMin/Max cMin cMax]
    [do_stoichiometry=0 Hlist=... Olist=...] [do_average=0]
    [output_gnuplot/matlab/tecplot/fab/scatter/plotfile=..] [outSuffix=]
    [finestLevel=] [prefetch=1 (files read ahead on a background thread; 0:
    one after another)] [force_dense=0] [cluster_batch=0] [device=cuda|cpu]"""
    pp = ParmParse(args)
    infiles = pp.get_str_list("infiles" if pp.contains("infiles") else "infile")
    nbins = pp.query_int("nBins", 64)
    var_in = pp.get_str_list("vars")
    do_stoich = pp.query_bool("do_stoichiometry", False)
    do_avg = pp.query_bool("do_average", False)
    out_suffix = pp.query_str("outSuffix", "")
    outputs = {k: pp.query_bool("output_" + k, k == "plotfile")
               for k in ("gnuplot", "matlab", "tecplot", "fab", "scatter",
                         "plotfile")}
    finest = pp.query_int("finestLevel", None)
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    depth = query_prefetch(pp)

    names = list(var_in)
    if do_stoich:
        h_list = pp.get_int_list("Hlist")
        o_list = pp.get_int_list("Olist")
        names_all = names + ["Stoichiometry"]
    else:
        names_all = names

    do_cond = pp.query_int("do_conditioning", 0)
    cvar = pp.query_int("cVar", 0)
    norm_c = pp.query_int("norm_cVal", 0) or (do_cond == 2)
    cnmin = pp.query_float("cNormMin", 0.0)
    cnmax = pp.query_float("cNormMax", 1.0)
    cmin = pp.query_float("cMin", 0.0)
    cmax = pp.query_float("cMax", 1.0)

    nvars = len(names_all)
    npairs = nvars * (nvars - 1) // 2
    avg = [None] * npairs
    pairs = tuple((a, bvar) for a in range(nvars)
                  for bvar in range(a + 1, nvars))

    def part_inputs(ds):
        """The part's per-level fields by name and conditioning masks."""
        fields = {n: [ds.data[lev][ds.comp(n)]
                      for lev in range(ds.meta.n_levels)] for n in names}
        if do_stoich:
            fields["Stoichiometry"] = stoichiometry_field(ds, names, h_list,
                                                          o_list)
        cond_levels = None
        if do_cond:
            cond_levels = []
            for cval in fields[names_all[cvar]]:
                if norm_c:
                    cval = (cval - _const(cnmin, cval)) \
                        / _const(cnmax - cnmin, cval)
                if do_cond == 2:
                    cval = cval * (1.0 - cval)
                cond_levels.append((cval >= _const(cmin, cval))
                                   & (cval <= _const(cmax, cval)))
        return fields, cond_levels

    series = iter_states(args, infiles, names=list(dict.fromkeys(names)),
                         max_level=finest, dtype=config.compute_dtype,
                         device=device, depth=depth)
    for plt, src in series:
        meta = src.meta
        parts = stats_parts(args, src, device, pp, "jpdf")
        bounds = {}
        for i, n in enumerate(names_all):
            mm = pp.query_float_list(f"useminmax{i+1}", None)
            if mm:
                bounds[n] = (mm[0], mm[1])
            elif n == "Stoichiometry":
                bounds[n] = (0.0, 2.0)
        # the other variables' min/max over the valid cells of every part,
        # in one pass over the parts
        scan = [n for n in names_all if n not in bounds]
        mms = [[valid_minmax(ds, ds.comp(n)) for n in scan]
               for ds, _ in (parts if scan else [])]
        for k, n in enumerate(scan):
            bounds[n] = (min(m[k][0] for m in mms), max(m[k][1] for m in mms))
        vmin = {n: lo for n, (lo, _) in bounds.items()}
        vmax = {n: hi for n, (_, hi) in bounds.items()}

        g = meta.geoms[0]
        domain_vol = float(np.prod([h - l for l, h in
                                    zip(g.prob_lo, g.prob_hi)]))
        base = plt + out_suffix
        os.makedirs(base, exist_ok=True)

        bP = bx1P = bx2P = 0.0
        for ds, _ in (parts if pairs else []):
            fields, cond_levels = part_inputs(ds)
            bb, b1, b2 = compute_jpdf_pairs(
                ds, [fields[n] for n in names_all],
                [vmin[n] for n in names_all], [vmax[n] for n in names_all],
                nbins, pairs, cond_levels)
            bP, bx1P, bx2P = bP + bb, bx1P + b1, bx2P + b2
            del ds, fields, cond_levels
        for ipair, (a, bvar) in enumerate(pairs):
            n1, n2 = names_all[a], names_all[bvar]
            b, bx1, bx2 = bP[ipair], bx1P[ipair], bx2P[ipair]
            if do_avg:
                if avg[ipair] is None:
                    avg[ipair] = [np.zeros_like(b) for _ in range(3)]
                avg[ipair][0] += b
                avg[ipair][1] += bx1
                avg[ipair][2] += bx2
            bn, bx1n, bx2n, C1, C2 = normalize_pair(
                b, bx1, bx2, vmin[n1], vmax[n1], vmin[n2], vmax[n2],
                domain_vol)
            _emit(outputs, base, _protect(n1), _protect(n2), n1, n2,
                  C1, C2, bn, bx1n, bx2n,
                  vmin[n1], vmax[n1], vmin[n2], vmax[n2])

    if do_avg:
        base = infiles[0] + out_suffix + "_avg"
        os.makedirs(base, exist_ok=True)
        for ipair, (a, bvar) in enumerate(pairs):
            n1, n2 = names_all[a], names_all[bvar]
            b, bx1, bx2 = avg[ipair]
            bn, bx1n, bx2n, C1, C2 = normalize_pair(
                b, bx1, bx2, vmin[n1], vmax[n1], vmin[n2], vmax[n2],
                domain_vol * len(infiles))
            _emit(outputs, base, _protect(n1), _protect(n2), n1, n2,
                  C1, C2, bn, bx1n, bx2n,
                  vmin[n1], vmax[n1], vmin[n2], vmax[n2])
    print("jpdf done")
