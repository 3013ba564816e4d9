"""``conditionalMean`` — conditional mean/std of variables binned by another.

Counterpart of ``peleanalysis_tpu/tools/conditional_mean.py`` (dense path),
itself the replacement for the reference's Src/conditionalMean.cpp: across
a list of plotfiles, bin ``avgComps`` by ``binComp`` over [binMin, binMax)
x nBins, weighting each cell by its refinement volume (weights[lev] = the
product of the ref ratios to the finest level, conditionalMean.cpp:198-205),
with fine-covered cells masked (conditionalMean.cpp:246-258).  Output:
Tecplot/gnuplot ASCII with sum/sumSq/avg/std[/min/max]/N/p columns
(conditionalMean.cpp:310-399).

Every level's histogram is one launch of the stats kernel on the card
(``ops/stats_kernels.binned_moments``).  ``prefetch=N`` (default 1) reads
the next N files of a series on a background thread while the current one
is binned (``io/prefetch.iter_states``); ``prefetch=0`` reads them one
after another, and the outputs do not depend on it.  Sparse
refinement (the finest union bbox wasting >4x its cells) accumulates the
coarse levels once and the finest level cluster by cluster
(``sparse_stats_parts``; JAX :293-315).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import config
from ..amr.cluster import clustered, sparse_stats_parts
from ..amr.dense import DenseAmrState, host_to_device
from ..io.plotfile import PlotfileReader
from ..ops.stats import binned_stats, reconstruct_moments
from ..io.prefetch import iter_states, query_prefetch
from ..parmparse import ParmParse
from ..session import LoadedPlotfile, dense_state
from ..session import var_names as plotfile_vars
from ..telemetry import span
from .grad import refuse_unported


def _comps(d: torch.Tensor, ia: Sequence[int]) -> torch.Tensor:
    """d[ia] ([ncomp, *shape]); a view when ia is a run of components."""
    ia = list(ia)
    if ia == list(range(ia[0], ia[0] + len(ia))):
        return d[ia[0]: ia[0] + len(ia)]
    return d[ia]


def _fetch(tensors):
    """Tensors to host float64 numpy arrays in one device-to-host copy."""
    flat = torch.cat([t.reshape(-1).double() for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _accumulate_all(data_list, mask_list, ib, ia, weights, bin_min, bin_max,
                    nbins, with_minmax):
    """All levels' shifted moments.  The per-component shift is the global
    masked mean (all levels), so the sumsq accumulation stays
    cancellation-free in float32; the weight sum is float64, so an empty
    selection gives a zero shift, not 0/0.  The bin edges are the JAX
    tools' compile-time constants (``folded``).  Returns (hits, sums,
    sumsq, [mins, maxs,] shift) on the data's device."""
    dt = data_list[0].dtype
    num = den = 0.0
    for d, m, w in zip(data_list, mask_list, weights):
        v = _comps(d, ia)
        num = num + float(w) * torch.sum(v * m.to(dt), dim=(1, 2, 3),
                                         dtype=torch.float64)
        den = den + float(w) * m.sum(dtype=torch.float64)
    shift = (num / torch.clamp_min(den, torch.finfo(
        torch.float64).tiny)).to(dt)
    acc = None
    for d, m, w in zip(data_list, mask_list, weights):
        out = binned_stats(d[ib], _comps(d, ia), float(w), m, bin_min,
                           bin_max, nbins, clamp=False,
                           with_minmax=with_minmax, shift=shift, folded=True)
        if acc is None:
            acc = list(out)
        else:
            acc[0] = acc[0] + out[0]
            acc[1] = acc[1] + out[1]
            acc[2] = acc[2] + out[2]
            if with_minmax:
                acc[3] = torch.minimum(acc[3], out[3])
                acc[4] = torch.maximum(acc[4], out[4])
    return tuple(a for a in acc if a is not None) + (shift,)


def refinement_weights(ref_ratio: Sequence[int], n_levels: int,
                       ndim: int = 3) -> List[int]:
    """weights[lev] = fine-cells-per-cell at the finest level
    (conditionalMean.cpp:198-205); ndim=2 for DIM=2 plotfiles."""
    w = [1] * n_levels
    for lev in range(n_levels - 2, -1, -1):
        w[lev] = w[lev + 1] * ref_ratio[lev] ** ndim
    return w


def _stats_inputs(dstate: DenseAmrState, bin_name, avg_names):
    meta = dstate.meta
    ndim = 2 if meta.ndim2 else 3
    weights = refinement_weights(meta.ref_ratio, meta.n_levels, ndim)
    ib = dstate.comp(bin_name)
    ia = [dstate.comp(n) for n in avg_names]
    masks = [dstate.valid_mask(lev) for lev in range(meta.n_levels)]
    return weights, ib, ia, masks


def accumulate_conditional_mean(dstate: DenseAmrState, bin_name: str,
                                avg_names: Sequence[str], nbins: int,
                                bin_min: float, bin_max: float,
                                with_minmax: bool = False, bounds=None):
    """All levels of one state accumulated with one host fetch.
    bounds: optional ((lox,loy,loz),(hix,hiy,hiz)) physical sub-box — cells
    outside are excluded (conditionalMean.cpp:180-192 bounds key, coarse
    indices rounded with the reference's ±1e-4*dx nudges).  Returns float64
    numpy (hits, sums, sumsq, mins, maxs)."""
    with span("stats.accumulate"):
        meta = dstate.meta
        weights, ib, ia, masks = _stats_inputs(dstate, bin_name, avg_names)
        if bounds is not None:
            g0 = meta.geoms[0]
            lo0 = [max(g0.domain.lo[d],
                       int((bounds[0][d] - g0.prob_lo[d] + 1e-4 * g0.dx[d])
                           / g0.dx[d])) for d in range(3)]
            hi0 = [min(g0.domain.hi[d],
                       int((bounds[1][d] - g0.prob_lo[d] - 1e-4 * g0.dx[d])
                           / g0.dx[d])) for d in range(3)]
            rat = 1
            for lev in range(meta.n_levels):
                if lev > 0:
                    rat *= meta.ref_ratio[lev - 1]
                bbox = dstate.lmeta[lev].bbox
                sel = []
                for d in range(3):
                    idx = np.arange(bbox.lo[d], bbox.hi[d] + 1)
                    sel.append((idx >= lo0[d] * rat)
                               & (idx <= (hi0[d] + 1) * rat - 1))
                box_m = (sel[0][:, None, None] & sel[1][None, :, None]
                         & sel[2][None, None, :])
                masks[lev] = masks[lev] & host_to_device(box_m,
                                                         dstate.device)
        out = _fetch(_accumulate_all(list(dstate.data), masks, ib, ia, weights,
                                     float(bin_min), float(bin_max), nbins,
                                     with_minmax))
        if with_minmax:
            hits, sums_s, sumsq_s, mins, maxs, shift = out
        else:
            hits, sums_s, sumsq_s, shift = out
            mins = np.full((nbins, len(avg_names)), np.inf)
            maxs = np.full((nbins, len(avg_names)), -np.inf)
        # raw columns reconstructed in float64 on the host (the reference
        # accumulates in double); the shift terms cancel in the variance
        sums, sumsq = reconstruct_moments(hits, sums_s, sumsq_s, shift)
        return hits, sums, sumsq, mins, maxs


def accumulate_stats_fused(dstate: DenseAmrState, bin_name: str,
                           avg_names: Sequence[str], nbins: int,
                           bin_min: float, bin_max: float, pair, pair_bounds,
                           pair_nbins: int):
    """conditionalMean and one jpdf pair of the same state with one host
    fetch (the JAX bench's config-5 composite).  pair = (name1, name2);
    pair_bounds = (v1min, v1max, v2min, v2max).  Returns ((hits, sums,
    sumsq), (b, bx1, bx2)), float64 numpy, reconstructed as the standalone
    paths do."""
    from .jpdf import _jpdf_all

    with span("stats.accumulate"):
        meta = dstate.meta
        weights, ib, ia, masks = _stats_inputs(dstate, bin_name, avg_names)
        i1, i2 = dstate.comp(pair[0]), dstate.comp(pair[1])
        vols = [float(np.prod(meta.geoms[lev].dx))
                for lev in range(meta.n_levels)]
        data = list(dstate.data)
        cm = _accumulate_all(data, masks, ib, ia, weights, float(bin_min),
                             float(bin_max), nbins, False)
        jp = _jpdf_all([d[i1] for d in data], [d[i2] for d in data], masks,
                       vols, tuple(float(v) for v in pair_bounds), pair_nbins)
        (hits, sums_s, sumsq_s, shift, b, bx1_s, bx2_s, c1, c2) = _fetch(
            list(cm) + list(jp))
        sums, sumsq = reconstruct_moments(hits, sums_s, sumsq_s, shift)
        return ((hits, sums, sumsq), (b, bx1_s + c1 * b, bx2_s + c2 * b))


def write_cm_dat(path: str, bin_name: str, avg_names: Sequence[str],
                 nbins: int, bin_min: float, bin_max: float,
                 hits, sums, sumsq, mins=None, maxs=None,
                 with_minmax: bool = False) -> None:
    """Tecplot-style ASCII matching conditionalMean.cpp:310-399."""
    with span("write.text"), open(path, "w") as f:
        cols = ["VARIABLES = " + bin_name]
        for suf in ("sum", "sumSq", "avg", "std"):
            cols += [f"{n}_{suf}" for n in avg_names]
        if with_minmax:
            for suf in ("min", "max"):
                cols += [f"{n}_{suf}" for n in avg_names]
        f.write(" ".join(cols) + "  N  p \n")
        f.write(f"ZONE I={nbins} DATAPACKING=POINT\n")
        dv = (bin_max - bin_min) / nbins
        ntot = hits.sum()
        for i in range(nbins):
            row = [bin_min + dv * (0.5 + i)]
            row += list(sums[i])
            row += list(sumsq[i])
            if hits[i] > 0:
                row += list(sums[i] / hits[i])
                var = sumsq[i] / hits[i] - (sums[i] / hits[i]) ** 2
                row += list(np.sqrt(np.maximum(var, 0.0)))
            else:
                row += [0.0] * (2 * len(avg_names))
            if with_minmax:
                row += list(mins[i])
                row += list(maxs[i])
            row += [hits[i], hits[i] / max(ntot, 1)]
            f.write(" ".join(f"{v:e}" for v in row) + "\n")


def _resolve(name_or_idx: str, var_names: Sequence[str]) -> str:
    """The reference takes integer component indices; accept both."""
    try:
        return var_names[int(name_or_idx)]
    except ValueError:
        return name_or_idx


def stats_parts(args: dict, src: LoadedPlotfile, device, pp: ParmParse,
                tool: str):
    """A loaded plotfile as dense parts on ``device`` in the compute dtype,
    a re-iterable of ``(state, scale)``.  Dense path: one part, the whole
    hierarchy (``session.dense_state``), scale 1.  Sparse refinement
    (unless force_dense=1): the coarse levels with the global covered mask,
    scaled by r**ndim (r the ratio below the finest level: its weights
    count cells of level fin-1, conditionalMean's count the finest
    level's), then one single-level part a finest-level cluster, scale 1,
    each built when visited (``sparse_stats_parts``)."""
    meta = src.meta
    dt = config.compute_dtype
    if clustered(meta, pp, [meta.n_levels - 1]):
        print(f"{tool}: sparse refinement -> clustered path")
        base = DenseAmrState.coarse_only(meta, src.names, src.fabs, device,
                                         dt)
        coarse, clusters, r = sparse_stats_parts(base, src.fabs[-1])
        return _Parts(coarse, float(r ** (2 if meta.ndim2 else 3)),
                      clusters)
    return [(dense_state(args, src, device, dt), 1.0)]


class _Parts:
    """The sparse parts: (coarse, scale), then (cluster, 1.0) for each
    cluster, built anew each time they are iterated."""

    def __init__(self, coarse: DenseAmrState, scale: float, clusters):
        self._coarse, self._scale, self._clusters = coarse, scale, clusters

    def __iter__(self):
        yield self._coarse, self._scale
        for c in self._clusters:
            yield c, 1.0


def main(args: dict) -> None:
    """CLI: conditionalMean infile=<plt>... binComp=<i|name> avgComps=<i|name>...
    nBins= binMin= binMax= [writeBinMinMax=0] [finestLevel=] [aja=0]
    [outSuffix=] [outfile=] [bounds=lo.. hi.. (2*DIM reals)]
    [prefetch=1 (files read ahead on a background thread; 0: one after
    another)] [force_dense=0] [cluster_batch=0] [device=cuda|cpu]"""
    pp = ParmParse(args)
    infiles = pp.get_str_list("infiles" if pp.contains("infiles") else "infile")
    nbins = pp.query_int("nBins", 64)
    bin_min = pp.get_float("binMin")
    bin_max = pp.get_float("binMax")
    with_minmax = pp.query_bool("writeBinMinMax", False)
    finest = pp.query_int("finestLevel", None)
    aja = pp.query_bool("aja", False)
    out_suffix = pp.query_str("outSuffix", "")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    depth = query_prefetch(pp)
    bounds = None
    if pp.contains("bounds"):
        barr = pp.get_float_list("bounds")
        if len(barr) == 4:        # DIM=2 plotfile: promote z to the unit cell
            barr = barr[:2] + [-1.0e30] + barr[2:] + [1.0e30]
        if len(barr) != 6:
            raise ValueError("bounds expects 2*DIM reals: lo... hi...")
        bounds = (tuple(barr[:3]), tuple(barr[3:]))
        # snap to the level-0 cell faces up front
        meta0 = PlotfileReader(infiles[0]).meta
        g = meta0.geometry(0)
        nd = meta0.ndim
        lo0 = [max(g.domain.lo[d],
                   int((bounds[0][d] - g.prob_lo[d] + 1e-4 * g.dx[d])
                       / g.dx[d])) for d in range(nd)]
        hi0 = [min(g.domain.hi[d],
                   int((bounds[1][d] - g.prob_lo[d] - 1e-4 * g.dx[d])
                       / g.dx[d])) for d in range(nd)]
        bounds = (tuple(g.prob_lo[d] + lo0[d] * g.dx[d]
                        for d in range(nd)) + bounds[0][nd:],
                  tuple(g.prob_lo[d] + (hi0[d] + 1) * g.dx[d]
                        for d in range(nd)) + bounds[1][nd:])

    avail = plotfile_vars(args, infiles[0])
    bin_name = _resolve(pp.get_str("binComp"), avail)
    avg_names = [_resolve(s, avail) for s in pp.get_str_list("avgComps")]

    nb = len(avg_names)
    hits = np.zeros(nbins)
    sums = np.zeros((nbins, nb))
    sumsq = np.zeros((nbins, nb))
    mins = np.full((nbins, nb), np.inf)
    maxs = np.full((nbins, nb), -np.inf)
    series = iter_states(args, infiles, names=list(dict.fromkeys(
        [bin_name] + avg_names)), max_level=finest,
        dtype=config.compute_dtype, device=device, depth=depth)
    for _, src in series:
        parts = stats_parts(args, src, device, pp, "conditionalMean")
        for ds, scale in parts:
            h, s, s2, mn, mx = accumulate_conditional_mean(
                ds, bin_name, avg_names, nbins, bin_min, bin_max,
                with_minmax, bounds=bounds)
            hits += scale * h
            sums += scale * s
            sumsq += scale * s2
            mins = np.minimum(mins, mn)
            maxs = np.maximum(maxs, mx)

    out = (infiles[0] + f"/CM_{bin_name}{out_suffix}.dat" if aja
           else f"CM_{bin_name}{out_suffix}.dat")
    out = pp.query_str("outfile", out)
    write_cm_dat(out, bin_name, avg_names, nbins, bin_min, bin_max,
                 hits, sums, sumsq, mins, maxs, with_minmax)
    print(f"wrote {out}")
