"""``fcompare`` / ``fextrema`` — plotfile diff and extrema reports.

Counterpart of ``peleanalysis_tpu/tools/compare_plts.py`` (AMReX's
``fcompare``/``fextrema`` executables, amrex/Tools/Plotfile): fcompare
reports per component the absolute and relative L-inf and the L2 of the
difference of two plotfiles of the same BoxArrays over the valid
(uncovered) cells, with ``|a|`` as the relative denominator; fextrema the
min and max over the valid cells.

The FABs are read at their native precision and widened to float64 (never
to the compute dtype).  The JAX package keeps the work in host numpy
because a TPU has no native float64; the card has, so each level's boxes
go to the device in one float64 tensor with the per-box valid masks
(``_valid_mask``: the next level's boxes coarsened by floor division, no
periodic images) and are reduced there, one copy of the results a level.
L-inf, the relative error and the extrema are exact; the L2 sum differs
from the host's only in its summation order.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..io.plotfile import PlotfileReader
from ..parmparse import ParmParse
from .grad import refuse_unported


def _valid_mask(box, fine_boxes, ratio) -> np.ndarray:
    """True where ``box`` (at level l) is NOT covered by the level-(l+1)
    boxes coarsened by ``ratio``.  Dimension-generic."""
    nd = len(box.lo)
    m = np.ones(box.shape[:nd], bool)
    for fb in fine_boxes:
        lo = [max(fb.lo[d] // ratio, box.lo[d]) for d in range(nd)]
        hi = [min(fb.hi[d] // ratio, box.hi[d]) for d in range(nd)]
        if all(lo[d] <= hi[d] for d in range(nd)):
            m[tuple(slice(lo[d] - box.lo[d], hi[d] - box.lo[d] + 1)
                    for d in range(nd))] = False
    return m


def _level_valid(r: PlotfileReader, lev: int) -> np.ndarray:
    """The valid masks of every box of ``lev``, flattened and joined in box
    order."""
    m = r.meta
    boxes = list(r.box_array(lev))
    if lev < m.n_levels - 1:
        fine, ratio = list(r.box_array(lev + 1)), m.ref_ratio[lev]
    else:
        fine, ratio = [], 1
    return np.concatenate([_valid_mask(b, fine, ratio).ravel()
                           for b in boxes])


def _level_values(r: PlotfileReader, lev: int, comps, device):
    """[ncomp, cells] float64 of every box of ``lev`` in box order."""
    fabs = r.read_level(lev, comps)
    host = np.concatenate([f.reshape(len(comps), -1) for f in fabs], axis=1)
    return torch.from_numpy(host).to(device)


def compare_plotfiles(r1: PlotfileReader, r2: PlotfileReader, names,
                      device):
    """Per-comp (abs_linf, rel_linf, abs_l2) over valid cells, float64."""
    i1 = [r1.var_index(n) for n in names]
    i2 = [r2.var_index(n) for n in names]
    nc = len(names)
    linf, l2, amax = np.zeros(nc), np.zeros(nc), np.zeros(nc)
    for lev in range(r1.meta.n_levels):
        valid = torch.from_numpy(_level_valid(r1, lev)).to(device)
        a = _level_values(r1, lev, i1, device)
        b = _level_values(r2, lev, i2, device)
        d = torch.where(valid, torch.abs(a - b), 0.0)
        res = torch.stack([d.amax(dim=1), (d * d).sum(dim=1),
                           torch.where(valid, torch.abs(a), 0.0)
                           .amax(dim=1)]).cpu().numpy()
        linf = np.maximum(linf, res[0])
        l2 += res[1]
        amax = np.maximum(amax, res[2])
    rel = linf / np.maximum(amax, 1e-300)
    return linf, rel, np.sqrt(l2)


def extrema_plotfile(r: PlotfileReader, names, device):
    idx = [r.var_index(n) for n in names]
    nc = len(names)
    lo, hi = np.full(nc, np.inf), np.full(nc, -np.inf)
    for lev in range(r.meta.n_levels):
        valid = torch.from_numpy(_level_valid(r, lev)).to(device)
        v = _level_values(r, lev, idx, device)
        res = torch.stack([torch.where(valid, v, np.inf).amin(dim=1),
                           torch.where(valid, v, -np.inf).amax(dim=1)]
                          ).cpu().numpy()
        lo = np.minimum(lo, res[0])
        hi = np.maximum(hi, res[1])
    return lo, hi


def main(args: dict) -> None:
    """CLI: fcompare infile1= infile2= [vars=common] [rtol=] [atol=]
         | fextrema infile= [vars=all]
    [device=cuda|cpu].  fcompare exits nonzero (SystemExit) when any comp
    exceeds rtol/atol (if given)."""
    pp = ParmParse(args)
    tool = args.get("_tool", ["fcompare"])[0]
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    if tool == "fextrema":
        infile = pp.get_str("infile")
        r = PlotfileReader(infile)
        names = pp.query_str_list("vars", r.var_names)
        lo, hi = extrema_plotfile(r, names, device)
        w = max(len(n) for n in names)
        print(f" plotfile = {infile}")
        print(f" time     = {r.meta.time}")
        print(f" {'variable'.ljust(w)}   {'minimum value':>20} "
              f"{'maximum value':>20}")
        for n, a, b in zip(names, lo, hi):
            print(f" {n.ljust(w)}   {a:20.10e} {b:20.10e}")
        return

    f1, f2 = pp.get_str("infile1"), pp.get_str("infile2")
    r1, r2 = PlotfileReader(f1), PlotfileReader(f2)
    names = pp.query_str_list(
        "vars", [n for n in r1.var_names if n in r2.var_names])
    if not names:
        raise ValueError(f"fcompare: no common comps between {f1} and {f2}")
    for fn, r in ((f1, r1), (f2, r2)):
        missing = [n for n in names if n not in r.var_names]
        if missing:
            raise ValueError(f"fcompare: comps not in {fn}: {missing}")
    # AMReX fcompare aborts unless the BoxArrays agree; matching minimal
    # bboxes with different box unions would diff valid cells against holes
    n1, n2 = r1.meta.n_levels, r2.meta.n_levels
    if n1 != n2 or any(r1.box_array(l) != r2.box_array(l)
                       for l in range(n1)):
        raise ValueError("fcompare: BoxArrays are not the same")
    linf, rel, l2 = compare_plotfiles(r1, r2, names, device)
    w = max(len(n) for n in names)
    print(f" {'variable'.ljust(w)}   {'absolute error':>16} "
          f"{'relative error':>16} {'L2 error':>16}")
    for n, ai, ri, l2i in zip(names, linf, rel, l2):
        print(f" {n.ljust(w)}   {ai:16.8e} {ri:16.8e} {l2i:16.8e}")
    rtol = pp.query_float("rtol", None)
    atol = pp.query_float("atol", None)
    if rtol is not None and (rel > rtol).any():
        raise SystemExit(f"fcompare: relative error exceeds rtol={rtol}")
    if atol is not None and (linf > atol).any():
        raise SystemExit(f"fcompare: absolute error exceeds atol={atol}")
    if (linf == 0).all():
        print(" PLOTFILES AGREE")
