"""``sCO2`` -- supercritical-CO2 jet analysis one-off (PeleAnalysis
Src/ModelSpecificAnalysis/sCO2/main.cpp): slab-wise statistics along
``planeCoord`` at the finest level.

Counterpart of ``peleanalysis_tpu/tools/sco2.py``.  Per slab of
``nBinPlanes`` planes: a 2-D (adv_0, adv_1) volume-weighted conditional
mean of Var1 on [0,1]^2 bins, a radial profile of Var1 vs r =
sqrt(y^2+z^2)/R, slab volume-weighted averages of Var1..Var3 ("mean.dat":
planeLoc avg1 avg2 avg3), and the max of the radial-profile means
("mcmt.dat": planeLoc mcmt) -- main.cpp:160-260 semantics.  comps = 6
variable indices/names: adv_0 adv_1 Var1 Var2 Var3 vfrac.

The JAX tool loops over the slabs with numpy bincounts; here the finest
level is flattened on the device (``flatten_to_level``) and every slab's
sums come from one bincount over (slab, bin) keys per statistic, fetched
in one copy.  The bins are numpy's ``((nbins-1) * v).astype(int)`` then
clipped: truncation toward zero, and a NaN, an infinity or a value at or
above 2^63, which x86's conversion turns into INT64_MIN, lands in bin 0
(``trunc_bins``; a CUDA conversion would saturate instead).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import config
from ..amr.dense import DenseAmrState
from ..io.plotfile import PlotfileReader
from ..parmparse import ParmParse
from .flatten_amr import flatten_to_level
from .grad import refuse_unported

# the first float64 that int64 cannot hold
_TWO63 = float(2 ** 63)


def trunc_bins(v: torch.Tensor, nbins: int) -> torch.Tensor:
    """``np.clip(((nbins - 1) * v).astype(int), 0, nbins - 1)`` as numpy
    computes it on x86: truncation toward zero, and a value the conversion
    cannot hold (NaN, +-inf, >= 2^63) taken as INT64_MIN, so bin 0."""
    s = (nbins - 1) * v
    ok = torch.isfinite(s) & (s < _TWO63)
    # the clamp keeps every conversion in range and changes no bin
    return (torch.where(ok, s, 0.0).clamp_(-1.0, float(nbins))
            .to(torch.int64).clamp_(0, nbins - 1))


def slab_sums(dense: torch.Tensor, rbin: torch.Tensor, nbins: int,
              n_planes: int) -> np.ndarray:
    """Every slab's sums from ``dense`` [6, plane, a, b] (adv_0, adv_1,
    Var1, Var2, Var3, vfrac) in one host array [nslab, S]: the 2-D bins'
    sum of Var1 * vfrac and of vfrac (nbins^2 each), the radial bins'
    (nbins + 1 each, ``rbin`` [a, b]), then sum(Var_k * vfrac) for k = 1..3
    and sum(vfrac).  Each statistic is one bincount over (slab, bin) keys,
    the cells in C order as the JAX tool's ravel of each slab."""
    n_pl = dense.shape[1]
    nslab = -(-n_pl // n_planes)
    slab = torch.arange(n_pl, device=dense.device) // n_planes
    vol = dense[5].reshape(-1)
    val_vol = (dense[2] * dense[5]).reshape(-1)
    nb2 = nbins * nbins
    key2 = (slab[:, None, None] * nb2 + trunc_bins(dense[0], nbins) * nbins
            + trunc_bins(dense[1], nbins)).reshape(-1)
    keyr = (slab[:, None, None] * (nbins + 1) + rbin[None]).reshape(-1)
    keys = slab[:, None, None].expand(dense.shape[1:]).reshape(-1)
    parts = [torch.bincount(key2, val_vol, nslab * nb2).view(nslab, nb2),
             torch.bincount(key2, vol, nslab * nb2).view(nslab, nb2),
             torch.bincount(keyr, val_vol, nslab * (nbins + 1))
             .view(nslab, nbins + 1),
             torch.bincount(keyr, vol, nslab * (nbins + 1))
             .view(nslab, nbins + 1)]
    for k in (2, 3, 4):
        parts.append(torch.bincount(keys, (dense[k] * dense[5]).reshape(-1),
                                    nslab)[:, None])
    parts.append(torch.bincount(keys, vol, nslab)[:, None])
    return torch.cat(parts, dim=1).cpu().numpy()


def main(args: dict) -> None:
    """CLI: sCO2 infile= comps="adv_0 adv_1 Var1 Var2 Var3 vfrac"
    planeCoord= [nBins=64] [nBinPlanes=10] [finestLevel=]
    [output_dir=Output] [out_mean_file=] [out_mcmt_file=]
    [device=cuda|cpu].  Loads float64."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    var_names = PlotfileReader(infile).var_names
    toks = pp.get_str_list("comps")
    if len(toks) != 6:
        raise ValueError("comps must list 6 entries: adv_0 adv_1 Var1 Var2 "
                         "Var3 vfrac")
    names = [var_names[int(t)] if t.lstrip("-").isdigit() else t
             for t in toks]
    plane_coord = pp.get_int("planeCoord")
    nbins = pp.query_int("nBins", 64)
    n_planes = pp.query_int("nBinPlanes", 10)

    ds = DenseAmrState.from_plotfile(
        infile, device, names=names,
        max_level=pp.query_int("finestLevel", None), dtype=torch.float64)
    lev = ds.meta.n_levels - 1
    geom = ds.meta.geoms[lev]
    dense = torch.movedim(flatten_to_level(ds, lev), 1 + plane_coord, 1)
    del ds                                        # [6, plane, a, b]
    na = [d for d in range(3) if d != plane_coord]
    plo = geom.prob_lo
    dx = geom.dx
    R = geom.prob_hi[na[0]]
    ya = plo[na[0]] + (np.arange(dense.shape[2]) + 0.5) * dx[na[0]]
    za = plo[na[1]] + (np.arange(dense.shape[3]) + 0.5) * dx[na[1]]
    r = np.sqrt(ya[:, None] ** 2 + za[None, :] ** 2)
    rbin = np.clip(((nbins - 1) * r / R).astype(int), 0, nbins)
    sums = slab_sums(dense, torch.from_numpy(rbin).to(device), nbins,
                     n_planes)
    n_pl = dense.shape[1]
    del dense

    out_dir = pp.query_str("output_dir", "Output")
    os.makedirs(out_dir, exist_ok=True)
    nb2 = nbins * nbins
    with open(pp.query_str("out_mean_file", f"{out_dir}/mean.dat"),
              "w") as mean_f, \
            open(pp.query_str("out_mcmt_file", f"{out_dir}/mcmt.dat"),
                 "w") as mcmt_f:
        for s, c0 in enumerate(range(0, n_pl, n_planes)):
            c1 = min(c0 + n_planes, n_pl)
            row = sums[s]
            wsum, w = row[:nb2], row[nb2:2 * nb2]
            rws = row[2 * nb2: 2 * nb2 + nbins + 1]
            rw = row[2 * nb2 + nbins + 1: 2 * nb2 + 2 * (nbins + 1)]
            tail = row[2 * nb2 + 2 * (nbins + 1):]
            bins2d = np.where(w > 0, wsum / np.maximum(w, 1e-300), 0.0)
            rprof = np.where(rw > 0, rws / np.maximum(rw, 1e-300), 0.0)
            vtot = max(tail[3], 1e-300)
            avgs = [tail[k] / vtot for k in range(3)]
            loc = plo[plane_coord] + (0.5 * (c0 + c1 - 1) + 0.5) \
                * dx[plane_coord]
            mean_f.write(f"{loc:e} " + " ".join(f"{a:e}" for a in avgs)
                         + "\n")
            mcmt_f.write(f"{loc:e} {rprof.max():e}\n")
            np.save(f"{out_dir}/bins2d_{c0:05d}.npy",
                    bins2d.reshape(nbins, nbins))
    print(f"wrote {out_dir}/mean.dat, mcmt.dat")
