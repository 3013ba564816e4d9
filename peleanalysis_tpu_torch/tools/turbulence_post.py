"""HIT post-processing pipeline — the Turbulence_analysis analog.

Counterpart of ``peleanalysis_tpu/tools/turbulence_post.py``, which
replaces the reference's Src/PythonScripts/Turbulence_analysis/ (yt + FFTW2
+ AmrDeriveSpectrum + AMReX AugmentPlotfile):

  augmentPlotfile    add vorticity components/magvort and divu to a plotfile
                     (the AMReX Tools/C_util/AugmentPlotfile step of post.sh)
  turbulenceTseries  volume-weighted <kin_energy>, <|omega|^2>, <T'^2>,
                     <divu^2> per plotfile in a run directory, nondimension-
                     alized from ic.txt -> tseries.csv
                     (yt_post_scrape_tseries.py + yt_post_scrape_common.py)
  turbulenceSlice    mid-plane slice + x-line profiles of the slice fields
                     (yt_post_scrape_slice.py; line at the domain midpoint)
  varfieldAverage    cell-mass-weighted average of one variable
                     (solution_varfield_average.py)

Plotfiles load in float64, periodic by default.  Each velocity component's
gradient on a level is one ``grad_mag`` call on its 1-ghost grown field:
the CUDA kernel on the card.  Weighted averages reduce on the device, and
each level's sums come to the host in one copy.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List

import numpy as np
import torch

from .. import config
from ..amr.dense import DenseAmrState
from ..io.plotfile import PlotfileReader
from ..native import savetxt_fast
from ..ops.dense_fill import fill_dense_multilevel
from ..ops.grad_kernels import grad_mag
from ..parmparse import ParmParse
from .grad import refuse_unported

GAMMA = 1.4   # yt_post_scrape_common.py:25
VEL = ["x_velocity", "y_velocity", "z_velocity"]


def load_dim_consts(rootdir: str) -> Dict[str, float]:
    """Parse ic.txt (headings line + values line, comma separated —
    yt_post_scrape_common.py load_dim_consts)."""
    with open(os.path.join(rootdir, "ic.txt")) as f:
        lines = f.read().replace(" ", "").split("\n")
    headings = lines[0].split(",")
    vals = [float(v) for v in lines[1].split(",") if v]
    return dict(zip(headings, vals))


def _list_plotfiles(root: str) -> List[str]:
    out = []
    for p in sorted(glob.glob(os.path.join(root, "plt*"))):
        if os.path.isdir(p) and re.search(r"plt[0-9]+$", p):
            out.append(p)
    return out


def _dense(path, names, device, is_periodic=(True, True, True)):
    # HIT boxes are periodic (the reference pipeline is written for the
    # PeleC HIT regression case); plotfile headers don't store periodicity,
    # so default to periodic — tools expose is_per to override
    return DenseAmrState.from_plotfile(path, device, names=names,
                                       is_periodic=list(is_periodic),
                                       dtype=torch.float64)


def _vort_divu(ds: DenseAmrState):
    """Vorticity components + divergence from velocity gradients (the
    vort_*_func / dilatation_func definitions,
    yt_post_scrape_common.py:71-120).  Returns per-level lists of
    (wx, wy, wz, |w|, divu)."""
    meta = ds.meta
    masks = [ds.in_level_mask(l) for l in range(meta.n_levels)]
    comps = [ds.comp(n) for n in VEL]
    vel = [d[comps] for d in ds.data]
    grown = fill_dense_multilevel(meta, ds.lmeta, vel, masks, 1, None,
                                  "linear")
    out = []
    for lev, g in enumerate(grown):
        dx = meta.geoms[lev].dx
        # gU[i][j] = d u_i / d x_j: one kernel launch per component
        gU = [grad_mag(g[d: d + 1].contiguous(), dx, with_mag=False)
              for d in range(3)]
        wx = gU[2][1] - gU[1][2]
        wy = gU[0][2] - gU[2][0]
        wz = gU[1][0] - gU[0][1]
        divu = gU[0][0] + gU[1][1] + gU[2][2]
        magv = torch.sqrt(wx * wx + wy * wy + wz * wz)
        out.append((wx, wy, wz, magv, divu))
    return out


def _wavg(ds: DenseAmrState, per_level_vals, weight_levels=None) -> float:
    """Volume-weighted average over valid cells of all levels (the
    yt weighted_average_quantity(..., 'cell_volume') analog)."""
    num = den = 0.0
    for lev in range(ds.meta.n_levels):
        vol = float(np.prod(ds.meta.geoms[lev].dx))
        w = ds.valid_mask(lev).to(torch.float64) * vol
        if weight_levels is not None:
            w = w * weight_levels[lev]
        # the level's two sums in one device-to-host copy
        s = torch.stack([(w * per_level_vals[lev]).sum(), w.sum()]).cpu()
        num += float(s[0])
        den += float(s[1])
    return num / max(den, 1e-300)


def augment_plotfile(infile: str, outfile: str, add_vorticity: bool = True,
                     add_divergence: bool = True,
                     is_periodic=(True, True, True), device="cuda") -> None:
    """AugmentPlotfile analog: append x/y/z_vorticity, magvort and divu
    components computed from the velocity field."""
    ds = _dense(infile, None, device, is_periodic=is_periodic)
    vd = _vort_divu(ds)
    new_names = []
    if add_vorticity:
        new_names += ["x_vorticity", "y_vorticity", "z_vorticity", "magvort"]
    if add_divergence:
        new_names += ["divu"]
    out_levels = []
    for lev in range(ds.meta.n_levels):
        wx, wy, wz, magv, divu = vd[lev]
        extra = []
        if add_vorticity:
            extra += [wx, wy, wz, magv]
        if add_divergence:
            extra += [divu]
        out_levels.append(torch.cat([ds.data[lev]]
                                    + [e[None] for e in extra], dim=0))
    ds.with_data(list(ds.names) + new_names, out_levels).to_plotfile(outfile)


def _temp_field(path: str):
    r = PlotfileReader(path)
    return next((n for n in r.var_names if "temp" in n.lower()), None)


def scrape_tseries(root: str, method: str = "UnknownMethod",
                   device="cuda") -> str:
    """Per-plotfile volume-weighted averages + ic.txt nondimensionalization
    -> <root>/tseries.csv (column layout like yt_post_scrape_tseries.py:
    tau column first, one column per quantity, one row per time)."""
    dc = load_dim_consts(root)
    plts = _list_plotfiles(root)
    if not plts:
        raise ValueError(f"no plt[0-9]* plotfiles under {root}")
    rows = []
    for plt in plts:
        temp_field = _temp_field(plt)
        need = list(VEL) + ([temp_field] if temp_field else [])
        ds = _dense(plt, need, device)
        vd = _vort_divu(ds)
        ke = [sum(ds.data[l][ds.comp(n)] ** 2 for n in VEL)
              for l in range(ds.meta.n_levels)]
        res = {
            "time": ds.meta.time,
            "kin_energy_avg": _wavg(ds, ke),
            "magvort_sq_avg": _wavg(ds, [v[3] ** 2 for v in vd]),
            "divu_sq_avg": _wavg(ds, [v[4] ** 2 for v in vd]),
        }
        if temp_field:
            it = ds.comp(temp_field)
            t_avg = _wavg(ds, [d[it] for d in ds.data])
            res["temp_var_sq_avg"] = _wavg(
                ds, [(d[it] - t_avg) ** 2 for d in ds.data])
        else:
            res["temp_var_sq_avg"] = 0.0
        del ds, vd, ke
        # nondimensionalization (yt_post_scrape_tseries.py:120-133)
        res.update({
            "time_adim": res["time"] / dc["tau"],
            "kin_energy_avg_adim": res["kin_energy_avg"]
            / (3 * dc["urms0"] ** 2),
            "urms_computed": float(np.sqrt(res["kin_energy_avg"] / 3)),
            "Mach_t_computed": float(np.sqrt(res["kin_energy_avg"])
                                     / dc["c_s0"]),
            "magvort_sq_avg_adim": res["magvort_sq_avg"]
            / (dc["urms0"] / dc["lambda0"]) ** 2,
            "temp_var_sq_avg_adim": res["temp_var_sq_avg"]
            / ((GAMMA - 1) * dc["T0"] * dc["Mach"] ** 2) ** 2,
            "divu_sq_avg_adim": res["divu_sq_avg"]
            / (dc["urms0"] / dc["lambda0"]) ** 2,
        })
        rows.append(res)
    keys = ["time_adim", "kin_energy_avg_adim", "urms_computed",
            "Mach_t_computed", "magvort_sq_avg_adim",
            "temp_var_sq_avg_adim", "divu_sq_avg_adim"]
    out = os.path.join(root, "tseries.csv")
    with open(out, "w") as f:
        f.write(",".join(["tau"] + keys[1:]) + "\n")
        for r_ in rows:
            f.write(",".join(str(r_[k]) for k in keys) + "\n")
    return out


def scrape_slice(root: str, plotfile: str, device="cuda") -> str:
    """Mid-plane (z) slice of kin_energy/temp'/divu/magvort + x-line
    profiles through the domain midpoint -> <plotfile>_slice.dat
    (the yt_post_scrape_slice.py ortho_ray + SlicePlot scrape)."""
    dc = load_dim_consts(root)
    path = plotfile if os.path.isdir(plotfile) \
        else os.path.join(root, plotfile)
    temp_field = _temp_field(path)
    need = list(VEL) + ([temp_field] if temp_field else [])
    ds = _dense(path, need, device)
    vd = _vort_divu(ds)
    lev = 0
    g = ds.meta.geoms[lev]
    shp = ds.lmeta[lev].bbox.shape
    jmid, kmid = shp[1] // 2, shp[2] // 2
    d0 = ds.data[lev]
    ke = sum(d0[ds.comp(n)] ** 2 for n in VEL)
    if temp_field:
        it = ds.comp(temp_field)
        t_avg = _wavg(ds, [d[it] for d in ds.data])
        tvar = d0[it] - t_avg
    else:
        tvar = torch.zeros_like(ke)
    # the x line of each field and the z-midplane slice of kin_energy: one
    # device-to-host copy
    line = torch.stack([vd[lev][4][:, jmid, kmid], tvar[:, jmid, kmid],
                        vd[lev][3][:, jmid, kmid], ke[:, jmid, kmid]])
    host = torch.cat([line, ke[:, :, kmid].T]).cpu().numpy()
    line, ke_slice = host[:4], host[4:].T
    x = g.prob_lo[0] + (np.arange(shp[0]) + 0.5) * g.dx[0]
    dil = dc["urms0"] / dc["lambda0"]
    tv = (GAMMA - 1) * dc["T0"] * dc["Mach"] ** 2
    prof = np.stack([x, line[0] / dil, line[1] / tv, line[2] / dil,
                     line[3] / (3 * dc["urms0"] ** 2)], axis=1)
    out = path + "_slice.dat"
    with open(out, "wb") as f:
        f.write(b"# x-line profiles through the domain midpoint; adim "
                b"factors from ic.txt\n")
        f.write(b"# x divu_adim temp_var_adim magvort_adim kin_energy_adim\n")
        savetxt_fast(f, prof, fmt="%.9g")
        f.write(f"\n# z-midplane slice of kin_energy [{shp[0]}x{shp[1]}]\n"
                .encode())
        savetxt_fast(f, ke_slice, fmt="%.9g")
    return out


def varfield_average(plotfile: str, var: str, device="cuda") -> float:
    """Cell-mass-weighted (density * volume) average of one variable
    (solution_varfield_average.py)."""
    ds = _dense(plotfile, [var, "density"], device)
    idv = ds.comp("density")
    iv = ds.comp(var)
    avg = _wavg(ds, [d[iv] for d in ds.data],
                weight_levels=[d[idv] for d in ds.data])
    print(f"Average {var} (weighted by cell_mass) is {avg:0.3e}")
    return avg


def main(args: dict) -> None:
    """CLI: augmentPlotfile infile= [outfile=<infile>_aug] [add_vorticity=1]
    [add_divergence=1] [is_per=1 1 1] | turbulenceTseries root_dir=
    [method=] | turbulenceSlice root_dir= plotfile= | varfieldAverage
    plotfile= var=; each with [device=cuda|cpu].  Loads float64 whatever
    dtype=."""
    pp = ParmParse(args)
    tool = args.get("_tool", ["?"])[0]
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    if tool == "augmentPlotfile":
        infile = pp.get_str("infile")
        outfile = pp.query_str("outfile", infile + "_aug")
        augment_plotfile(infile, outfile,
                         pp.query_bool("add_vorticity", True),
                         pp.query_bool("add_divergence", True),
                         is_periodic=tuple(
                             bool(p) for p in
                             pp.query_int_list("is_per", [1, 1, 1])),
                         device=device)
        print(f"wrote {outfile}")
    elif tool == "turbulenceTseries":
        out = scrape_tseries(pp.get_str("root_dir"),
                             pp.query_str("method", "UnknownMethod"),
                             device=device)
        print(f"wrote {out}")
    elif tool == "turbulenceSlice":
        out = scrape_slice(pp.get_str("root_dir"), pp.get_str("plotfile"),
                           device=device)
        print(f"wrote {out}")
    elif tool == "varfieldAverage":
        varfield_average(pp.get_str("plotfile"), pp.get_str("var"),
                         device=device)
    else:
        raise ValueError(f"unknown turbulence tool {tool}")
