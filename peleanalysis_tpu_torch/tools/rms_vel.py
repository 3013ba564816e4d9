"""``rmsVel`` — u' RMS per plotfile in a time series.

Counterpart of ``peleanalysis_tpu/tools/rms_vel.py``, itself the
replacement for the reference's Src/rmsVel.cpp: reads x/y/z_velocity at
the finest level only, accumulates volume-weighted <u> and <u^2>
(rmsVel.cpp:82-116), writes "RmsVel.dat" rows of (time, urms) with
urms = sqrt(mean over dims of (<u_d^2> - <u_d>^2)) (rmsVel.cpp:125-127).

The sums run on the state's device in the compute dtype, and a file's sums
come to the host in one copy.  ``prefetch=N`` (default 1) reads the next
N files on a background thread while the current one is summed
(``io/prefetch.iter_states``); ``prefetch=0`` reads them one after
another.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..amr.dense import DenseAmrState
from ..io.prefetch import iter_states, query_prefetch
from ..parmparse import ParmParse
from ..session import dense_state, var_names
from .grad import refuse_unported

VEL = ["x_velocity", "y_velocity", "z_velocity"]


def rms_velocity(ds: DenseAmrState) -> float:
    """Finest-level-only, matching the reference (all finest cells count —
    no covered-mask since nothing covers the finest level).  2-D plotfiles
    average over the two in-plane components."""
    fin = ds.meta.n_levels - 1
    vel = VEL[:2] if ds.meta.ndim2 else VEL
    m = ds.in_level_mask(fin)
    vol = float(np.sum(ds.in_level_mask_np(fin)))
    sums = []
    for name in vel:
        u = ds.data[fin][ds.comp(name)]
        sums += [torch.where(m, u, 0.0).sum(), torch.where(m, u * u, 0.0).sum()]
    # every sum of the file in one device-to-host copy
    host = torch.stack(sums).double().cpu().numpy()
    var_sum = 0.0
    for k in range(len(vel)):
        ub = float(host[2 * k]) / vol
        u2 = float(host[2 * k + 1]) / vol
        var_sum += u2 - ub * ub
    return float(np.sqrt(var_sum / len(vel)))


def main(args: dict) -> None:
    """CLI: rmsVel infile=<plt>... [finestLevel=] [outfile=RmsVel.dat]
    [prefetch=1 (files read ahead on a background thread; 0: one after
    another)] [device=cuda|cpu].  Computes in the compute dtype (float32 unless
    dtype=float64)."""
    pp = ParmParse(args)
    infiles = pp.get_str_list("infiles" if pp.contains("infiles") else "infile")
    finest = pp.query_int("finestLevel", None)
    out = pp.query_str("outfile", "RmsVel.dat")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    depth = query_prefetch(pp)

    def vel_of(plt):
        avail = var_names(args, plt)
        vel = [n for n in VEL if n in avail]
        if len(vel) < 2:
            raise ValueError(f"{plt}: no velocity components found "
                             f"(have {avail})")
        return vel

    rows = []
    for _, src in iter_states(args, infiles, names=vel_of, max_level=finest,
                              dtype=config.compute_dtype, device=device,
                              depth=depth):
        ds = dense_state(args, src, device, config.compute_dtype)
        rows.append((src.meta.time, rms_velocity(ds)))
        del ds
    with open(out, "w") as f:
        for t, u in rows:
            f.write(f"{t:e} {u:e}\n")
    print(f"wrote {out}")
