"""``turbulenceSpectra`` — HIT kinetic-energy spectra and turbulence
statistics.

Counterpart of ``peleanalysis_tpu/tools/turbulence_spectra.py``, the
replacement for the reference's Turbulence_analysis pipeline
(Src/PythonScripts/Turbulence_analysis/: yt + FFTW2 + AmrDeriveSpectrum):
flatten the hierarchy to a uniform grid on the card, 3-D FFT of the
velocity there (``torch.fft.fftn``), shell-binned E(k) summed on the card
in float64 (``index_add_``; the JAX tool sums the shells on the host with
``np.add.at``, so the two agree to rounding, about 1e-13 of the largest
shell), plus the time-series statistics (urms, TKE) the
yt_post_scrape_tseries script collects.  Only E(k) and the statistics come
back to the host.  Outputs: ``<base>_<plt>_spectrum.dat`` rows of (k, E(k))
and ``<base>_stats.dat``.

Loads float64 whatever ``dtype=``.  ``prefetch=N`` (default 1) reads the
next N files on a background thread while the current one is transformed
(``io/prefetch.iter_states``); ``prefetch=0`` reads them one after
another.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..io.prefetch import iter_states, query_prefetch
from ..parmparse import ParmParse
from ..session import dense_state, select, var_names
from .flatten_amr import flatten_to_level
from .grad import refuse_unported

VEL = ["x_velocity", "y_velocity", "z_velocity"]


def energy_spectrum(u: torch.Tensor, v: torch.Tensor, w=None,
                    lengths=(1.0, 1.0, 1.0)):
    """Shell-averaged kinetic-energy spectrum E(k) of a periodic velocity
    field on a uniform grid (2-D or 3-D; pass w=None for 2-D), on the
    fields' device.  Returns float64 numpy (k, E) with sum(E) ~
    0.5<|u'|^2>."""
    vel = [u, v] + ([] if w is None else [w])
    n = tuple(u.shape)
    ndim = u.ndim
    dev = u.device
    vol = float(np.prod(n))
    e3 = 0.0
    for a in vel:
        ah = torch.fft.fftn(a - a.mean()) / vol
        e3 = e3 + ah.abs() ** 2
        del ah
    e3 = 0.5 * e3
    ks = [torch.fft.fftfreq(n[d], d=lengths[d] / n[d], dtype=torch.float64,
                            device=dev) * lengths[d] for d in range(ndim)]
    k2 = 0.0
    for d in range(ndim):
        shape = [1] * ndim
        shape[d] = n[d]
        k2 = k2 + (ks[d] ** 2).reshape(shape)
    kbin = torch.round(torch.sqrt(k2)).to(torch.int64)
    kmax = int(min(nn // 2 for nn in n))
    # corner modes with |k| > kmax are DROPPED, not clipped into the last
    # shell (shell-spectrum codes — the AmrDeriveSpectrum pipeline this
    # replaces — drop them)
    sel = kbin <= kmax
    E = torch.zeros(kmax + 1, dtype=torch.float64, device=dev)
    E.index_add_(0, kbin[sel], e3[sel].to(torch.float64))
    return np.arange(kmax + 1), E.cpu().numpy()


def turbulence_stats(u: torch.Tensor, v: torch.Tensor, w=None) -> dict:
    """urms, vrms, wrms (0 in 2-D), the isotropic urms and the TKE of the
    fluctuations about each component's mean; one copy to the host."""
    vel = [("u", u), ("v", v)] + ([] if w is None else [("w", w)])
    msq = torch.stack([((a - a.mean()) ** 2).mean() for _, a in vel])
    msq = msq.double().cpu().numpy()
    out = {"wrms": 0.0}
    tke = 0.0
    for (nm, _), m in zip(vel, msq):
        out[f"{nm}rms"] = float(np.sqrt(m))
        tke += 0.5 * float(m)
    out["urms_iso"] = float(np.sqrt(2.0 * tke / len(vel)))
    out["tke"] = tke
    return out


def main(args: dict) -> None:
    """CLI: turbulenceSpectra infile=<plt>... [level=finest]
    [outfile_base=turb] [prefetch=1 (files read ahead on a background
    thread; 0: one after another)] [device=cuda|cpu].  Loads float64 whatever dtype=."""
    pp = ParmParse(args)
    infiles = pp.get_str_list("infiles" if pp.contains("infiles") else "infile")
    base = pp.query_str("outfile_base", "turb")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    depth = query_prefetch(pp)

    def vel_of(plt):
        avail = var_names(args, plt)
        return [n for n in VEL if n in avail]

    rows = []
    for plt, src in iter_states(args, infiles, names=vel_of,
                                dtype=torch.float64, device=device,
                                depth=depth):
        meta = src.meta
        ds = select(dense_state(args, src, device, torch.float64),
                    vel_of(plt))
        del src
        lev = pp.query_int("level", meta.n_levels - 1)
        dense = flatten_to_level(ds, lev)
        del ds
        geom = meta.geoms[lev]
        L = tuple(h - l for l, h in zip(geom.prob_lo, geom.prob_hi))
        if meta.ndim2:
            u, v = dense[0][..., 0], dense[1][..., 0]
            k, E = energy_spectrum(u, v, None, L[:2])
            stats = turbulence_stats(u, v)
        else:
            k, E = energy_spectrum(dense[0], dense[1], dense[2], L)
            stats = turbulence_stats(dense[0], dense[1], dense[2])
        del dense
        tag = plt.rstrip("/").split("/")[-1]
        with open(f"{base}_{tag}_spectrum.dat", "w") as f:
            for ki, Ei in zip(k, E):
                f.write(f"{ki} {Ei:e}\n")
        rows.append((meta.time, stats))
    with open(f"{base}_stats.dat", "w") as f:
        f.write("# time urms_iso tke urms vrms wrms\n")
        for t, s in rows:
            f.write(f"{t:e} {s['urms_iso']:e} {s['tke']:e} "
                    f"{s['urms']:e} {s['vrms']:e} {s['wrms']:e}\n")
    print(f"wrote {base}_*.dat")
