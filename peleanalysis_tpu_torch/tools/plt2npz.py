"""``plt2npz`` / ``npz2plt`` — a plotfile to a NumPy ``.npz`` archive and
back.

Counterpart of ``peleanalysis_tpu/tools/plt2npz.py`` (no reference
analog; the bridge to numpy and ML tooling), with the same archive keys:

  * ``mode=levels``: ``lev<k>`` ``[ncomp, nx, ny, nz]`` over the level's
    union bbox (holes zero), ``lev<k>_valid`` (uncovered and in-level) and
    ``lev<k>_lo`` (the bbox origin);
  * ``mode=flat``: ``data``, one array at the finest resolution over the
    whole domain, coarse regions upsampled (``interp=linear|pc``) on the
    device by ``flatten_amr.flatten_to_level``;
  * both: ``names``, ``time``, ``prob_lo``/``prob_hi`` and ``dx<k>``.

The plotfile loads in float64 on the device, only the selected components.
``npz2plt`` writes a single-level float64 plotfile from a dense ``[ncomp,
nx, ny, nz]`` (or ``[nx, ny, nz]``) array, its boxes packed on the device;
a ``mode=flat`` archive round-trips bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..amr.box import Box, decompose
from ..amr.dense import DenseAmrState, PlotfileRecords
from ..amr.geometry import Geometry
from ..amr.hierarchy import AmrMeta
from ..io.plotfile import PlotfileReader
from ..parmparse import ParmParse
from .flatten_amr import flatten_to_level
from .grad import refuse_unported


def plt_arrays(ds: DenseAmrState, mode: str, interp: str = "linear"
               ) -> dict:
    """The archive's arrays of a state holding the selected components."""
    meta = ds.meta
    out = {
        "names": np.array(ds.names),
        "time": np.float64(meta.time),
        "prob_lo": np.asarray(meta.geoms[0].prob_lo),
        "prob_hi": np.asarray(meta.geoms[0].prob_hi),
    }
    for lev in range(meta.n_levels):
        out[f"dx{lev}"] = np.asarray(meta.geoms[lev].dx)
    if mode == "flat":
        out["data"] = flatten_to_level(ds, meta.n_levels - 1,
                                       interp).cpu().numpy()
    elif mode == "levels":
        for lev in range(meta.n_levels):
            out[f"lev{lev}"] = ds.data[lev].cpu().numpy()
            out[f"lev{lev}_valid"] = ds.valid_mask_np(lev)
            out[f"lev{lev}_lo"] = np.asarray(ds.lmeta[lev].bbox.lo)
    else:
        raise ValueError(f"mode={mode!r}: expected levels or flat")
    return out


def main(args: dict) -> None:
    """CLI: plt2npz infile= [outfile=<infile>.npz] [vars=all]
    [mode=levels|flat] [interp=linear|pc] [finestLevel=] [device=cuda|cpu]
         npz2plt infile=<npz|npy> outfile= [vars=] [prob_lo/hi=] [time=]
    [max_grid_size=64] [device=cuda|cpu]"""
    if args.get("_tool", ["plt2npz"])[0] == "npz2plt":
        return npz2plt(args)
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    outfile = pp.query_str("outfile", infile.rstrip("/") + ".npz")
    mode = pp.query_str("mode", "levels")
    finest = pp.query_int("finestLevel", None)
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    names = pp.query_str_list("vars", PlotfileReader(infile).var_names)
    interp = pp.query_str("interp", "linear") if mode == "flat" else None
    ds = DenseAmrState.from_plotfile(infile, device, names=names,
                                     max_level=finest, dtype=torch.float64)
    np.savez_compressed(outfile, **plt_arrays(ds, mode, interp))
    print(f"wrote {outfile} ({mode}, {len(names)} comps, "
          f"{ds.meta.n_levels} levels)")


def read_npz(path: str):
    """(data, names, prob_lo, prob_hi, time) of a ``.npy`` array or a
    ``.npz`` archive (``data``, else ``lev0``; the metadata where
    present)."""
    if path.endswith(".npy"):
        return np.load(path), None, None, None, 0.0
    z = np.load(path)
    data = z["data"] if "data" in z else z["lev0"]
    names = [str(n) for n in z["names"]] if "names" in z else None
    plo = z["prob_lo"] if "prob_lo" in z else None
    phi = z["prob_hi"] if "prob_hi" in z else None
    time = float(z["time"]) if "time" in z else 0.0
    return data, names, plo, phi, time


def npz2plt(args: dict) -> None:
    """Single-level plotfile from a dense array (module docstring)."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    outfile = pp.get_str("outfile")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    data, names, plo, phi, time = read_npz(infile)
    if data.ndim == 3:
        data = data[None]
    if data.ndim != 4:
        raise ValueError(f"expected [ncomp, nx, ny, nz] data, got "
                         f"{data.shape}")
    ncomp = data.shape[0]
    names = pp.query_str_list(
        "vars", names or [f"comp_{i}" for i in range(ncomp)])
    if len(names) != ncomp:
        raise ValueError(f"{len(names)} names for {ncomp} comps")
    plo = tuple(pp.query_float_list(
        "prob_lo", list(plo) if plo is not None else [0.0, 0.0, 0.0]))
    phi = tuple(pp.query_float_list(
        "prob_hi", list(phi) if phi is not None else [1.0, 1.0, 1.0]))
    time = pp.query_float("time", time)
    dom = Box((0, 0, 0), tuple(s - 1 for s in data.shape[1:]))
    geom = Geometry(dom, plo, phi, (False,) * 3)
    ba = decompose(dom, pp.query_int("max_grid_size", 64))
    dense = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    out = PlotfileRecords(AmrMeta([geom], [ba], [], time), list(names),
                          np.float64)
    out.add(0, dense, dom, range(len(ba)))
    out.write(outfile)
    print(f"wrote {outfile} ({ncomp} comps, {dom.shape} cells)")
