"""``slicePlot`` — an axis-aligned slice of one variable at the finest
level, as a PPM/PGM image or a FAB.

Counterpart of ``peleanalysis_tpu/tools/slice_plot.py``, itself the
replacement for the reference's Src/slicePlot.cpp (degenerate-box FillVar
and palette render, slicePlot.cpp:29-56).  The variable loads in the
compute dtype and is flattened to the finest level over the whole domain
on the device (``flatten_amr.flatten_to_level``, linear: coarse data
interpolated up where the finest level does not cover); only the slice
comes to the host, where ``integral.write_ppm``/``write_pgm`` render it
(amrvis ``.pal`` palettes accepted).
"""
from __future__ import annotations

import numpy as np

from .. import config
from ..amr.box import Box
from ..amr.dense import DenseAmrState
from ..io.fab import write_fab
from ..parmparse import ParmParse
from ..session import load_dense
from .flatten_amr import flatten_to_level
from .grad import refuse_unported
from .integral import write_pgm, write_ppm


def slice_field(ds: DenseAmrState, var: str, direction: int, idx: int
                ) -> np.ndarray:
    """2-D float64 slice at finest-level cell index ``idx`` (clipped into
    the domain) along ``direction``."""
    lev = ds.meta.n_levels - 1
    n = ds.meta.geoms[lev].domain.shape[direction]
    dense = flatten_to_level(ds, lev)[ds.comp(var)]
    i = int(np.clip(idx, 0, n - 1))
    return dense.select(direction, i).double().cpu().numpy()


def read_amrvis_palette(path: str) -> np.ndarray:
    """amrvis .pal file: 256 (or fewer) R,G,B byte triples (the format the
    reference loads at slicePlot.cpp:76 via loadPalette)."""
    raw = np.fromfile(path, dtype=np.uint8)
    n = len(raw) // 3
    return raw[: 3 * n].reshape(n, 3)


def main(args: dict) -> None:
    """CLI (reference keys, slicePlot.cpp:28-90): slicePlot file= varname=
    slicedir= sliceloc=<finest cell index> [finestLevel=] [outtype=image|
    gray|fab] [min=] [max=] [palette=<amrvis .pal>] [outfile=]
    [device=cuda|cpu].  Aliases: infile= var= dir= loc=<physical>
    format=ppm|pgm|fab.  Computes in the compute dtype."""
    pp = ParmParse(args)
    infile = pp.query_str("file", None) or pp.get_str("infile")
    var = pp.query_str("varname", None) or pp.query_str("var", "temp")
    direction = pp.query_int("slicedir", pp.query_int("dir", 2))
    finest = pp.query_int("finestLevel", None)
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    ds = load_dense(args, infile, device, config.compute_dtype, names=[var],
                    max_level=finest)
    geom = ds.meta.geoms[ds.meta.n_levels - 1]
    if pp.contains("sliceloc"):
        idx = pp.get_int("sliceloc")
    else:
        loc = pp.query_float(
            "loc", 0.5 * (geom.prob_lo[direction] + geom.prob_hi[direction]))
        idx = int((loc - geom.prob_lo[direction]) / geom.dx[direction])

    out_type = pp.query_str("outtype", None)
    if out_type is None:
        fmt = pp.query_str("format", "ppm")
        out_type = {"ppm": "image", "pgm": "gray"}.get(fmt, fmt)
    img = slice_field(ds, var, direction, idx)
    ext = {"image": "ppm", "gray": "pgm"}.get(out_type, "fab")
    outfile = pp.query_str(
        "outfile", f"{infile}_{var}_d{direction}_{idx}.{ext}")
    if out_type in ("image", "gray"):
        vmin = pp.query_float("min", None)
        vmax = pp.query_float("max", None)
        if out_type == "gray":
            # true P5 grayscale like the reference's STORE_PGM_STR
            # (slicePlot.cpp:86-88,137-138), not a P6 with equal channels
            write_pgm(outfile, img, vmin=vmin, vmax=vmax)
        else:
            pal = "rainbow"
            if pp.contains("palette"):
                pal = read_amrvis_palette(pp.get_str("palette"))
            write_ppm(outfile, img, vmin=vmin, vmax=vmax, palette=pal)
    else:
        with open(outfile, "wb") as f:
            write_fab(f, Box((0, 0, 0),
                             (img.shape[0] - 1, img.shape[1] - 1, 0)),
                      img[None, :, :, None])
    print(f"wrote {outfile}")
