"""``avgToPlane`` — average plotfile variables along one axis onto a plane.

Counterpart of ``peleanalysis_tpu/tools/avg_to_plane.py``, a working
version of the reference's Src/avgToPlane.cpp (flagged BROKEN in its
GNUmakefile:32) with the same surface: PPM, text or FAB planes.  Built on
the integral engine: the average along ``dir`` is ``integrate_along`` with
``avg=True`` (each level's sums on the device in the compute dtype, one
copy a level).
"""
from __future__ import annotations

from .. import config
from ..amr.box import Box
from ..io.fab import write_fab
from ..parmparse import ParmParse
from ..session import load_dense
from .grad import refuse_unported
from .integral import integrate_along, write_dat_2d, write_ppm


def main(args: dict) -> None:
    """CLI: avgToPlane infile= vars=<names> [dir=2] [format=fab|ppm|dat]
    [outfile_base=<infile>_avgplane] [device=cuda|cpu].  Computes in the
    compute dtype."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    var_names = pp.get_str_list("vars")
    direction = pp.query_int("dir", 2)
    fmt = pp.query_str("format", "fab")
    base = pp.query_str("outfile_base", infile + "_avgplane")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    ds = load_dense(args, infile, device, config.compute_dtype,
                    names=var_names)
    _, _, fields = integrate_along(ds, var_names, [direction], avg=True)
    for n, v in zip(var_names, fields):
        if fmt == "ppm":
            write_ppm(f"{base}_{n}.ppm", v)
        elif fmt == "dat":
            write_dat_2d(f"{base}_{n}.dat", v)
        else:
            with open(f"{base}_{n}.fab", "wb") as f:
                write_fab(f, Box((0, 0, 0),
                                 (v.shape[0] - 1, v.shape[1] - 1, 0)),
                          v[None, :, :, None])
    print(f"wrote {base}*")
