"""``buildDistance`` — a signed-distance plotfile from an MEF surface.

Counterpart of ``peleanalysis_tpu/tools/build_distance.py``, itself the
replacement for the reference's Src/buildDistance.cpp (SDFGen per box, the
same path as isosurface.cpp:1595-1654; distances clamped to ``dmax``).
The plotfile loads in float64 on the device (only ``signComp`` when given)
and every level's distance is computed there by ``geom/sdf.py``; the band
seeding evaluates in the compute dtype, as the JAX CLI's does with x64 off
(float32) or on (``dtype=float64``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..amr.dense import DenseAmrState
from ..amr.hierarchy import load_plotfile_fabs
from ..geom.sdf import signed_distance_dense
from ..io.mef import read_mef
from ..io.plotfile import PlotfileReader
from ..parmparse import ParmParse
from .grad import refuse_unported


def distance_state(ds: DenseAmrState, tri_verts: np.ndarray, dmax: float,
                   sign_field=None, iso_val: float = 0.0) -> DenseAmrState:
    """The state's hierarchy holding one component, ``distance``."""
    levels = [signed_distance_dense(ds, tri_verts, lev, dmax, sign_field,
                                    iso_val, config.compute_dtype)[None]
              for lev in range(ds.meta.n_levels)]
    return ds.with_data(["distance"], levels)


def main(args: dict) -> None:
    """CLI: buildDistance infile=<plt> isoFile=<mef> [dmax=<4*dx_finest>]
    [signComp=<field> isoVal=0] [finestLevel=] [outfile=<infile>_dist]
    [device=cuda|cpu].  Writes float64."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    mef = read_mef(pp.get_str("isoFile"))
    sign_field = pp.query_str("signComp", None)
    # the hierarchy, and the sign field if any (else one component)
    meta, names, fabs = load_plotfile_fabs(
        infile, names=[sign_field] if sign_field
        else PlotfileReader(infile).var_names[:1],
        max_level=pp.query_int("finestLevel", None))
    ds = DenseAmrState.from_level_fabs(meta, names, fabs, device,
                                       torch.float64)
    fin = meta.n_levels - 1
    dmax = pp.query_float("dmax", 4.0 * meta.geoms[fin].dx[0])
    iso_val = pp.query_float("isoVal", 0.0)
    out = distance_state(ds, mef.positions()[mef.elements], dmax, sign_field,
                         iso_val)
    outfile = pp.query_str("outfile", infile + "_dist")
    out.to_plotfile(outfile)
    print(f"wrote {outfile}")
