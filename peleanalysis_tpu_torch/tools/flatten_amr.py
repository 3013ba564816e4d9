"""``flattenAMRFile`` — flatten a plotfile to one uniform level.

Counterpart of ``peleanalysis_tpu/tools/flatten_amr.py``, itself the
replacement for the reference's Src/flattenAMRFile.cpp (output_level +
output_max_grid_size, PltFileManager interpolation).  Produces the FULL
domain at output_level resolution on the state's device: level 0 is
upsampled level by level (linear, or pc), each finer level's data overlaid
where it exists.  Loads float64 whatever ``dtype=``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..amr.box import decompose
from ..amr.dense import DenseAmrState
from ..io.plotfile import write_plotfile
from ..ops.dense_fill import _upsample_axis
from ..parmparse import ParmParse
from ..session import load_dense
from .grad import refuse_unported


def flatten_to_level(ds: DenseAmrState, output_level: int,
                     interp: str = "linear") -> torch.Tensor:
    """Dense [ncomp, *domain_shape(output_level)] covering the full domain,
    on the state's device."""
    meta = ds.meta
    cur = ds.data[0]  # level 0 covers the domain
    for lev in range(1, output_level + 1):
        r = meta.ref_ratio[lev - 1]
        for d in range(3):
            cur = _upsample_axis(cur, d, r, interp == "linear")
        bbox = ds.lmeta[lev].bbox
        dom = meta.geoms[lev].domain
        # overlay fine data where the level covers
        sl = (slice(None),) + tuple(slice(bbox.lo[d] - dom.lo[d],
                                          bbox.hi[d] - dom.lo[d] + 1)
                                    for d in range(3))
        cur[sl] = torch.where(ds.in_level_mask(lev)[None], ds.data[lev],
                              cur[sl])
    return cur


def main(args: dict) -> None:
    """CLI: flattenAMRFile infile= [outfile=<infile>_flat]
    [output_level=finest] [output_max_grid_size=32] [interp=linear|pc]
    [device=cuda|cpu].  Loads float64 whatever dtype=."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    ds = load_dense(args, infile, device, torch.float64, widen_ok=True)
    meta, names = ds.meta, ds.names
    lev = pp.query_int("output_level", meta.n_levels - 1)
    mgs = pp.query_int("output_max_grid_size", 32)
    dense = flatten_to_level(ds, lev, pp.query_str("interp", "linear"))
    del ds
    dense = dense.cpu().numpy()
    geom = meta.geoms[lev]
    dom = geom.domain
    ba = decompose(dom, mgs)
    fabs = []
    for b in ba:
        sl = (slice(None),) + tuple(
            slice(b.lo[d] - dom.lo[d], b.hi[d] - dom.lo[d] + 1)
            for d in range(3))
        fabs.append(np.ascontiguousarray(dense[sl]))
    outfile = pp.query_str("outfile", infile + "_flat")
    write_plotfile(outfile, names, meta.time, [geom], [], [ba], [fabs])
    print(f"wrote {outfile}")
