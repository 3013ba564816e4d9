"""``regridPlt`` — re-grid a plotfile onto a new BoxArray layout.

Counterpart of ``peleanalysis_tpu/tools/regrid_plt.py``, itself the
replacement for the reference's Src/regridPlt.cpp: each level's union
bbox is chunked by ``max_grid_size`` and each chunk trimmed to the bounding
box of its covered cells (``covered_chunks``; the box list is part of the
output, so the rule is the JAX one exactly).  The plotfile loads in
float64 on the device; each level's new boxes are cut from its dense
tensor there and come to the host in one copy.  As in the JAX tool, the
output keeps the in-memory 3-D geometry (a DIM=2 source is written
promoted) and no level steps.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import config
from ..amr.box import Box, BoxArray, decompose
from ..amr.dense import DenseAmrState, PlotfileRecords
from ..amr.hierarchy import AmrMeta
from ..parmparse import ParmParse
from ..session import load_dense
from .grad import refuse_unported


def covered_chunks(bbox: Box, mask: np.ndarray,
                   max_grid_size: int) -> List[Box]:
    """The chunks of ``decompose(bbox, max_grid_size)`` that hold a True
    cell of ``mask`` (bool over bbox), each partly covered chunk trimmed
    to the bounding box of its True cells."""
    boxes = []
    for b in decompose(bbox, max_grid_size):
        sl = tuple(slice(b.lo[d] - bbox.lo[d], b.hi[d] - bbox.lo[d] + 1)
                   for d in range(3))
        m = mask[sl]
        if not m.any():
            continue
        if not m.all():
            idx = np.argwhere(m)
            lo, hi = idx.min(axis=0), idx.max(axis=0)
            b = Box(tuple(b.lo[d] + int(lo[d]) for d in range(3)),
                    tuple(b.lo[d] + int(hi[d]) for d in range(3)))
        boxes.append(b)
    return boxes


def regrid(ds: DenseAmrState, max_grid_size: int) -> PlotfileRecords:
    meta = ds.meta
    bas = [BoxArray(covered_chunks(ds.lmeta[lev].bbox,
                                   ds.in_level_mask_np(lev), max_grid_size))
           for lev in range(meta.n_levels)]
    out = PlotfileRecords(AmrMeta(list(meta.geoms), bas,
                                  list(meta.ref_ratio), meta.time),
                          ds.names, np.float64)
    for lev in range(meta.n_levels):
        out.add(lev, ds.data[lev], ds.lmeta[lev].bbox, range(len(bas[lev])))
    return out


def main(args: dict) -> None:
    """CLI: regridPlt infile= [outfile=<infile>_rg] [max_grid_size=32]
    [device=cuda|cpu].  Loads and writes float64."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    mgs = pp.query_int("max_grid_size", 32)
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    ds = load_dense(args, infile, device, torch.float64, widen_ok=True)
    outfile = pp.query_str("outfile", infile + "_rg")
    regrid(ds, mgs).write(outfile)
    print(f"wrote {outfile}")
