"""``subPlt`` — crop a plotfile in space and components.

Counterpart of ``peleanalysis_tpu/tools/sub_plt.py``, itself the
replacement for the reference's Src/subPlt.cpp: the level-0 ``box=`` and
its refined images on the finer levels, the physical extents shrunk to the
box, FAB_IEEE_32 output (subPlt.cpp:48).  The plotfile loads in float64 on
the state's device; each level's cropped boxes are cut, cast to float32
and reduced to their min/max tables there, and come to the host in one
copy (``PlotfileRecords``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..amr.box import Box, BoxArray
from ..amr.dense import DenseAmrState, PlotfileRecords
from ..amr.geometry import Geometry
from ..amr.hierarchy import AmrMeta
from ..parmparse import ParmParse
from ..session import load_dense, var_names
from .grad import refuse_unported


def sub_plotfile(ds: DenseAmrState, sub_box0: Box) -> PlotfileRecords:
    """The hierarchy cropped to the refinement images of ``sub_box0``
    (level-0 index space) as float32 FAB records (FAB_IEEE_32,
    subPlt.cpp:48).  Levels stop at the first one the box misses; the
    output geometry is 3-D (a DIM=2 source stays promoted, as in the JAX
    tool)."""
    meta = ds.meta
    geom0 = meta.geoms[0]
    dx0 = geom0.dx
    plo = tuple(geom0.prob_lo[d] + (sub_box0.lo[d] - geom0.domain.lo[d])
                * dx0[d] for d in range(3))
    phi = tuple(geom0.prob_lo[d] + (sub_box0.hi[d] + 1 - geom0.domain.lo[d])
                * dx0[d] for d in range(3))
    sub = sub_box0
    geoms, bas, ratios = [], [], []
    for lev in range(meta.n_levels):
        if lev > 0:
            sub = sub.refine(meta.ref_ratio[lev - 1])
            ratios.append(meta.ref_ratio[lev - 1])
        boxes = [b.intersect(sub) for b in meta.bas[lev]]
        boxes = [b for b in boxes if not b.is_empty()]
        if not boxes:
            break
        geoms.append(Geometry(sub, plo, phi, geom0.is_periodic))
        bas.append(BoxArray(boxes))
    out = PlotfileRecords(AmrMeta(geoms, bas, ratios[: len(geoms) - 1],
                                  meta.time), ds.names, np.float32)
    for lev in range(len(bas)):
        out.add(lev, ds.data[lev], ds.lmeta[lev].bbox, range(len(bas[lev])))
    return out


def main(args: dict) -> None:
    """CLI: subPlt infile= [outfile=<infile>_sub] box=lox loy loz hix hiy hiz
    (DIM=2: box=lox loy hix hiy) [comps=all | sComp= nComp=]
    [finestLevel=] [device=cuda|cpu].  Loads float64, writes float32."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    b = pp.get_int_list("box")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    avail = var_names(args, infile)
    names = pp.query_str_list("comps", avail)
    if pp.contains("sComp") or pp.contains("nComp"):
        s = pp.query_int("sComp", 0)          # comp range (subPlt.cpp:82-84)
        names = avail[s: s + pp.query_int("nComp", 1)]
    ds = load_dense(args, infile, device, torch.float64, names=names,
                    max_level=pp.query_int("finestLevel", None),
                    widen_ok=True)
    if ds.meta.ndim2 and len(b) == 4:
        # 2-D plotfile: box=lox loy hix hiy (z promoted to the unit cell)
        sub = Box((b[0], b[1], 0), (b[2], b[3], 0))
    else:
        sub = Box(tuple(b[:3]), tuple(b[3:6]))
    outfile = pp.query_str("outfile", infile + "_sub")
    sub_plotfile(ds, sub).write(outfile)
    print(f"wrote {outfile}")
