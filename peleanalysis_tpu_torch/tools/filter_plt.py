"""``filterPlt`` — apply a box/Gaussian filter to plotfile components.

Counterpart of ``peleanalysis_tpu/tools/filter_plt.py``, itself the
replacement for the reference's Src/filterPlt.cpp.  Filter-to-grid ratio
handling per filterPlt.cpp:22-31,70-85:
  * same_fgr_all_levels=1: constant fgr on every level (filter width shrinks
    with dx)
  * same_fgr_all_levels=0 (the default): constant ABSOLUTE width — fgr on
    the coarsest level, scaled by the accumulated ref ratio on finer levels.
Every level is grown by its filter's half width in one multilevel fill,
then filtered (``ops/filter.py``), in the compute dtype.  ``shape_bucket=``
is refused.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .. import config
from ..amr.dense import DenseAmrState
from ..ops.dense_fill import fill_dense_multilevel
from ..ops.filter import filter_weights, separable_filter
from ..parmparse import ParmParse
from ..session import (dense_state, load_state, stage_write_plotfile,
                       var_names)
from .grad import refuse_unported


def filter_state(dstate: DenseAmrState, kind: str = "box", fgr: int = 2,
                 same_fgr_all_levels: bool = True,
                 names: Optional[Sequence[str]] = None) -> DenseAmrState:
    meta = dstate.meta
    names = list(names) if names is not None else list(dstate.names)
    comps = [dstate.comp(n) for n in names]
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]
    data = [d[comps] for d in dstate.data]

    weights = []
    fgr_lev = fgr
    for lev in range(meta.n_levels):
        if lev > 0 and not same_fgr_all_levels:
            fgr_lev = fgr_lev * meta.ref_ratio[lev - 1]
        weights.append(filter_weights(kind, fgr_lev))
    halves = [(len(w) - 1) // 2 for w in weights]
    grown = fill_dense_multilevel(meta, dstate.lmeta, data, masks, halves)
    out = [separable_filter(g, w) for g, w in zip(grown, weights)]
    return dstate.with_data(names, out)


def main(args: dict) -> None:
    """CLI: filterPlt infile= [outfile=<infile>_filt]
    [filter_type=box|gaussian|1|2] [base_fgr= | fgr=2]
    [same_fgr_all_levels=0] [variables= | vars=all] [max_filter_level=]
    [device=cuda|cpu].  Computes in the compute dtype (float32 unless
    dtype=float64)."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    # only the filtered components are read (all of them by default)
    want = pp.query_str_list("variables", None) or pp.query_str_list(
        "vars", None)
    src = load_state(args, infile, names=want,
                     max_level=pp.query_int("max_filter_level", None),
                     dtype=config.compute_dtype, device=device)
    names = want or var_names(args, infile)
    ds = dense_state(args, src, device, config.compute_dtype, want)
    # filter_type: PelePhysics integer codes (filterPlt.cpp:80; Filter.H
    # box=1, gaussian=2) or the spelled-out name
    kind = pp.query_str("filter_type", "box")
    kind = {"1": "box", "2": "gaussian"}.get(kind, kind)
    out = filter_state(
        ds, kind=kind,
        fgr=pp.query_int("base_fgr", pp.query_int("fgr", 2)),
        # reference default: fgr is per-level relative to each grid
        # (same_fgr_all_levels=false, filterPlt.cpp:75)
        same_fgr_all_levels=pp.query_bool("same_fgr_all_levels", False),
        names=names)
    del ds
    outfile = pp.query_str("outfile", infile + "_filt")
    if stage_write_plotfile(args, out, outfile):
        print(f"wrote {outfile}")
