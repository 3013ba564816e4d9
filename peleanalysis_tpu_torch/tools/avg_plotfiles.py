"""``avgPlotfiles`` — ensemble average of N plotfiles whose AMR hierarchies
may differ.

Counterpart of ``peleanalysis_tpu/tools/avg_plotfiles.py``, itself the
replacement for the reference's Src/avgPlotfiles.cpp (docs:
averagePlotfile.rst "averagePlotfileFlexible").  The output is refined
wherever any input is: as many levels as the deepest file, each level's
footprint the union of the inputs' boxes, found from the headers alone.
The files are then read, the next ``prefetch=N`` (default 1) on a
background thread while the current one is accumulated
(``io/prefetch.iter_states``; ``prefetch=0`` reads them one after
another), and each is filled onto every output level with the dense
fill (``interp_type=1`` PCInterp, the default, or ``2`` linear,
avgPlotfiles.cpp:68-70) and added into that level's accumulator.  A file
shallower than the output fills from its finest level and is upsampled
stage by stage (the reference's fillPatchFromPlt fallback,
avgPlotfiles.cpp:82-84,180-186).

The accumulators are float64 tensors on the device, one a level, and come
to the host once, packed with the output's boxes (the union chunked by
``output_max_grid_size`` and trimmed, ``regrid_plt.covered_chunks``).  A
DIM=2 ensemble is written as a DIM=2 plotfile.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import config
from ..amr.box import Box, BoxArray
from ..amr.dense import DenseAmrState, PlotfileRecords, _union_mask_np
from ..amr.hierarchy import AmrMeta
from ..io.plotfile import PlotfileReader
from ..io.prefetch import iter_states, query_prefetch
from ..ops.dense_fill import _upsample_axis, fill_dense_arrays
from ..parmparse import ParmParse
from ..session import dense_state, select
from .grad import refuse_unported
from .regrid_plt import covered_chunks


def _window(src: Box, dst: Box):
    """Index slices of ``dst`` inside an array over ``src``."""
    return (slice(None),) + tuple(slice(dst.lo[d] - src.lo[d],
                                        dst.hi[d] - src.lo[d] + 1)
                                  for d in range(3))


def accumulate_one(ds: DenseAmrState, lev: int, ubox: Box, interp: str,
                   acc: torch.Tensor, rvecs) -> None:
    """Fill one input's level onto the union bbox ``ubox`` and add it into
    ``acc`` (every component of ``ds``).  An input that lacks the level
    fills from its finest level and is upsampled through the per-dim
    ratios ``rvecs[l]`` between output levels l and l+1."""
    meta = ds.meta
    masks = [ds.in_level_mask(l) for l in range(meta.n_levels)]
    if lev < meta.n_levels:
        bbox = ds.lmeta[lev].bbox
        # grow this input's fill so it spans the union bbox; cells beyond
        # the input's own refinement get its coarse-interpolated values
        g = max([0] + [bbox.lo[d] - ubox.lo[d] for d in range(3)]
                + [ubox.hi[d] - bbox.hi[d] for d in range(3)])
        filled = fill_dense_arrays(meta, ds.lmeta, ds.data, masks, lev, g,
                                   None, interp)
        acc += filled[_window(bbox.grow(g), ubox)]
        return
    lf = meta.n_levels - 1
    stages = [tuple(rv) for rv in rvecs[lf:lev]]
    rtot = tuple(int(np.prod([s[d] for s in stages])) for d in range(3))
    cbox = ubox.coarsen(rtot)
    bboxf = ds.lmeta[lf].bbox
    # one spare coarse cell so _upsample_axis's edge clamp never shows
    g = max([1] + [bboxf.lo[d] - cbox.lo[d] + 1 for d in range(3)]
            + [cbox.hi[d] - bboxf.hi[d] + 1 for d in range(3)])
    filled = fill_dense_arrays(meta, ds.lmeta, ds.data, masks, lf, g, None,
                               interp)
    work_box = cbox.grow(1)
    cur = filled[_window(bboxf.grow(g), work_box)]
    for rv in stages:
        for d in range(3):
            if rv[d] > 1:
                cur = _upsample_axis(cur, d, int(rv[d]), interp)
        work_box = work_box.refine(rv)
    acc += cur[_window(work_box, ubox)]


def _box_array_3d(r: PlotfileReader, lev: int) -> BoxArray:
    """A level's boxes in the in-memory 3-D model (DIM=2 promoted to
    nz=1)."""
    ba = r.box_array(lev)
    if r.meta.ndim == 2:
        ba = BoxArray([Box(b.lo + (0,), b.hi + (0,)) for b in ba])
    return ba


def average_paths(paths: Sequence[str], names: Optional[List[str]],
                  interp: str, output_max_level: Optional[int], device,
                  args: Optional[dict] = None, depth: int = 0):
    """Stream the files through the accumulators, ``depth`` files read
    ahead (``io/prefetch.iter_states``; ``args`` the tool's, for its
    session).  Returns (accs, uboxes, unions, meta0, names, rvecs): the
    per-level averages on ``device``, their union bboxes and footprints,
    and the first file's metadata."""
    readers = [PlotfileReader(p) for p in paths]
    # MAX levels across the ensemble (avgPlotfiles.cpp:83), shallower files
    # interpolated onto the missing levels
    n_lev = max(r.meta.n_levels for r in readers)
    if output_max_level is not None:
        n_lev = min(n_lev, output_max_level + 1)
    deep = max(readers, key=lambda r: r.meta.n_levels).meta
    m0 = readers[0].meta
    for r in readers:
        nl = min(n_lev, r.meta.n_levels)
        if r.meta.geometry(0).domain != m0.geometry(0).domain:
            raise ValueError("avgPlotfiles: domains differ")
        if (list(r.meta.ref_ratio[: nl - 1])
                != list(deep.ref_ratio[: nl - 1])):
            raise ValueError("avgPlotfiles: ref ratios differ")
    # per-dim refinement between output levels (z stays 1 for DIM=2)
    ndim2 = deep.ndim == 2
    rvecs = [(int(rr), int(rr), 1 if ndim2 else int(rr))
             for rr in deep.ref_ratio[: n_lev - 1]]
    if names is None:
        # cross-check shared variables (avgPlotfiles.cpp:77-115)
        names = [n for n in readers[0].var_names
                 if all(n in r.var_names for r in readers)]

    # ---- pass 0: union bboxes + footprints, from the headers --------------
    uboxes, unions = [], []
    for lev in range(n_lev):
        # only files that HAVE this level refine it
        bas = [_box_array_3d(r, lev) for r in readers
               if lev < r.meta.n_levels]
        bbs = [ba.minimal_box() for ba in bas]
        ubox = Box(tuple(min(b.lo[d] for b in bbs) for d in range(3)),
                   tuple(max(b.hi[d] for b in bbs) for d in range(3)))
        union = np.zeros(ubox.shape, dtype=bool)
        for ba in bas:
            union |= _union_mask_np(ba, ubox)
        uboxes.append(ubox)
        unions.append(union)
    del readers

    # ---- pass 1: each file through the accumulators ------------------------
    accs = [torch.zeros((len(names),) + ub.shape, dtype=torch.float64,
                        device=device) for ub in uboxes]
    meta0 = None
    args = {} if args is None else args
    for _, src in iter_states(args, paths, names=list(names),
                              dtype=torch.float64, device=device,
                              depth=depth):
        meta = src.meta
        ds = select(dense_state(args, src, device, torch.float64), names)
        del src
        if meta0 is None:
            meta0 = meta
        for lev in range(n_lev):
            accumulate_one(ds, lev, uboxes[lev], interp, accs[lev], rvecs)
        del ds
    for a in accs:
        a /= len(paths)
    return accs, uboxes, unions, meta0, list(names), rvecs


def averaged_records(accs, uboxes, unions, meta0: AmrMeta, names,
                     rvecs, max_grid_size: int = 32) -> PlotfileRecords:
    """The averages as float64 FAB records: each level's union chunked and
    trimmed, the geometries refined from the first file's level 0."""
    geoms = [meta0.geoms[0]]
    for rv in rvecs:
        geoms.append(geoms[-1].refine(rv))
    bas = [BoxArray(covered_chunks(ub, un, max_grid_size))
           for ub, un in zip(uboxes, unions)]
    meta = AmrMeta(geoms, bas, [int(rv[0]) for rv in rvecs], meta0.time,
                   ndim2=meta0.ndim2)
    out = PlotfileRecords(meta, names, np.float64)
    for lev, (acc, ub) in enumerate(zip(accs, uboxes)):
        out.add(lev, acc, ub, range(len(bas[lev])))
    return out


def main(args: dict) -> None:
    """CLI: avgPlotfiles infile=<plt>... (or infiles=) [vars=all |
    variables=] [interp_type=1|2] [output_max_level=]
    [output_max_grid_size=32] [outfile=<first>_avg] [prefetch=1 (files
    read ahead on a background thread; 0: one after another)]
    [device=cuda|cpu].  Loads and
    averages float64."""
    pp = ParmParse(args)
    infiles = pp.get_str_list("infiles" if pp.contains("infiles")
                              else "infile")
    # reference default is interp_type=1 / PCInterp (avgPlotfiles.cpp:69)
    itype = pp.query_int("interp_type", 1)
    interp = "pc" if itype == 1 else "linear"
    names = (pp.query_str_list("variables", None)
             or pp.query_str_list("vars", None))
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    accs, uboxes, unions, meta0, names, rvecs = average_paths(
        infiles, names, interp, pp.query_int("output_max_level", None),
        device, args, query_prefetch(pp))
    outfile = pp.query_str("outfile", infiles[0] + "_avg")
    averaged_records(accs, uboxes, unions, meta0, names, rvecs,
                     pp.query_int("output_max_grid_size", 32)).write(outfile)
    print(f"wrote {outfile}")
