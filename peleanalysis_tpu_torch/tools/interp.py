"""``interp`` — trilinear point sampling of plotfile fields.

Counterpart of ``peleanalysis_tpu/tools/interp.py``, which completes the
contract of the reference's unfinished Src/interp.cpp sketch: each point
is owned by the finest level whose boxes contain it (the streamline
engine's ``push_nodes_inside`` and ``assign_seeds_to_levels``, the coarse
fallback interp.cpp:18-24 asks for) and sampled there with the
cell-centred dual-grid trilinear math of ``stream.trace._sample_fields``
on a 1-ghost linear fill of the level (``fill_dense_arrays``), one fill
and one gather per level on the device.  The fields load in the compute
dtype; the points and samples are float64.

CLI keys::

  interp infile=<plt> vars=<v1 v2 ...> points=<file> [out=interp.dat]
         [fmt=dat|csv] [device=cuda|cpu]

``points``: text, one ``x y z`` per line ('#' comments allowed).  Output
columns ``x y z v1 v2 ...`` after a header line of names, every number
``%.17g`` (the native formatter, the same bytes as Python's format).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import config
from ..amr.dense import DenseAmrState
from ..native import format_g_rows
from ..ops.dense_fill import fill_dense_arrays
from ..parmparse import ParmParse
from ..stream.trace import (_sample_fields, assign_seeds_to_levels,
                            push_nodes_inside)
from .grad import refuse_unported


def sample_at_points(ds: DenseAmrState, names: Sequence[str],
                     pts: np.ndarray) -> torch.Tensor:
    """[npts, len(names)] float64 trilinear samples on the state's device,
    each point at the finest level owning it."""
    meta = ds.meta
    pts = push_nodes_inside(np.asarray(pts, np.float64), meta.geoms[0])
    owner = assign_seeds_to_levels(ds, pts)
    comps = [ds.comp(n) for n in names]
    data = [d[comps] for d in ds.data]
    masks = [ds.in_level_mask(l) for l in range(meta.n_levels)]
    p = torch.from_numpy(pts).to(ds.device)
    out = torch.zeros((len(pts), len(names)), dtype=torch.float64,
                      device=ds.device)
    for lev in range(meta.n_levels):
        sel = np.nonzero(owner == lev)[0]
        if len(sel) == 0:
            continue
        geom = meta.geoms[lev]
        dx = np.array(geom.dx)
        gbox = ds.lmeta[lev].bbox.grow(1)
        plo_g = (np.array(geom.prob_lo)
                 + (np.array(gbox.lo) - np.array(geom.domain.lo)) * dx)
        grown = fill_dense_arrays(meta, ds.lmeta, data, masks, lev, 1, None,
                                  "linear")
        idx = torch.from_numpy(sel).to(ds.device)
        out[idx] = _sample_fields(grown, plo_g, dx, p[idx]).to(torch.float64)
    return out


def read_points(path: str) -> np.ndarray:
    """[npts, 3] float64 points of a text file ('#' comments allowed)."""
    return np.loadtxt(path, comments="#", ndmin=2)[:, :3]


def write_samples(path: str, names: Sequence[str], pts: np.ndarray,
                  vals: np.ndarray, fmt: str = "dat") -> None:
    """The header line and one ``%.17g`` row a point (comma-separated for
    ``fmt=csv``)."""
    sep = "," if fmt == "csv" else " "
    body = format_g_rows(np.column_stack([pts, vals]), 17)
    with open(path, "wb") as f:
        f.write((("# " if fmt != "csv" else "")
                 + sep.join(["x", "y", "z"] + list(names)) + "\n").encode())
        f.write(body.replace(b" ", b",") if fmt == "csv" else body)


def main(args: dict) -> None:
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    names = pp.get_str_list("vars")
    pts_file = pp.get_str("points")
    outfile = pp.query_str("out", "interp.dat")
    fmt = pp.query_str("fmt", "dat")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)

    pts = read_points(pts_file)
    ds = DenseAmrState.from_plotfile(infile, device, names=list(names),
                                     dtype=config.compute_dtype)
    vals = sample_at_points(ds, names, pts).cpu().numpy()
    write_samples(outfile, names, pts, vals, fmt)
    print(f"wrote {outfile}  ({len(pts)} points, {len(names)} vars)")
