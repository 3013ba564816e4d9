"""``template`` — the skeleton of a tool of the port: open a plotfile, work
level by level on the device, write a plotfile.

Counterpart of ``peleanalysis_tpu/tools/template.py`` (the reference's
Src/template.cpp).  Copy this file to start a new tool: read the keys with
``ParmParse``, take the device from ``device=`` (``config.get_device``
refuses a missing card instead of carrying on on the CPU), refuse the JAX
options the port does not run, load a ``DenseAmrState`` (one dense tensor
``[ncomp, *bbox]`` per level on the device), compute, and write through
``to_plotfile`` (packed on the device, one copy a level to the host).
Register the tool in ``cli.py`` ``TOOLS``.
"""
from __future__ import annotations

import torch

from .. import config
from ..amr.dense import DenseAmrState
from ..io.plotfile import PlotfileReader
from ..parmparse import ParmParse
from .grad import refuse_unported


def main(args: dict) -> None:
    """CLI: template infile= [outfile=<infile>_new] [vars=all]
    [device=cuda|cpu].  Loads and writes float64."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    names = pp.query_str_list("vars", PlotfileReader(infile).var_names)
    ds = DenseAmrState.from_plotfile(infile, device, names=names,
                                     dtype=torch.float64)
    # --- per-level computation goes here (identity by default) -------------
    out_data = [d for d in ds.data]
    # ------------------------------------------------------------------------
    out = ds.with_data(names, out_data)
    outfile = pp.query_str("outfile", infile + "_new")
    out.to_plotfile(outfile)
    print(f"wrote {outfile}")
