"""``streamScatter`` — scatter data from streamline peak points
(reference Src/streamScatter.cpp): per line, find the point of peak
condComp/condVar scanning from the line midpoint (streamScatter.cpp:120-143);
if the peak lies in [condValMoreThan, condValLessThan), print the selected
vars at that point (streamScatter.cpp:145-155).

Counterpart of ``peleanalysis_tpu/tools/stream_scatter.py``: the peak
search and the row filter run on ``device=`` (default ``cuda``) in
float64, the text is formatted on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..native import savetxt_fast
from ..parmparse import ParmParse
from ..session import read_stream


def scatter_rows(lines: torch.Tensor, names, var_names, cond_name: str,
                 lo: float, hi: float):
    """The rows [nkeep, len(var_names)] of the lines [nl, npts, nv] whose
    peak of ``cond_name`` (its first maximum) lies in [lo, hi), taken at
    that peak, and the keep mask [nl]."""
    cc = names.index(cond_name)
    vi = [names.index(v) for v in var_names]
    jpk = torch.argmax(lines[:, :, cc], dim=1)
    r = torch.arange(lines.shape[0], device=lines.device)
    pk = lines[r, jpk, cc]
    keep = (pk >= lo) & (pk < hi)
    return lines[r[keep], jpk[keep]][:, vi], keep


def main(args: dict) -> None:
    """CLI: streamScatter infile=<StreamData> vars=... [condComp=i|condVar=n]
    condValMoreThan= condValLessThan= [outfileBase=] [device=cuda|cpu]"""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    dev = config.get_device(pp.query_str("device", "cuda"))
    sd = read_stream(args, infile)
    var_names = [sd.names[int(v)] if v.isdigit() else v
                 for v in pp.get_str_list("vars")]
    if pp.contains("condVar") and pp.get_str("condVar"):
        cond = pp.get_str("condVar")
    else:
        cond = sd.names[pp.query_int("condComp", 0)]
    lo = pp.query_float("condValMoreThan", -np.inf)
    hi = pp.query_float("condValLessThan", np.inf)
    lines = torch.as_tensor(sd.lines, dtype=torch.float64, device=dev)
    rows, keep = scatter_rows(lines, sd.names, var_names, cond, lo, hi)
    base = pp.query_str("outfileBase", infile + "_scatter")
    out = base + ".dat"
    with open(out, "w") as f:
        f.write("# " + " ".join(var_names) + "\n")
        savetxt_fast(f, rows.cpu().numpy(), fmt="%.9g")
    print(f"wrote {out} ({int(keep.sum())} of {len(keep)} lines)")
