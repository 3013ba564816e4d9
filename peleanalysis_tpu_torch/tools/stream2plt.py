"""``stream2plt`` — gather selected streamlines into a single FAB
(reference Src/stream2plt.cpp).

Counterpart of ``peleanalysis_tpu/tools/stream2plt.py``: selects comps,
downsamples to nLines, applies per-line filters — cylindrical radius RXY
with sign, per-comp Max/Min/at-value predicates with sign strings
(stream2plt.cpp:371-481) — appends the auxiliary
``distance_from_<comp>_eq_<val>`` component when distComp/distVal are given
(arclength from the line start, shifted to zero at the first crossing of
the selected comp through distVal; 2x-total-length marker on lines with no
crossing — stream2plt.cpp:654-713), and writes the surviving lines as one
FAB on Box (0:nKeep-1, slo:shi, 0) (stream2plt.cpp:498-560).  The lines
go to ``device=`` (default ``cuda``) in float64; the predicates and the
arclength run there, the FAB is written from the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..amr.box import Box
from ..io.fab import write_fab
from ..ops.vec3 import sqrt
from ..parmparse import ParmParse
from ..session import read_stream
from ..stream.surface import _crossings_from_mid, _interp_at, arc_length


def _cmp(vals: torch.Tensor, val: float, sgn: str) -> torch.Tensor:
    if sgn in ("+", "gt", ">"):
        return vals > val
    if sgn in ("-", "lt", "<"):
        return vals < val
    raise ValueError(f"bad sign string {sgn!r}")


def select_lines(lines: torch.Tensor, names, pp: ParmParse,
                 sel_ci=None) -> torch.Tensor:
    """Boolean keep-mask over lines [nl, npts, nv] applying the stream2plt
    filters, on the lines' device.  Integer comp tokens index the SELECTED
    comp list when ``sel_ci`` is given (the reference's maxComps etc. index
    into comps[], stream2plt.cpp:464-471); name tokens index the raw
    variable list."""
    nl, npts, _ = lines.shape
    keep = torch.ones(nl, dtype=torch.bool, device=lines.device)
    if pp.query_bool("no_filter", False):
        return keep
    mid = (npts - 1) // 2

    def cidx(tok):
        if tok.lstrip("-").isdigit():
            i = int(tok)
            return sel_ci[i] if sel_ci is not None else i
        return names.index(tok)

    rxy = pp.query_float("RXY", -1.0)
    if rxy > 0:
        sgn = pp.query_str("RXYsgn", "+")
        x, y = lines[:, mid, 0], lines[:, mid, 1]
        keep &= _cmp(sqrt(x * x + y * y), rxy, sgn)
    if pp.contains("maxComps"):
        comps = [cidx(t) for t in pp.get_str_list("maxComps")]
        vals = pp.get_float_list("maxVals")
        sgns = pp.get_str_list("maxSgns")
        for c, v, s in zip(comps, vals, sgns):
            keep &= _cmp(lines[:, :, c].max(dim=1).values, v, s)
    if pp.contains("minComps"):
        comps = [cidx(t) for t in pp.get_str_list("minComps")]
        vals = pp.get_float_list("minVals")
        sgns = pp.get_str_list("minSgns")
        for c, v, s in zip(comps, vals, sgns):
            keep &= _cmp(lines[:, :, c].min(dim=1).values, v, s)
    if pp.contains("atComps"):
        comp_at = [cidx(t) for t in pp.get_str_list("compAt")]
        at_comps = [cidx(t) for t in pp.get_str_list("atComps")]
        val_at = pp.get_float_list("valAt")
        at_val = pp.get_float_list("atVal")
        at_sgns = pp.get_str_list("atSgns")
        for ca, cc, va, vv, s in zip(comp_at, at_comps, val_at, at_val,
                                     at_sgns):
            jlo, frac, found = _crossings_from_mid(lines[:, :, ca], va)
            sampled = _interp_at(lines, jlo, frac)[:, cc]
            keep &= found & _cmp(sampled, vv, s)
    return keep


def distance_from_crossing(out: torch.Tensor, dcomp: int,
                           dval: float) -> torch.Tensor:
    """The auxiliary distance component [nl, npts] (stream2plt.cpp:654-713):
    arclength from the line start, shifted to zero at the first strict
    crossing of comp ``dcomp`` through ``dval``; lines with no crossing get
    a constant 2x-total-length "off the line" marker."""
    dist = arc_length(out)
    v = out[:, :, dcomp]
    vlo, vhi = v[:, :-1], v[:, 1:]
    cross = ((vlo > dval) & (vhi < dval)) | ((vlo < dval) & (vhi > dval))
    found = cross.any(dim=1)
    j = torch.argmax(cross.to(torch.int32), dim=1)
    r = torch.arange(out.shape[0], device=out.device)
    denom = torch.where(vhi[r, j] != vlo[r, j], vhi[r, j] - vlo[r, j], 1.0)
    alpha = (dval - vlo[r, j]) / denom
    off = dist[r, j] + alpha * (dist[r, j + 1] - dist[r, j])
    d = dist - torch.where(found, off, 0.0)[:, None]
    return torch.where(found[:, None], d, 2.0 * dist[:, -1:])


def main(args: dict) -> None:
    """CLI: stream2plt infile=<StreamData> outfile= [comps=|sComp= nComp=]
    [nLines=0(all)] [finestLevel=] [no_filter=0] [RXY= RXYsgn=]
    [maxComps= maxVals= maxSgns=] [minComps= minVals= minSgns=]
    [atComps= compAt= valAt= atVal= atSgns=] [distComp= distVal=]
    [device=cuda|cpu]"""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    outfile = pp.get_str("outfile")
    dev = config.get_device(pp.query_str("device", "cuda"))
    sd = read_stream(args, infile)
    if pp.contains("comps"):
        names = [sd.names[int(c)] if c.isdigit() else c
                 for c in pp.get_str_list("comps")]
    else:
        s = pp.query_int("sComp", 0)
        n = pp.query_int("nComp", len(sd.names))
        names = sd.names[s : s + n]
    ci = [sd.names.index(n) for n in names]
    lines = torch.as_tensor(sd.lines, dtype=torch.float64, device=dev)
    if pp.contains("finestLevel"):
        # keep only lines owned by levels <= finestLevel
        # (stream2plt.cpp:343: levels beyond finest are not read)
        fin = pp.get_int("finestLevel")
        ids = [i - 1 for lev in range(min(fin + 1, sd.n_levels))
               for per_box in sd.inside_nodes[lev] for i in per_box]
        sel = np.zeros(lines.shape[0], bool)
        sel[np.asarray(sorted(ids), np.int64)] = True
        lines = lines[torch.as_tensor(np.nonzero(sel)[0], device=dev)]
        print(f"stream2plt: finestLevel={fin} keeps {sel.sum()} of "
              f"{len(sel)} lines")
    n_lines = pp.query_int("nLines", 0)
    if n_lines and n_lines < lines.shape[0]:
        stride = lines.shape[0] // n_lines
        lines = lines[::stride][:n_lines]  # downsampleStreamData analog
    keep = select_lines(lines, sd.names, pp, sel_ci=ci)
    out = lines[keep][:, :, ci]
    if out.shape[0] == 0:
        raise ValueError("stream2plt: no lines survive the filters "
                         "(check finestLevel=/predicates)")
    out_names = list(names)
    dcomp = pp.query_int("distComp", -1)
    if dcomp >= 0:
        dval = pp.get_float("distVal")
        if dcomp >= len(out_names) or len(out_names) <= 3:
            raise ValueError(
                f"distComp={dcomp} must index the selected comps (have "
                f"{len(out_names)}, first three must be X,Y,Z)")
        d = distance_from_crossing(out, dcomp, dval)
        out = torch.cat([out, d[:, :, None]], dim=2)
        out_names.append(f"distance_from_{out_names[dcomp]}_eq_{dval:g}")
        print(f"stream2plt: appended {out_names[-1]}")
    out = out.cpu().numpy()
    n_half = (out.shape[1] - 1) // 2
    box = Box((0, -n_half, 0), (max(out.shape[0] - 1, 0), n_half, 0))
    with open(outfile, "wb") as f:
        write_fab(f, box, np.transpose(out, (2, 0, 1))[..., None])
    print(f"wrote {outfile} ({out.shape[0]} lines kept of {lines.shape[0]})")
