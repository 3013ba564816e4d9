"""``streamSub`` — extract streamline subsets by element ids and comps
(reference Src/streamSub.cpp; Docs/source/streamSub.rst).  Connectivity
is dropped in the output (streamSub.cpp:86-126).

Counterpart of ``peleanalysis_tpu/tools/stream_sub.py``: a copy of lines
and comps on the host (no arithmetic); ``device=`` is accepted, and
``device=cuda`` is refused when there is no card, as in every tool.
"""
from __future__ import annotations

import numpy as np

from .. import config
from ..io.stream_data import StreamData, write_stream_data
from ..parmparse import ParmParse
from ..session import read_stream


def main(args: dict) -> None:
    """CLI: streamSub infile=<StreamData> [outfile=<infile>_new]
    [eltIDs=... | sElt= nElt=] [comps=...] [device=cuda|cpu]"""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    outfile = pp.query_str("outfile", infile + "_new")
    config.get_device(pp.query_str("device", "cuda"))
    sd = read_stream(args, infile)

    if pp.contains("eltIDs"):
        elt_ids = np.array(pp.get_int_list("eltIDs"))
    else:
        s = pp.query_int("sElt", 0)
        n = pp.query_int("nElt", len(sd.elements))
        elt_ids = np.arange(s, min(s + n, len(sd.elements)))
    if pp.contains("comps"):
        names = [sd.names[int(c)] if c.isdigit() else c
                 for c in pp.get_str_list("comps")]
        # coordinates always lead, in X,Y,Z order (every StreamData
        # consumer treats comps 0-2 as X,Y,Z)
        names = [c for c in ("X", "Y", "Z") if c not in names] + names
    else:
        names = list(sd.names)
    ci = [sd.names.index(n) for n in names]

    used = np.unique(sd.elements[elt_ids].ravel())
    lines = sd.lines[used][:, :, ci]
    # all kept lines in one level-0 box: connectivity (and with it the
    # original level ownership) is dropped per reference semantics
    # (streamSub.cpp:86-126)
    inside = [[np.arange(1, len(used) + 1, dtype=np.int64)]]
    out = StreamData(names, np.zeros((0, 3), np.int32), inside, lines)
    write_stream_data(outfile, out)
    print(f"wrote {outfile} ({len(used)} lines from {len(elt_ids)} elements)")
