"""``combinePlts`` — one plotfile from selected components of several
plotfiles with identical hierarchies.

Counterpart of ``peleanalysis_tpu/tools/combine_plts.py``, itself the
replacement for the reference's Src/combinePlts.cpp.  Two key surfaces:
``infile1= infile2= [comps1=] [comps2=]``, and the reference's
``infiles=<N files> vars=<names>``, where each variable comes from the
first listed file that has it.  Each file loads only its selected
components, in float64, on the device; the levels are joined there
(``torch.cat``) and written through ``DenseAmrState.to_plotfile`` with the
first file's metadata.  In a session the inputs may be earlier stages'
outputs (a narrower dtype is widened: the copy is value-identical) and the
output is registered.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .. import config
from ..amr.dense import DenseAmrState
from ..parmparse import ParmParse
from ..session import (dense_state, get_session, load_state,
                       select, stage_write_plotfile, var_names)
from .grad import refuse_unported


def combine(states: Sequence[DenseAmrState]) -> DenseAmrState:
    """Every component of each state, joined in order, on the first
    state's hierarchy; states whose BoxArrays differ are refused."""
    first = states[0]
    for st in states[1:]:
        if (st.meta.n_levels != first.meta.n_levels
                or any(a != b for a, b in zip(first.meta.bas, st.meta.bas))):
            raise ValueError("combinePlts: plotfiles have different "
                             "hierarchies")
    names: List[str] = [n for st in states for n in st.names]
    data = [torch.cat([st.data[lev] for st in states], dim=0)
            for lev in range(first.meta.n_levels)]
    return first.with_data(names, data)


def main(args: dict) -> None:
    """CLI: combinePlts infile1= infile2= [comps1=all] [comps2=all others]
    [outfile=<infile1>_comb] — or infiles=<N files> vars=<names>
    [finestLevel=] [is_per=] outfile= — [device=cuda|cpu].  Loads and
    writes float64."""
    pp = ParmParse(args)
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)

    def load(path, names, max_level=None):
        src = load_state(args, path, names=names, max_level=max_level,
                         dtype=torch.float64, device=device, widen_ok=True)
        return select(dense_state(args, src, device, torch.float64), names)

    if pp.contains("infiles"):
        files = pp.get_str_list("infiles")
        remaining = list(pp.get_str_list("vars"))
        finest = pp.query_int("finestLevel", None)
        pp.query_int_list("is_per", [1, 1, 1])   # accepted; metadata-only
        states = []
        for f in files:
            avail = var_names(args, f)
            have = [v for v in remaining if v in avail]
            if have:
                states.append(load(f, have, finest))
                remaining = [v for v in remaining if v not in have]
        if remaining:
            raise ValueError("combinePlts: comps not found: "
                             + " ".join(remaining))
        outfile = pp.get_str("outfile")
    else:
        f1 = pp.get_str("infile1")
        f2 = pp.get_str("infile2")
        comps1 = pp.query_str_list("comps1", var_names(args, f1))
        comps2 = pp.query_str_list("comps2", [
            n for n in var_names(args, f2) if n not in comps1])
        states = [load(f1, comps1), load(f2, comps2)]
        outfile = pp.query_str("outfile", f1 + "_comb")
    out = combine(states)
    sess = get_session(args)
    if sess is not None:
        sess.put_plotfile(outfile, out)
    if stage_write_plotfile(args, out, outfile):
        print(f"wrote {outfile}")
