"""CLI entry points of the MEF surface toolbox: ``isoMEF``, ``combineMEF``,
``mergeMEF``, ``multMEF``, ``scaleMEF``, ``sliceMEF``, ``smoothMEF``,
``trimMEFgen``, ``binMEF``, ``decimateMEF``, ``surfDATtoMEF``,
``surfMEFtoDAT`` and ``checkIso``, dispatched on the invoked tool name.

Counterpart of ``peleanalysis_tpu/tools/mef_tools.py`` (reference
Src/{isoMEF,combineMEF,mergeMEF,multMEF,scaleMEF,sliceMEF,smoothMEF,
decimateMEF,trimMEFgen,binMEF,surfDATtoMEF,surfMEFtoDAT,checkIso}.cpp):
the same keys, defaults, printouts and output names.  The geometry lives
in ``geom/mef_tools.py`` and runs on ``device=`` (default ``cuda``); the
copy and format verbs (``mergeMEF``, ``surfDATtoMEF``, ``surfMEFtoDAT``)
and decimateMEF's C++ collapse (``native.qem_decimate``) run on the host,
and still refuse ``device=cuda`` when there is no card.  In a session
(``pipeline``, ``serve``) the input surfaces resolve by name from earlier
stages and the outputs are registered; ``write=0`` skips the MEF files.
"""
from __future__ import annotations

import numpy as np

from .. import config
from ..amr.box import Box
from ..geom import mef_tools as G
from ..io.fab import write_fab
from ..io.mef import (MEF, read_mef, read_mef_tecplot, write_mef,
                      write_mef_tecplot)
from ..native import qem_decimate
from ..parmparse import ParmParse
from ..session import get_session, stage_writes


def _resolve(mef: MEF, toks):
    return [mef.names[int(t)] if t.isdigit() else t for t in toks]


def main(args: dict) -> None:
    pp = ParmParse(args)
    tool = args.get("_tool", ["?"])[0]
    dev = config.get_device(pp.query_str("device", "cuda"))
    sess = get_session(args)
    writes = stage_writes(args)

    def _rmef(path):
        # in a session, an earlier stage's surface resolves by name
        m = sess.get_surface(path) if sess is not None else None
        if m is None:
            return read_mef(path)
        return m.to_mef() if hasattr(m, "to_mef") else m

    def _wmef(path, m):
        if sess is not None:
            sess.put_surface(path, m)
        if writes:
            write_mef(path, m)

    if tool == "combineMEF":
        a = _rmef(pp.get_str("infile1"))
        b = _rmef(pp.get_str("infile2"))
        out = G.combine_mef(a, b,
                            _resolve(a, pp.query_str_list(
                                "comps1", a.names[a.ndim:])),
                            _resolve(b, pp.query_str_list(
                                "comps2", b.names[b.ndim:])), dev)
        _wmef(pp.query_str("outfile", "combined.mef"), out)

    elif tool == "mergeMEF":
        a = _rmef(pp.get_str("infile1"))
        b = _rmef(pp.get_str("infile2"))
        _wmef(pp.query_str("outfile", "merged.mef"), G.merge_mef(a, b))

    elif tool == "multMEF":
        a = _rmef(pp.get_str("infile1"))
        b = _rmef(pp.get_str("infile2"))
        comps = _resolve(a, pp.get_str_list("comps"))
        _wmef(pp.query_str("outfile", "mult.mef"),
                  G.mult_mef(a, b, comps, dev))

    elif tool == "scaleMEF":
        a = _rmef(pp.get_str("infile"))
        comps = _resolve(a, pp.get_str_list("comps"))
        factors = pp.get_float_list("factors")
        _wmef(pp.query_str("outfile", "scaled.mef"),
                  G.scale_mef(a, comps, factors, dev))

    elif tool == "sliceMEF":
        a = _rmef(pp.get_str("infile"))
        d = pp.get_int("dir")
        locs = pp.get_float_list("locs")
        outs = G.slice_mef(a, d, locs, dev)
        base = pp.query_str("outfile_base", pp.get_str("infile") + "_slice")
        for loc, m in zip(locs, outs):
            if pp.query_bool("write_mef", True):
                _wmef(f"{base}_{loc:g}.mef", m)
            if pp.query_bool("write_tec", False):
                write_mef_tecplot(f"{base}_{loc:g}.dat", m)

    elif tool == "isoMEF":
        a = _rmef(pp.get_str("infile"))
        comp = pp.get_str("comp")
        comp = a.names[int(comp)] if comp.isdigit() else comp
        val = pp.get_float("isoVal")
        out = G.iso_mef(a, comp, val, dev)
        _wmef(pp.query_str("outfile", f"iso_{comp}_{val:g}.mef"), out)

    elif tool == "smoothMEF":
        a = _rmef(pp.get_str("infile"))
        comps = _resolve(a, pp.query_str_list("comps", a.names[a.ndim:]))
        out = G.smooth_mef(a, comps, dev, pp.query_int("niter", 1))
        _wmef(pp.query_str("outfile", "smoothed.mef"), out)

    elif tool == "trimMEFgen":
        a = _rmef(pp.get_str("infile"))
        comps = _resolve(a, pp.query_str_list("comps", []))
        signs = pp.query_str_list("signs", ["+"] * len(comps))
        vals = pp.query_float_list("vals", [0.0] * len(comps))
        rxy = pp.query_float("RXY", None)
        out = G.trim_mef(a, comps, signs, vals, dev, rxy,
                         pp.query_str("sign_RXY", "+"),
                         _resolve(a, pp.query_str_list("remComps", [])))
        if pp.query_bool("do_area_stats", False) and len(out.elements):
            # trimMEFgen.cpp:499-521
            e = G.elements_on(out, dev)
            ar = G.element_areas(G.nodes_on(out, dev), e, out.ndim)
            print(f"  Triangle area min, max: {ar.min().item()} , "
                  f"{ar.max().item()}")
        _wmef(pp.query_str("outfile", "trimmed.mef"), out)

    elif tool == "binMEF":
        a = _rmef(pp.get_str("infile"))
        comps = _resolve(a, pp.get_str_list("binComps"))
        bmin = pp.get_float_list("binMin")
        bmax = pp.get_float_list("binMax")
        nb = pp.get_int_list("nBins")
        # condApply gates conditioning in the reference (binMEF.cpp:465-469);
        # here giving condComp= is the gate, condApply=0 disables explicitly
        cond = (pp.query_str("condComp", None)
                if pp.query_bool("condApply", True) else None)
        if pp.query_bool("dumpBins", False):    # binMEF.cpp:482-500
            for j, c in enumerate(comps):
                db = (bmax[j] - bmin[j]) / nb[j]
                print(f"bin: {c} bounds: ")
                for i in range(nb[j]):
                    hi = bmax[j] if i == nb[j] - 1 else bmin[j] + (i + 1) * db
                    print(f"         bin: [{bmin[j] + i * db},{hi}]")
        out = G.bin_mef(a, comps, bmin, bmax, nb, dev,
                        cond_comp=cond,
                        cond_val=pp.query_float("condVal", 0.0),
                        cond_sgn=pp.query_str("condSgn", "+"),
                        area_eps=pp.query_float("areaEps", 0.0),
                        normalize=pp.query_bool("normalize", False))
        # sparse print (data.rst "N-dimensional bins")
        for idx in np.argwhere(out > 0):
            print(" ".join(str(i) for i in idx), out[tuple(idx)])
        if pp.query_bool("dumpFab", False) and out.ndim == 2:
            base = pp.query_str("fabFileBase", "binMEF")
            with open(base + ".fab", "wb") as f:
                write_fab(f, Box((0, 0, 0),
                                 (out.shape[0] - 1, out.shape[1] - 1, 0)),
                          out[None, :, :, None])

    elif tool == "decimateMEF":
        a = _rmef(pp.get_str("infile"))
        target = pp.query_int("face_target", max(a.n_elts // 2, 4))
        # full qslim config surface (Tools/qslim/cmdline.cpp:25-36)
        v, t, attr = qem_decimate(
            a.positions(), a.elements, target,
            boundary_weight=pp.query_float("boundary_weight", 1000.0),
            attrs=a.nodes[:, a.ndim:] if a.nodes.shape[1] > a.ndim else None,
            placement_policy=pp.query_int("placement_policy", 3),
            weighting_policy=pp.query_int("weighting_policy", 1),
            meshing_penalty=pp.query_float("meshing_penalty", 1.0),
            compactness_ratio=pp.query_float("compactness_ratio", 0.0))
        nodes = np.concatenate([v, attr], axis=1) if attr is not None else v
        out = MEF(a.label, a.names, nodes, t.astype(np.int32))
        _wmef(pp.query_str("outfile", "decimated.mef"), out)
        print(f"decimated {a.n_elts} -> {out.n_elts} elements")

    elif tool == "surfDATtoMEF":
        m = read_mef_tecplot(pp.get_str("infile"))
        _wmef(pp.query_str("outfile", "surf.mef"), m)

    elif tool == "surfMEFtoDAT":
        m = _rmef(pp.get_str("infile"))
        write_mef_tecplot(pp.query_str("outfile", "surf.dat"), m)

    elif tool == "checkIso":
        m = _rmef(pp.get_str("infile"))
        for k, v in G.check_iso(m, dev).items():
            print(f"{k}: {v}")

    else:
        raise ValueError(f"unknown MEF tool {tool}")
    print(f"{tool} done")
