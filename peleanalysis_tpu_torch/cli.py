"""CLI of the PyTorch port: ``python -m peleanalysis_tpu_torch <tool>
key=value... [inputs]``.

The same ParmParse key surface as ``python -m peleanalysis_tpu``, for all
its tools (``grad, ``curvature``, ``isosurface``, ``stream``,
``sampleStreamlines``, ``partStream``, ``conditionalMean``, ``jpdf``,
``integral``, ``rmsVel``, ``filterPlt``, ``flattenAMRFile``,
``turbulenceSpectra``, ``turbulenceTseries``, ``turbulenceSlice``,
``augmentPlotfile``, ``varfieldAverage``, ``avgPlotfiles``,
``combinePlts``, ``subPlt``, ``regridPlt``, ``avgToPlane``, ``slicePlot``,
``amrToFE``, ``interp``, ``plt2npz``, ``npz2plt``, ``fcompare``,
``fextrema``, ``template``, ``doctor``, ``buildDistance``, the MEF tools
``isoMEF``, ``combineMEF``, ``mergeMEF``, ``multMEF``, ``scaleMEF``,
``sliceMEF``, ``smoothMEF``, ``trimMEFgen``, ``binMEF``, ``decimateMEF``,
``surfDATtoMEF``, ``surfMEFtoDAT``, ``checkIso``, the streamline
post-processing tools ``stream2plt``, ``streamScatter``, ``streamSub``,
``streamTubeStats``, and the chemistry tools ``plotXtoY``, ``plotYtoX``,
``plotTransportCoeff``, ``plotTYtoLe``, ``plotQPD``, ``sCO2``,
``buildPMF``), and the JAX CLI's three other verbs:

    pipeline <tool> k=v ... -- <tool> k=v ...   stages share one Session
                                                (session.py); write=0 on a
                                                stage keeps its output in
                                                memory only
    serve [socket=pele_serve.sock]              a resident process with one
                                                Session (server.py)
    send [socket=S] [sync=1] <tool> k=v ...     one command to a server

Extra keys: ``device=cuda|cpu`` (default ``cuda``; ``cpu`` runs the
kernels' plain PyTorch versions; ``doctor`` takes none and reports what is
there) and the global ``dtype=float32|float64``.  ``ndevices=N`` spreads
grad, curvature, isosurface and partStream over N shards in this one
process (``parallel/``): round robin over the cards, all N on the CPU with
``device=cpu``; the other tools ignore it, as the JAX tools do.
``PELE_PROFILE=<dir>``
in the environment wraps each tool in ``torch.profiler`` and writes a
Chrome trace into ``<dir>``.
"""
from __future__ import annotations

import importlib
import os
import sys
import time

import torch

from . import config
from .parmparse import _ACTIVE, parse_argv
from .telemetry import request, span

# tool name -> module (each exposes main(args: dict))
TOOLS = {
    "grad": ".tools.grad",
    "curvature": ".tools.curvature",
    "stream": ".tools.stream",
    "sampleStreamlines": ".tools.sample_streamlines",
    "isosurface": ".tools.isosurface",
    "conditionalMean": ".tools.conditional_mean",
    "jpdf": ".tools.jpdf",
    "partStream": ".tools.part_stream",
    "integral": ".tools.integral",
    "rmsVel": ".tools.rms_vel",
    "filterPlt": ".tools.filter_plt",
    "flattenAMRFile": ".tools.flatten_amr",
    "turbulenceSpectra": ".tools.turbulence_spectra",
    "turbulenceTseries": ".tools.turbulence_post",
    "turbulenceSlice": ".tools.turbulence_post",
    "augmentPlotfile": ".tools.turbulence_post",
    "varfieldAverage": ".tools.turbulence_post",
    "avgPlotfiles": ".tools.avg_plotfiles",
    "combinePlts": ".tools.combine_plts",
    "subPlt": ".tools.sub_plt",
    "regridPlt": ".tools.regrid_plt",
    "avgToPlane": ".tools.avg_to_plane",
    "slicePlot": ".tools.slice_plot",
    "amrToFE": ".tools.amr_to_fe",
    "interp": ".tools.interp",
    "plt2npz": ".tools.plt2npz",
    "npz2plt": ".tools.plt2npz",
    "fcompare": ".tools.compare_plts",
    "fextrema": ".tools.compare_plts",
    "template": ".tools.template",
    "doctor": ".tools.doctor",
    "buildDistance": ".tools.build_distance",
    **{t: ".tools.mef_tools" for t in (
        "isoMEF", "combineMEF", "mergeMEF", "multMEF", "scaleMEF",
        "sliceMEF", "smoothMEF", "trimMEFgen", "binMEF", "decimateMEF",
        "surfDATtoMEF", "surfMEFtoDAT", "checkIso")},
    "stream2plt": ".tools.stream2plt",
    "streamScatter": ".tools.stream_scatter",
    "streamSub": ".tools.stream_sub",
    "streamTubeStats": ".tools.stream_tube_stats",
    **{t: ".tools.chem_tools" for t in (
        "plotXtoY", "plotYtoX", "plotTransportCoeff", "plotTYtoLe",
        "plotQPD")},
    "sCO2": ".tools.sco2",
    "buildPMF": ".tools.build_pmf",
}


def main(argv=None, session=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("tools:", " ".join(sorted(TOOLS)), "pipeline serve send")
        return 0
    tool = argv[0]
    if tool == "pipeline":
        return _pipeline(argv[1:], session)
    if tool == "serve":
        from .server import serve
        return serve(parse_argv(argv[1:])) or 0
    if tool == "send":
        # send [socket=S] [sync=0|1] <tool> k=v...: the leading client keys
        # are the client's, the rest is the command
        from .server import send
        rest = argv[1:]
        keys = []
        while rest and rest[0].startswith(("socket=", "sync=")):
            keys.append(rest.pop(0))
        return send(parse_argv(keys), rest)
    if tool not in TOOLS:
        print(f"unknown tool '{tool}'. tools: {' '.join(sorted(TOOLS))}"
              " pipeline serve send")
        return 2
    mod = importlib.import_module(TOOLS[tool], package=__package__)
    args = parse_argv(argv[1:])
    args.setdefault("_tool", [tool])
    if session is not None:
        args["_session"] = session
    # float64 gives the reference's double-precision compute end to end; a
    # run without dtype= is float32 even after a float64 run in-process
    dt = args.get("dtype")
    name = (dt[0] if isinstance(dt, list) else dt) if dt else "float32"
    if name in ("float64", "f64", "double"):
        config.set_compute_dtype(torch.float64)
    elif name in ("float32", "f32", "single"):
        config.set_compute_dtype(torch.float32)
    else:
        print(f"unknown dtype '{name}' (float32|float64)")
        return 2
    _ACTIVE.clear()
    prof_dir = os.environ.get("PELE_PROFILE", "")
    if prof_dir:
        _profiled(mod.main, args, prof_dir, tool)
    else:
        with span("tool." + tool):
            mod.main(args)
    # the reference silently ignores unknown ParmParse keys; a typo'd key
    # costs real debugging time, so warn (stderr, non-fatal)
    touched = set().union(*(pp.touched for pp in _ACTIVE)) if _ACTIVE else set()
    unused = set(args) - touched - {"_tool", "dtype", "_session"}
    if session is not None:
        unused -= {"write"}   # a pipeline key; outside one it warns
    if unused:
        print(f"warning: unused input keys (typo?): {' '.join(sorted(unused))}",
              file=sys.stderr)
    _ACTIVE.clear()
    return 0


def _pipeline(tokens, session=None) -> int:
    """Stages separated by ``--`` share one Session (session.py): plotfile
    loads, dense states and registered outputs stay in memory, and
    plotfiles are written back on a thread while later stages run."""
    from .session import Session
    sess = session if session is not None else Session(async_writes=True)
    stages, cur = [], []
    for tok in tokens:
        if tok == "--":
            stages.append(cur)
            cur = []
        else:
            cur.append(tok)
    if cur:
        stages.append(cur)
    if not stages or any(not s for s in stages):
        print("pipeline: empty stage (usage: pipeline <tool> k=v ... "
              "-- <tool> k=v ...)")
        return 2
    rc = 0
    with request(), span("pipeline"):
        try:
            for stage in stages:
                # a stage may read a path an earlier stage is still writing
                sess.flush_writes(match=stage)
                rc = main(stage, session=sess)
                if rc != 0:
                    break
        finally:
            # files on disk when the pipeline returns; a failing STAGE's rc
            # (or exception) outranks a failing write-back
            try:
                sess.flush_writes()
            except Exception as e:
                print(f"pipeline: pending write failed: {e}",
                      file=sys.stderr)
                rc = rc or 1
    return rc


def _profiled(fn, args, prof_dir: str, tool: str) -> None:
    """``fn(args)`` under torch.profiler (the card's activity too when
    there is one); the Chrome trace goes to ``<prof_dir>/<tool>_<ns>.json``
    (the counterpart of the JAX CLI's jax.profiler trace)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(prof_dir, exist_ok=True)
    with profile(activities=acts) as prof, span("tool." + tool):
        fn(args)
    path = os.path.join(prof_dir, f"{tool}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"profile trace written to {path}")


if __name__ == "__main__":
    raise SystemExit(main())
