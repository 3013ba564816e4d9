"""CLI of the PyTorch port: ``python -m peleanalysis_tpu_torch <tool>
key=value... [inputs]``.

The same ParmParse key surface as ``python -m peleanalysis_tpu``, for the
tools ported so far (``grad``, ``curvature``, ``isosurface``, ``stream``,
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
``buildPMF``: every verb of the JAX CLI; its ``pipeline``, ``serve`` and
``send`` are not ported).  Extra keys:
``device=cuda|cpu`` (default ``cuda``; ``cpu`` runs the kernels' plain
PyTorch versions; ``doctor`` takes none and reports what is there) and the
global ``dtype=float32|float64``.
"""
from __future__ import annotations

import importlib
import sys

import torch

from . import config
from .parmparse import _ACTIVE, parse_argv

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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("tools:", " ".join(sorted(TOOLS)))
        return 0
    tool = argv[0]
    if tool not in TOOLS:
        print(f"tool '{tool}' is not ported to peleanalysis_tpu_torch yet "
              f"(ported: {' '.join(sorted(TOOLS))}; the JAX package "
              "peleanalysis_tpu runs the rest)")
        return 2
    mod = importlib.import_module(TOOLS[tool], package=__package__)
    args = parse_argv(argv[1:])
    args.setdefault("_tool", [tool])
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
    mod.main(args)
    # the reference silently ignores unknown ParmParse keys; a typo'd key
    # costs real debugging time, so warn (stderr, non-fatal)
    touched = set().union(*(pp.touched for pp in _ACTIVE)) if _ACTIVE else set()
    unused = set(args) - touched - {"_tool", "dtype"}
    if unused:
        print(f"warning: unused input keys (typo?): {' '.join(sorted(unused))}",
              file=sys.stderr)
    _ACTIVE.clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
