"""Faults planted in the program under a run, for the tests that see
``correct`` come out false.  ``apply(name)`` replaces a function of the
program in every module that holds it.  The cells' faults:

* ``unchanged``: a step that returns its state unchanged (the binning step
  hands back empty histograms);
* ``half``: half of the cells left out, the mean taken over the rest (the
  conditional mean);
* ``altered``: an answer altered where it is produced (one node value of
  the surface).

The exchange between chips has no place on one chip: no cell runs on
more than one."""
from __future__ import annotations

import importlib
import sys

PACKAGE = "peleanalysis_tpu_torch"
MODULES = ["tools.conditional_mean", "tools.jpdf", "tools.isosurface",
           "tools.curvature", "ops.stats", "io.mef", "geom.marching_cubes"]


def load() -> None:
    """Import every module a fault may touch."""
    for m in MODULES:
        importlib.import_module(f"{PACKAGE}.{m}")


def _replace(target: str, make) -> None:
    load()
    mod, attr = target.rsplit(":", 1)
    orig = getattr(importlib.import_module(f"{PACKAGE}.{mod}"), attr)
    new = make(orig)
    for m in list(sys.modules.values()):
        if getattr(m, "__name__", "").startswith(PACKAGE):
            for k, v in list(vars(m).items()):
                if v is orig:
                    setattr(m, k, new)


def flame_unchanged():
    def make(fn):
        def binned_stats(bin_vals, avg_vals, weight, mask, *a, **k):
            return fn(bin_vals, avg_vals, weight, mask & False, *a, **k)
        return binned_stats
    _replace("ops.stats:binned_stats", make)


def flame_half():
    def make(fn):
        def binned_stats(bin_vals, avg_vals, weight, mask, *a, **k):
            m = mask.clone()
            m.view(-1)[::2] = False
            return fn(bin_vals, avg_vals, weight, m, *a, **k)
        return binned_stats
    _replace("ops.stats:binned_stats", make)


def flame_altered():
    def make(fn):
        def write_mef(path, mef):
            mef.nodes[len(mef.nodes) // 2, -1] *= 1.001
            return fn(path, mef)
        return write_mef
    _replace("io.mef:write_mef", make)


FAULTS = {"flame": {"unchanged": flame_unchanged, "half": flame_half,
                    "altered": flame_altered}}


def apply(spec: str) -> None:
    """``spec`` is ``<kind>:<fault>``, e.g. ``flame:half``."""
    kind, name = spec.split(":")
    FAULTS[kind][name]()
