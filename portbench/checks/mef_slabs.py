"""``mef_slabs``: an isosurface's MEF against the reference computed in z
slabs of the finest level (``reference/flame_slabs.py``), for a finest
level too large for the whole-level reference beside the run; read and
compared as ``mef`` does."""
from __future__ import annotations

from portbench.checks.mef import numbers, program  # noqa: F401
from portbench.reference import flame_slabs


def reference(spec: dict, st) -> dict:
    out = flame_slabs.isosurface(st, spec["iso"], float(spec["iso_val"]),
                                 spec["extras"], slab=spec.get("slab"))
    return {"nodes": out["nodes"], "area": out["area"]}
