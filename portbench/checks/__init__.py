"""How ``correct`` is decided: each output the timed path wrote, read back
and compared with the plain reference, as numbers held to the limits of
the cell's traffic file.

A check spec (an entry of a traffic file's ``checks``, or of a request
kind's) names its ``type`` and the files and arguments of one output, with
the same ``{placeholders}`` as the argv it belongs to.  Each type is a
module ``checks/<type>.py`` of three functions: ``program(spec, cfg)``,
the program's output as read from disk; ``reference(spec, st)``, the same
from a kind's reference ``State``; and ``numbers(p, r, st)``, the numbers
that compare the two.  The control is the reference in the nearest
precision below the configuration's, read through the same numbers.
"""
from __future__ import annotations

import numpy as np


def gap(p: np.ndarray, r: np.ndarray) -> float:
    """Widest gap, as a share of the reference's largest magnitude."""
    p, r = np.asarray(p, float), np.asarray(r, float)
    if p.shape != r.shape:
        return float("inf")
    scale = np.max(np.abs(r)) if r.size else 0.0
    if not np.all(np.isfinite(p)):
        return float("inf")
    return float(np.max(np.abs(p - r)) / scale) if scale > 0 else float(
        np.max(np.abs(p - r), initial=0.0))
