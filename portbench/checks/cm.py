"""``cm``: a conditional-mean table, against the reference's binning of
the same cells."""
from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.checks import gap
from portbench.outputs import read_table
from portbench.reference import flame as rf


def program(spec: dict, cfg: dict) -> np.ndarray:
    return read_table(spec["file"], skip=2)


def reference(spec: dict, st) -> np.ndarray:
    return rf.conditional_mean(st, spec["bin"], spec["avg"],
                               int(spec["nbins"]), float(spec["lo"]),
                               float(spec["hi"]))


def numbers(p, r, st) -> Dict[str, float]:
    """``cm_gap``: the widest gap of any column (sums, sums of squares,
    means, deviations, counts, shares) as a share of its largest value; a
    deviation's as a share of its mean's largest value, in whose units it
    is (a nearly constant bin's deviation keeps only the digits that its
    moments' cancellation leaves)."""
    if p.shape != r.shape:
        return {"cm_gap": float("inf")}
    na = (r.shape[1] - 3) // 4
    gaps = [gap(p[:, c], r[:, c]) for c in range(1, r.shape[1])
            if not 1 + 3 * na <= c < 1 + 4 * na]
    for c in range(1 + 3 * na, 1 + 4 * na):
        scale = np.max(np.abs(r[:, c - na]))
        gaps.append(float(np.max(np.abs(p[:, c] - r[:, c])) / scale)
                    if np.all(np.isfinite(p[:, c])) else float("inf"))
    return {"cm_gap": max(gaps)}
