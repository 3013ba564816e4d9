"""The card's peaks and the work of the port's kernels, counted from the
shapes of each call: the inputs read once and the outputs written once,
whatever a kernel reads again, and the arithmetic the operation needs,
not how a kernel implements it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM, 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the
tensor cores.  ``bound`` is a copy of the smoke script's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}


def bound(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """(least seconds the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _n(desc: dict) -> int:
    return int(np.prod(desc["shape"]))


def grad_mag(call: dict) -> Tuple[float, float, str]:
    """``grad_mag(grown, dx, with_mag)``: the grown field read once, three
    gradient components (and the magnitude) written once; a centred
    difference is a subtraction and a division, the magnitude three
    products, two sums and a root."""
    g = call["args"][0]
    with_mag = call["args"][2] if len(call["args"]) > 2 else \
        call["kwargs"].get("with_mag", True)
    inner = int(np.prod([s - 2 for s in g["shape"][-3:]]))
    nout = 4 if with_mag else 3
    nbytes = g["itemsize"] * (_n(g) + nout * inner)
    flops = inner * (6 + (6 if with_mag else 0))
    return nbytes, flops, g["dtype"]


def binned_moments(call: dict) -> Tuple[float, float, str]:
    """``binned_moments(bin_vals, avg_vals, weight, mask, edges, nbins,
    clamp, with_minmax, shift)``: the binned field, the averaged fields,
    the mask and a weight field read once, the bins written once; a bin
    index is a subtraction, a product and a floor, and each averaged field
    a subtraction, two products and two sums a cell."""
    a = call["args"]
    bv, av, w, mask = a[0], a[1], a[2], a[3]
    nbins = a[5]
    minmax = a[7] if len(a) > 7 else call["kwargs"].get("with_minmax", False)
    n = _n(bv)
    nc = av["shape"][0]
    item = bv["itemsize"]
    nbytes = item * n * (1 + nc) + n * mask["itemsize"]
    if isinstance(w, dict):
        nbytes += item * _n(w)
    nbytes += item * nbins * (1 + 2 * nc + (2 * nc if minmax else 0))
    flops = n * (3 + 5 * nc)
    return nbytes, flops, bv["dtype"]


def joint_hist(call: dict) -> Tuple[float, float, str]:
    """``joint_hist(vals, weight, mask, edges, nbins, pairs, ...)``: every
    variable, the mask and a weight field read once, each pair's three
    ``nbins^2`` tables written once; a pair is two bin indices and three
    weighted sums a cell."""
    a = call["args"]
    vals, w, mask, nbins, pairs = a[0], a[1], a[2], a[4], a[5]
    v0 = vals[0] if isinstance(vals, list) else vals
    nv = len(vals) if isinstance(vals, list) else v0["shape"][0]
    n = _n(v0) if isinstance(vals, list) else _n(v0) // nv
    npairs = len(pairs) if isinstance(pairs, list) else pairs["len"]
    item = v0["itemsize"]
    nbytes = item * n * nv + n * mask["itemsize"]
    if isinstance(w, dict):
        nbytes += item * _n(w)
    nbytes += item * 3 * npairs * nbins * nbins
    flops = n * npairs * (6 + 5)
    return nbytes, flops, v0["dtype"]


def least_s(calls, cost) -> float:
    """The least seconds the card could take for every call."""
    return sum(bound(*cost(c))[0] for c in calls)


def share(least: float, device_s: float):
    """Percent of the least time over the kernels' device seconds; None
    without either."""
    if least <= 0 or device_s <= 0:
        return None
    return 100.0 * least / device_s


def kernel_seconds(tr: dict, names) -> float:
    lo, hi = tr["window"]
    return sum(max(0.0, min(t, hi) - max(s, lo)) for n, s, t in tr["device"]
               if any(k in n for k in names))
