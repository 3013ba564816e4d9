"""Separable convolution filters (PelePhysics ``Filter`` analog, used by
``filterPlt`` — the reference's Src/filterPlt.cpp:11-13,87-91).

Counterpart of ``peleanalysis_tpu/ops/filter.py``.  Kernels (discrete,
normalized, odd support width fgr+1 like the PelePhysics box filter):
  * "box": top-hat of width fgr cells — uniform interior weights with
    half-weight endpoints when fgr is even (trapezoid rule over the filter
    volume)
  * "gaussian": discrete Gaussian with standard deviation fgr*dx/sqrt(12)
    (same second moment as the box filter of width fgr)

The filter is plain torch slice-multiply-adds in the JAX version's order
(XLA only fused it), not a convolution, whose sums would round
differently.
"""
from __future__ import annotations

import numpy as np
import torch


def filter_weights(kind: str, fgr: int) -> np.ndarray:
    if fgr < 1:
        return np.array([1.0])
    if kind == "box":
        n = fgr + 1
        w = np.ones(n)
        if fgr % 2 == 0:
            w[0] = w[-1] = 0.5
        else:
            n = fgr
            w = np.ones(n)
    elif kind == "gaussian":
        sigma = fgr / np.sqrt(12.0)
        half = max(int(np.ceil(3 * sigma)), 1)
        x = np.arange(-half, half + 1)
        w = np.exp(-0.5 * (x / sigma) ** 2)
    else:
        raise ValueError(f"unknown filter type {kind}")
    return w / w.sum()


def separable_filter(grown: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """Apply the 1-D kernel along each of the 3 trailing axes; input must be
    grown by (len(weights)-1)//2 ghosts; output is the interior.  Each
    weight is rounded to the tensor's dtype before it multiplies, as
    ``jnp.asarray(w, dtype)`` does."""
    half = (len(weights) - 1) // 2
    ws = np.asarray(weights).astype(
        np.float64 if grown.dtype == torch.float64 else np.float32)
    out = grown
    for d in range(3):
        ax = out.ndim - 3 + d
        n = out.shape[ax]
        acc = 0.0
        for k, wk in enumerate(ws):
            acc = acc + out.narrow(ax, k, n - 2 * half) * float(wk)
        out = acc
    return out
