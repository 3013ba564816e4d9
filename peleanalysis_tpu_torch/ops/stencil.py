"""Finite-difference stencils over grown dense arrays (plain PyTorch).

Counterpart of ``peleanalysis_tpu/ops/stencil.py``: a centered difference
on ghost-filled data equals the reference's averaged MLMG face fluxes
(reference grad.cpp:172-219, curvature.cpp:426-546) for interior cells,

    avg(face flux) = ((f[i+1]-f[i]) + (f[i]-f[i-1])) / (2 dx)
                   = (f[i+1]-f[i-1]) / (2 dx)

All functions map ``[..., X+2s, Y+2s, Z+2s]`` grown arrays to
``[..., X, Y, Z]`` arrays shrunk by the stencil radius ``s``.

Every division by a grid constant divides by a 0-dim tensor of the operand's
dtype and device.  On a CUDA tensor PyTorch turns ``tensor / python_float``
into a multiply by the reciprocal, which rounds differently from the JAX
reference's ``(a - b) / d``; a device tensor keeps the true division.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .vec3 import sqrt


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to ``like``'s dtype, as a 0-dim tensor on its device."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _sh(a: torch.Tensor, axis: int, off: int, shrink: int) -> torch.Tensor:
    """Slice ``a`` along spatial axis (counted from the last 3 dims) with
    offset ``off``, shrinking by ``shrink`` cells per side overall."""
    ax = a.ndim - 3 + axis
    idx = [slice(None)] * a.ndim
    for d in range(3):
        dd = a.ndim - 3 + d
        if dd == ax:
            idx[dd] = slice(shrink + off, a.shape[dd] - shrink + off)
        else:
            idx[dd] = slice(shrink, a.shape[dd] - shrink)
    return a[tuple(idx)]


def centered_gradient(grown: torch.Tensor, dx: Sequence[float],
                      shrink: int = 1) -> Tuple[torch.Tensor, ...]:
    """2nd-order centered gradient.  grown: [..., X+2s, Y+2s, Z+2s] ->
    3 arrays [..., X, Y, Z]."""
    return tuple(
        (_sh(grown, d, +1, shrink) - _sh(grown, d, -1, shrink))
        / _const(2.0 * dx[d], grown)
        for d in range(3)
    )


def magnitude(*comps: torch.Tensor) -> torch.Tensor:
    """sqrt of the sum of squares, correctly rounded on every device: on
    the CPU the root goes through numpy (``vec3.sqrt``), since PyTorch's
    vectorised float32 CPU sqrt now and then returns a whole block of
    values ~2e-4 off (ROADMAP Queue 3 item 3)."""
    s = comps[0] * comps[0]
    for c in comps[1:]:
        s = s + c * c
    return sqrt(s)


def divergence(vec: Sequence[torch.Tensor], dx: Sequence[float],
               shrink: int = 1) -> torch.Tensor:
    """Divergence of a vector field given as 3 grown arrays."""
    out = 0.0
    for d in range(3):
        out = out + (
            _sh(vec[d], d, +1, shrink) - _sh(vec[d], d, -1, shrink)
        ) / _const(2.0 * dx[d], vec[d])
    return out


def hessian(grown: torch.Tensor, dx: Sequence[float],
            shrink: int = 1) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """All 6 unique 2nd derivatives from a (2*shrink)-ghost grown array.
    Returns H[d1][d2] (symmetric)."""
    s = shrink
    H = [[None] * 3 for _ in range(3)]
    for d in range(3):
        c0 = _sh(grown, d, 0, s)
        H[d][d] = (
            _sh(grown, d, +1, s) - 2.0 * c0 + _sh(grown, d, -1, s)
        ) / _const(dx[d] ** 2, grown)
    for d1 in range(3):
        for d2 in range(d1 + 1, 3):
            # mixed: centered in both dims
            pp = _sh2(grown, d1, +1, d2, +1, s)
            pm = _sh2(grown, d1, +1, d2, -1, s)
            mp = _sh2(grown, d1, -1, d2, +1, s)
            mm = _sh2(grown, d1, -1, d2, -1, s)
            H[d1][d2] = H[d2][d1] = (pp - pm - mp + mm) / _const(
                4.0 * dx[d1] * dx[d2], grown)
    return tuple(tuple(row) for row in H)


def _sh2(a: torch.Tensor, ax1: int, off1: int, ax2: int, off2: int,
         shrink: int) -> torch.Tensor:
    """Two-axis offset slice, shrinking by ``shrink`` per side on all axes."""
    offs = {ax1: off1, ax2: off2}
    idx = [slice(None)] * a.ndim
    for d in range(3):
        dd = a.ndim - 3 + d
        o = offs.get(d, 0)
        idx[dd] = slice(shrink + o, a.shape[dd] - shrink + o)
    return a[tuple(idx)]


def laplacian(grown: torch.Tensor, dx: Sequence[float],
              shrink: int = 1) -> torch.Tensor:
    out = 0.0
    s = shrink
    for d in range(3):
        out = out + (
            _sh(grown, d, +1, s) - 2.0 * _sh(grown, d, 0, s)
            + _sh(grown, d, -1, s)
        ) / _const(dx[d] ** 2, grown)
    return out


def interior(grown: torch.Tensor, shrink: int) -> torch.Tensor:
    """Strip ``shrink`` ghost cells from the 3 trailing spatial axes."""
    if shrink == 0:
        return grown
    idx = [slice(None)] * grown.ndim
    for d in range(3):
        dd = grown.ndim - 3 + d
        idx[dd] = slice(shrink, grown.shape[dd] - shrink)
    return grown[tuple(idx)]
