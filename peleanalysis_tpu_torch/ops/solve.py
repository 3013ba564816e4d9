"""Matrix-free conjugate gradient on dense levels (plain PyTorch): the
implicit smoothing solve ``(I - beta lap) c~ = c`` of curvature
(curvature.cpp:328-406, MLABecLaplacian + MLMG::solve).

Counterpart of ``peleanalysis_tpu/ops/solve.py``.  JAX runs the loop under
``lax.scan`` (fixed count) or ``lax.while_loop`` (tolerance); here it is a
Python loop.  With ``rtol`` set, each iteration reads the residual on the
host once (one synchronisation an iteration, at most ``n_iter``); with
``rtol=None`` the loop runs exactly ``n_iter`` iterations and never waits on
the device.  ``ITERATIONS`` lists the iteration count of every solve
since a caller cleared it.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# iterations taken by each cg_solve / cg_solve_composite, in call order
ITERATIONS: list = []


def _guarded_div(num: torch.Tensor, den: torch.Tensor,
                 tiny: float) -> torch.Tensor:
    """num / den where |den| > tiny, else 0 (device scalars, no sync)."""
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den.abs() > tiny, num / safe, torch.zeros_like(den))


def _loop(step, state, rs0: torch.Tensor, n_iter: int,
          rtol: Optional[float]):
    it = 0
    if rtol is None:
        for it in range(1, n_iter + 1):
            state = step(*state)
    else:
        # stop at the first iteration where rs <= rs0 * rtol^2 (the
        # lax.while_loop condition), capped at n_iter
        target = rs0 * (rtol * rtol)
        while it < n_iter and bool(state[3] > target):
            state = step(*state)
            it += 1
    ITERATIONS.append(it)
    return state[0]


def cg_solve(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor,
             mask: Optional[torch.Tensor], n_iter: int,
             rtol: Optional[float] = None) -> torch.Tensor:
    """Masked conjugate gradient: solves A x = b on cells where mask=True
    (off-mask cells keep x0; apply_A treats them as boundary values).
    rtol=None: exactly n_iter iterations; rtol>0: until ||r|| <= rtol
    ||r0|| or n_iter."""
    m = (mask.to(b.dtype) if mask is not None else torch.ones_like(b))

    def dot(u, v):
        return torch.sum(u * v * m)

    tiny = torch.finfo(b.dtype).tiny   # 1e-300 underflows to 0 in float32

    def step(x, r, p, rs):
        Ap = apply_A(p) * m
        alpha = _guarded_div(rs, dot(p, Ap), tiny)
        x = x + alpha * p * m
        r = r - alpha * Ap
        rs_new = dot(r, r)
        beta = _guarded_div(rs_new, rs, tiny)
        p = (r + beta * p) * m
        return x, r, p, rs_new

    r0 = (b - apply_A(x0)) * m
    rs0 = dot(r0, r0)
    return _loop(step, (x0, r0, r0, rs0), rs0, n_iter, rtol)


def cg_solve_composite(apply_A: Callable, b_list, x0_list, mask_list,
                       vol_list, n_iter: int, rtol: Optional[float] = None):
    """Composite-hierarchy CG: the unknowns are the valid cells of every
    level at once (the MLMG composite-solve analog).  apply_A maps a list
    of per-level arrays to a list; dots are volume-weighted over valid
    cells.  rtol as in ``cg_solve``."""
    ms = [m.to(b_list[0].dtype) * v for m, v in zip(mask_list, vol_list)]

    def dot(us, vs):
        return sum(torch.sum(u * v * m) for u, v, m in zip(us, vs, ms))

    def mask_mul(us):
        return [u * (m > 0) for u, m in zip(us, mask_list)]

    tiny = torch.finfo(b_list[0].dtype).tiny

    def step(x, r, p, rs):
        Ap = mask_mul(apply_A(p))
        alpha = _guarded_div(rs, dot(p, Ap), tiny)
        x = [xi + alpha * pi * mi for xi, pi, mi in zip(x, p, mask_list)]
        r = [ri - alpha * api for ri, api in zip(r, Ap)]
        rs_new = dot(r, r)
        beta = _guarded_div(rs_new, rs, tiny)
        p = [(ri + beta * pi) * mi for ri, pi, mi in zip(r, p, mask_list)]
        return x, r, p, rs_new

    r0 = mask_mul([bi - ai for bi, ai in zip(b_list, apply_A(x0_list))])
    rs0 = dot(r0, r0)
    return _loop(step, (list(x0_list), r0, list(r0), rs0), rs0, n_iter, rtol)


def cg_iterations_to_tol(apply_A: Callable, b_list, x0_list, mask_list,
                         vol_list, rtol: float, max_iter: int = 500) -> int:
    """Diagnostic: run composite CG step by step with float64 host dots and
    return the iteration count needed to reach rtol (documents the
    curvature-smoothing defaults)."""
    ms = [m.to(b_list[0].dtype) * v for m, v in zip(mask_list, vol_list)]

    def dot(us, vs):
        return sum(float(torch.sum(u * v * m)) for u, v, m in zip(us, vs, ms))

    def mask_mul(us):
        return [u * (m > 0) for u, m in zip(us, mask_list)]

    x = list(x0_list)
    r = mask_mul([bi - ai for bi, ai in zip(b_list, apply_A(x))])
    p = list(r)
    rs = dot(r, r)
    rs0 = rs
    for it in range(max_iter):
        if rs <= rs0 * rtol * rtol:
            return it
        Ap = mask_mul(apply_A(p))
        den = dot(p, Ap)
        alpha = 0.0 if den == 0 else rs / den
        x = [xi + alpha * pi * (mi > 0) for xi, pi, mi in zip(x, p, mask_list)]
        r = [ri - alpha * api for ri, api in zip(r, Ap)]
        rs_new = dot(r, r)
        beta = 0.0 if rs == 0 else rs_new / rs
        p = [(ri + beta * pi) * (mi > 0) for ri, pi, mi in zip(r, p, mask_list)]
        rs = rs_new
    return max_iter
