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

``cg_solve_sharded`` is the same loop over shard windows (the JAX
package's GSPMD-sharded solve): each dot is summed per shard over the
cells it owns and the partial sums are added on the first shard's device
in shard order, so its sums run in another order than the one-device
solve's and its result is not byte-equal to it.
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


def cg_solve_sharded(apply_A: Callable, b, x0, masks, weights, n_iter: int,
                     rtol: Optional[float] = None):
    """Conjugate gradient over shards.  ``b``, ``x0``, ``masks`` and
    ``weights`` are ``[shard][part]`` lists of tensors on each shard's
    device: ``masks`` (bool) the cells solved for, as ``cg_solve``'s mask
    or ``cg_solve_composite``'s mask_list; ``weights`` the dot weights,
    zero off the cells the shard owns, so that each unknown counts once.
    ``apply_A`` maps such a list to another (exchanging the halos it
    reads).  alpha and beta are formed on the first shard's device and
    copied to each shard.  rtol as in ``cg_solve``."""
    dev0 = b[0][0].device
    devs = [bs[0].device for bs in b]
    tiny = torch.finfo(b[0][0].dtype).tiny

    def dot(us, vs):
        parts = [sum(torch.sum(u * v * w) for u, v, w in zip(ua, va, wa))
                 .to(dev0) for ua, va, wa in zip(us, vs, weights)]
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out

    def mask_mul(us):
        return [[u * m for u, m in zip(ua, ma)] for ua, ma in zip(us, masks)]

    def step(x, r, p, rs):
        Ap = mask_mul(apply_A(p))
        alpha = _guarded_div(rs, dot(p, Ap), tiny)
        al = [alpha.to(d) for d in devs]
        x = [[xi + a * pi * mi for xi, pi, mi in zip(xa, pa, ma)]
             for xa, pa, ma, a in zip(x, p, masks, al)]
        r = [[ri - a * api for ri, api in zip(ra, apa)]
             for ra, apa, a in zip(r, Ap, al)]
        rs_new = dot(r, r)
        beta = _guarded_div(rs_new, rs, tiny)
        be = [beta.to(d) for d in devs]
        p = [[(ri + bb * pi) * mi for ri, pi, mi in zip(ra, pa, ma)]
             for ra, pa, ma, bb in zip(r, p, masks, be)]
        return x, r, p, rs_new

    r0 = mask_mul([[bi - ai for bi, ai in zip(ba, aa)]
                   for ba, aa in zip(b, apply_A(x0))])
    rs0 = dot(r0, r0)
    return _loop(step, ([list(xa) for xa in x0], r0, r0, rs0), rs0, n_iter,
                 rtol)


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
