"""Masked, weighted binning primitives of conditionalMean and jpdf
(conditionalMean.cpp:260-303, jpdf.cpp:427-537).

Counterpart of ``peleanalysis_tpu/ops/stats.py``, with the same signatures
and returns.  The JAX package computes every histogram as a chunked one-hot
contraction on the TPU's matrix unit; here each goes through
``ops/stats_kernels.py``: the shared-memory histogram kernel on the card,
its plain version on the CPU.

Bin edges follow the JAX package's rounding (``stats_kernels.bin_transform``):
``folded`` selects the multiply by XLA's folded constant that the JAX tools
compute, whose edges are compile-time constants, instead of the true
division that these functions compute when JAX traces the edges.  ``x64``
rounds a float32 span as JAX's x64 mode does; it is off by default, as in
a JAX CLI process with a float32 state, and the tools leave it so.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .stats_kernels import bin_transform, binned_moments, joint_hist


def binned_stats(bin_vals: torch.Tensor, avg_vals: torch.Tensor, weight,
                 mask: torch.Tensor, bmin: float, bmax: float, nbins: int,
                 clamp: bool = False, with_minmax: bool = False,
                 shift: Optional[torch.Tensor] = None, *,
                 folded: bool = False, x64: bool = False):
    """1-D conditional binning (conditionalMean semantics).

    bin_vals: [*shape]; avg_vals: [ncomp, *shape]; weight: scalar or
    [*shape]; mask: bool [*shape].  Out-of-range cells are dropped
    (clamp=False, conditionalMean.cpp:270-275) or clamped to the edge bins.
    Returns (hits[nbins], sums[nbins, ncomp], sumsq[nbins, ncomp], mins,
    maxs), mins/maxs None without with_minmax.  ``shift`` ([ncomp]) is
    subtracted before the sums (float32-safe moments; reconstruct with
    ``reconstruct_moments``); min/max are of the unshifted values."""
    edges = bin_transform(bmin, bmax, nbins, avg_vals.dtype, folded, x64)
    return binned_moments(bin_vals.to(avg_vals.dtype), avg_vals, weight, mask,
                          edges, nbins, clamp, with_minmax, shift)


def masked_mean(vals: torch.Tensor, mask: torch.Tensor,
                weight) -> torch.Tensor:
    """Weighted masked mean, in vals' dtype; 0 for an empty selection (the
    weight sum is taken in float64, so its zero guard cannot underflow).
    Used as the moment shift (see binned_stats)."""
    w = torch.where(mask, torch.as_tensor(weight, dtype=torch.float64,
                                          device=vals.device), 0.0)
    den = w.sum()
    num = (w.to(vals.dtype) * vals).sum()
    tiny = torch.finfo(torch.float64).tiny
    return (num.double() / den.clamp_min(tiny)).to(vals.dtype)


def reconstruct_moments(hits, sums_s, sumsq_s, shift):
    """Host-side (numpy float64) reconstruction of raw moments from shifted
    ones: sum = sum' + c*hits; sumsq = sumsq' + 2c*sum' + c^2*hits (the
    reference's double-accumulation semantics, conditionalMean.cpp:260-303).
    hits: [nbins]; sums_s/sumsq_s: [nbins, ncomp]; shift: [ncomp].  Returns
    float64 (sums, sumsq)."""
    h = _np64(hits)
    s = _np64(sums_s)
    q = _np64(sumsq_s)
    c = _np64(shift)
    sums = s + c[None, :] * h[:, None]
    sumsq = q + 2.0 * c[None, :] * s + (c * c)[None, :] * h[:, None]
    return sums, sumsq


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def joint_pdf(v1: torch.Tensor, v2: torch.Tensor, vol, mask: torch.Tensor,
              v1min: float, v1max: float, v2min: float, v2max: float,
              nbins: int, shift1=None, shift2=None, *, folded: bool = False,
              x64: bool = False):
    """2-D volume-weighted joint histogram (jpdf semantics: out-of-range
    values clamp into the edge bins, jpdf.cpp:489-496).  Returns (bin,
    binX1, binX2), each [nbins, nbins] row-major [v1, v2]; with shift1 /
    shift2 the X accumulators hold (v - shift) sums (the caller adds
    shift * bin back on the host)."""
    dt = v1.dtype
    edges = [bin_transform(v1min, v1max, nbins, dt, folded, x64),
             bin_transform(v2min, v2max, nbins, dt, folded, x64)]
    shifts = torch.stack([_scalar(shift1, dt, v1.device),
                          _scalar(shift2, dt, v1.device)])
    b, b1, b2 = joint_hist([v1, v2.to(dt)], vol, mask, edges, nbins,
                           [(0, 1)], shifts)
    return b[0], b1[0], b2[0]


def masked_sum(vals: torch.Tensor, mask: torch.Tensor,
               weight) -> torch.Tensor:
    """Sum of value*weight over the masked cells, in vals' dtype."""
    return (torch.where(mask, vals, 0.0) * weight).sum()


def directional_sum(vals: torch.Tensor, mask: torch.Tensor, weight,
                    axes: Tuple[int, ...]) -> torch.Tensor:
    """Sum value*weight over masked cells along the given spatial axes
    (integral's integrate1d analog, Src/integral.cpp:13-60)."""
    return (torch.where(mask, vals, 0.0) * weight).sum(dim=tuple(axes))


def _scalar(x, dt, dev) -> torch.Tensor:
    if x is None:
        return torch.zeros((), dtype=dt, device=dev)
    return torch.as_tensor(x, device=dev).to(dt).reshape(())


def joint_pdf_multi(vals, vol, mask: torch.Tensor, lo, hi, nbins: int,
                    pairs: Sequence[Tuple[int, int]], shifts=None):
    """All-pairs joint histograms over the same cells in one call.

    vals: [nv, *shape] (or a sequence of nv [*shape] tensors); vol: scalar
    or [*shape]; mask: bool [*shape]; lo/hi/shifts: [nv]; pairs: (i, j)
    variable-index pairs.  Returns (b, bx1, bx2), each [npairs, nbins,
    nbins] row-major [vi, vj], jpdf edge-bin clamp semantics; bx hold
    shifted sums as in joint_pdf.  lo and hi are rounded to the values'
    dtype and the bin index divides by their difference, as the JAX
    version's traced edges do."""
    vals = list(vals)
    nv = len(vals)
    dt = vals[0].dtype
    dev = vals[0].device
    if not pairs:
        z = torch.zeros((0, nbins, nbins), dtype=dt, device=dev)
        return z, z, z
    T = np.float64 if dt == torch.float64 else np.float32
    lo_t = np.asarray(lo, np.float64).astype(T)
    hi_t = np.asarray(hi, np.float64).astype(T)
    edges = [(float(lo_t[k]), float(T(hi_t[k] - lo_t[k])), True)
             for k in range(nv)]
    sh = (torch.zeros(nv, dtype=dt, device=dev) if shifts is None
          else torch.as_tensor(shifts, device=dev).to(dt))
    return joint_hist(vals, vol, mask, edges, nbins, list(pairs), sh)
