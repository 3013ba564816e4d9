"""Masked, weighted histograms: the hand-written CUDA kernel, its plain
PyTorch versions, and the dispatchers every binned moment and joint pdf of
the stats tools goes through.

The kernel source is ``csrc/stats_hist.cu`` (built and bound by
``ops/cuda_build.py``); it replaces no Pallas kernel, but the XLA one-hot
contractions of ``peleanalysis_tpu/ops/stats.py``.  Two entry points:

  * ``binned_moments``: per bin, hits, shifted sums and sums of squares of
    ``ncomp`` averaged components, and optionally their min/max
    (conditionalMean);
  * ``joint_hist``: per pair of variables, the 2-D histogram b and the
    shifted sums bx1, bx2 (jpdf).

A bin index is ``floor((v - lo) / scale * nbins)`` (``divide``) or
``floor((v - lo) * scale)`` in the state's dtype, with ``(lo, scale,
divide)`` from ``bin_transform``; see there for which form the JAX package
computes where.  Hits with a scalar weight are exact counts times the
weight; sums are exact up to the order of the float additions.

``binned_moments`` and ``joint_hist`` send CPU tensors to the plain
versions and CUDA tensors to the kernel.  Nothing falls back: a failed
build or launch raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import cuda_build
from .stencil import _const

# kernel launches since import (or since a caller reset them), one per
# call of each entry point
BINNED_LAUNCHES = 0
JOINT_LAUNCHES = 0

_NAME = "stats_hist"
_LIB = None
_MAX_SHARED = None
MAXC, MAXV, MAXP = 32, 16, 120
THREADS = 512
# a block's float hit count is exact below 2^24 cells
_MAX_BLOCK_CELLS = (1 << 24) - 1

Edges = Tuple[float, float, bool]
Weight = Union[float, torch.Tensor]


def bin_transform(lo: float, hi: float, nbins: int, dtype: torch.dtype,
                  folded: bool, x64: bool = False) -> Edges:
    """``(lo, scale, divide)`` of the bin index, as the JAX package rounds
    it in ``dtype``.

    The span ``hi - lo`` is formed in float64 and rounded once when JAX's
    x64 mode is on (a weak-typed float64 scalar meets the field) or the
    state is float64, and as ``f32(hi) - f32(lo)`` otherwise.  ``folded``:
    the edges are compile-time constants of the JAX computation (its tools
    pass them as static arguments), and XLA folds ``/ span * nbins`` into one
    multiply by ``K = fl(fl(1 / span) * nbins)``; then ``(lo, K, False)``.
    Otherwise the true division: ``(lo, span, True)``."""
    T = np.float64 if dtype == torch.float64 else np.float32
    if T == np.float64 or x64:
        span = T(float(hi) - float(lo))
    else:
        span = T(T(hi) - T(lo))
    if folded:
        return float(T(lo)), float(T(T(T(1.0) / span) * T(nbins))), False
    return float(T(lo)), float(span), True


def _bin_coord(v: torch.Tensor, edges: Edges, nbins: int) -> torch.Tensor:
    """The floored bin coordinate of each value, NaN taken to 0 (as XLA's
    float->int32 cast takes it)."""
    lo, scale, divide = edges
    t = v - _const(lo, v)
    x = (t / _const(scale, v)) * _const(float(nbins), v) if divide \
        else t * _const(scale, v)
    f = torch.floor(x)
    return torch.where(torch.isnan(f), torch.zeros_like(f), f)


def _is_cell_weight(weight: Weight) -> bool:
    return isinstance(weight, torch.Tensor) and weight.ndim > 0


# ---------------------------------------------------------------------------
# plain versions
def binned_moments_torch(bin_vals: torch.Tensor, avg_vals: torch.Tensor,
                         weight: Weight, mask: torch.Tensor, edges: Edges,
                         nbins: int, clamp: bool = False,
                         with_minmax: bool = False,
                         shift: Optional[torch.Tensor] = None):
    """Plain version: (hits [nbins], sums, sumsq [nbins, ncomp], mins, maxs
    [nbins, ncomp] or None) in avg_vals' dtype; sums and sumsq of the values
    minus ``shift``, min/max of the unshifted values, accumulated in float64
    and rounded once."""
    T = avg_vals.dtype
    ncomp = avg_vals.shape[0]
    f = _bin_coord(bin_vals.reshape(-1), edges, nbins)
    ok = mask.reshape(-1)
    if not clamp:
        ok = ok & (f >= 0) & (f < nbins)
    idx = f.clamp(0, nbins - 1).long()[ok]
    vals = avg_vals.reshape(ncomp, -1)[:, ok]
    sh = (torch.zeros(ncomp, dtype=T, device=vals.device) if shift is None
          else shift.to(T))
    vs = vals - sh[:, None]
    if _is_cell_weight(weight):
        w = weight.reshape(-1)[ok].to(T)
        hit = w
    else:
        w = _const(float(weight), vals)
        hit = torch.ones(idx.shape, dtype=T, device=vals.device)
    terms = torch.cat([hit[None], w * vs, w * (vs * vs)]).double()
    acc = torch.zeros((nbins, 1 + 2 * ncomp), dtype=torch.float64,
                      device=vals.device).index_add_(0, idx, terms.T)
    hits = acc[:, 0] if _is_cell_weight(weight) \
        else acc[:, 0] * float(w)
    out = [hits.to(T), acc[:, 1:1 + ncomp].to(T), acc[:, 1 + ncomp:].to(T)]
    if with_minmax:
        ix = idx[:, None].expand(-1, ncomp)
        inf = float("inf")
        out.append(torch.full((nbins, ncomp), inf, dtype=T,
                              device=vals.device)
                   .scatter_reduce_(0, ix, vals.T, "amin"))
        out.append(torch.full((nbins, ncomp), -inf, dtype=T,
                              device=vals.device)
                   .scatter_reduce_(0, ix, vals.T, "amax"))
    else:
        out += [None, None]
    return tuple(out)


def joint_hist_torch(vals: Sequence[torch.Tensor], weight: Weight,
                     mask: torch.Tensor, edges: Sequence[Edges], nbins: int,
                     pairs: Sequence[Tuple[int, int]],
                     shifts: torch.Tensor):
    """Plain version: (b, bx1, bx2), each [npairs, nbins, nbins] in the
    values' dtype, row-major [v_i, v_j]; out-of-range values clamp into the
    edge bins; bx1/bx2 sum w (v - shift), accumulated in float64 and rounded
    once."""
    T = vals[0].dtype
    dev = vals[0].device
    m = mask.reshape(-1)
    idx = [_bin_coord(v.reshape(-1), e, nbins).clamp(0, nbins - 1).long()[m]
           for v, e in zip(vals, edges)]
    fs = [v.reshape(-1)[m] - shifts[k].to(T) for k, v in enumerate(vals)]
    if _is_cell_weight(weight):
        w = weight.reshape(-1)[m].to(T)
        hit = w
    else:
        w = _const(float(weight), vals[0])
        hit = torch.ones(int(m.sum()), dtype=T, device=dev)
    nb2 = nbins * nbins
    out = torch.zeros((3, len(pairs), nb2), dtype=torch.float64, device=dev)
    for p, (i, j) in enumerate(pairs):
        b = idx[i] * nbins + idx[j]
        out[0, p].index_add_(0, b, hit.double())
        out[1, p].index_add_(0, b, (w * fs[i]).double())
        out[2, p].index_add_(0, b, (w * fs[j]).double())
    if not _is_cell_weight(weight):
        out[0] *= float(w)
    out = out.to(T).reshape(3, len(pairs), nbins, nbins)
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# dispatchers
def _check(ts: Sequence[torch.Tensor], shape, what: str) -> torch.dtype:
    T = ts[0].dtype
    if T not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, not {T}")
    for t in ts:
        if t.dtype != T or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: every field must be {T} of shape "
                             f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)}")
        if t.device != ts[0].device:
            raise ValueError(f"{what}: fields on {t.device} and "
                             f"{ts[0].device}")
    return T


def _device_type(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type


def binned_moments(bin_vals: torch.Tensor, avg_vals: torch.Tensor,
                   weight: Weight, mask: torch.Tensor, edges: Edges,
                   nbins: int, clamp: bool = False, with_minmax: bool = False,
                   shift: Optional[torch.Tensor] = None):
    """Dispatcher: CPU tensors take ``binned_moments_torch``, CUDA tensors
    the kernel.  bin_vals, mask [*shape]; avg_vals [ncomp, *shape]; weight
    a scalar or [*shape]; shift [ncomp] or None."""
    T = _check([bin_vals] + list(avg_vals), bin_vals.shape, "binned_moments")
    if tuple(mask.shape) != tuple(bin_vals.shape) or mask.dtype != torch.bool:
        raise ValueError("mask must be bool of the fields' shape")
    if nbins < 1:
        raise ValueError(f"nbins must be positive, not {nbins}")
    if _device_type(bin_vals, "binned_moments") == "cpu":
        return binned_moments_torch(bin_vals, avg_vals, weight, mask, edges,
                                    nbins, clamp, with_minmax, shift)
    ncomp = avg_vals.shape[0]
    sh = (torch.zeros(ncomp, dtype=T, device=bin_vals.device)
          if shift is None else shift.to(T).contiguous())
    parts = [_launch_binned(bin_vals, avg_vals[k:k + MAXC], weight, mask,
                            edges, nbins, clamp, with_minmax,
                            sh[k:k + MAXC])
             for k in range(0, ncomp, MAXC)]
    hits = parts[0][0]
    cat = [torch.cat([p[i] for p in parts], dim=1)
           for i in range(1, 5 if with_minmax else 3)]
    if not with_minmax:
        cat += [None, None]
    return (hits, *cat)


def joint_hist(vals: Sequence[torch.Tensor], weight: Weight,
               mask: torch.Tensor, edges: Sequence[Edges], nbins: int,
               pairs: Sequence[Tuple[int, int]], shifts: torch.Tensor):
    """Dispatcher: CPU tensors take ``joint_hist_torch``, CUDA tensors the
    kernel.  vals: nv tensors [*shape]; edges: one per variable; pairs of
    variable indices; shifts [nv]."""
    T = _check(list(vals), vals[0].shape, "joint_hist")
    if tuple(mask.shape) != tuple(vals[0].shape) or mask.dtype != torch.bool:
        raise ValueError("mask must be bool of the fields' shape")
    if len(edges) != len(vals) or len({e[2] for e in edges}) > 1:
        raise ValueError("one (lo, scale, divide) per variable, one form")
    if nbins < 1:
        raise ValueError(f"nbins must be positive, not {nbins}")
    if _device_type(vals[0], "joint_hist") == "cpu":
        return joint_hist_torch(vals, weight, mask, edges, nbins, pairs,
                                shifts)
    if len(vals) > MAXV:
        raise ValueError(f"joint_hist takes at most {MAXV} variables")
    P = len(pairs)
    out = torch.empty((3, P, nbins, nbins), dtype=T, device=vals[0].device)
    for p0 in range(0, P, MAXP):
        _launch_joint(vals, weight, mask, edges, nbins, pairs[p0:p0 + MAXP],
                      shifts.to(T).contiguous(), out[:, p0:p0 + MAXP])
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# kernel launches
class _BinnedParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong), ("ncomp", ctypes.c_int),
                ("nbins", ctypes.c_int), ("clamp", ctypes.c_int),
                ("minmax", ctypes.c_int), ("has_w", ctypes.c_int),
                ("nblocks", ctypes.c_int), ("divide", ctypes.c_int),
                ("wscal", ctypes.c_double), ("lo", ctypes.c_double),
                ("scale", ctypes.c_double), ("bin_ptr", ctypes.c_ulonglong),
                ("avg_ptr", ctypes.c_ulonglong * MAXC),
                ("w_ptr", ctypes.c_ulonglong), ("mask_ptr", ctypes.c_ulonglong),
                ("shift_ptr", ctypes.c_ulonglong)]


class _JointParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong), ("nv", ctypes.c_int),
                ("npairs", ctypes.c_int), ("nbins", ctypes.c_int),
                ("has_w", ctypes.c_int), ("nblocks", ctypes.c_int),
                ("divide", ctypes.c_int), ("wscal", ctypes.c_double),
                ("lo", ctypes.c_double * MAXV),
                ("scale", ctypes.c_double * MAXV),
                ("pi", ctypes.c_int * MAXP), ("pj", ctypes.c_int * MAXP),
                ("v_ptr", ctypes.c_ulonglong * MAXV),
                ("w_ptr", ctypes.c_ulonglong), ("mask_ptr", ctypes.c_ulonglong),
                ("shift_ptr", ctypes.c_ulonglong)]


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def _weight_args(weight: Weight, like: torch.Tensor):
    """(has_w, wscal rounded to the state dtype, per-cell tensor or None)"""
    if _is_cell_weight(weight):
        if tuple(weight.shape) != tuple(like.shape):
            raise ValueError(f"weight shape {tuple(weight.shape)} != "
                             f"{tuple(like.shape)}")
        return 1, 0.0, _flat(weight.to(like.dtype))
    return 0, float(torch.tensor(float(weight), dtype=like.dtype)), None


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def max_shared_bytes() -> int:
    """Shared memory a block may use on the current card (opt-in)."""
    global _MAX_SHARED
    if _MAX_SHARED is None:
        out = ctypes.c_int(0)
        err = load_library().stats_max_shared_bytes(ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed: {err}")
        _MAX_SHARED = int(out.value)
    return _MAX_SHARED


def binned_shared_bytes(nbins: int, ncomp: int, with_minmax: bool,
                        dtype: torch.dtype) -> int:
    es = torch.empty((), dtype=dtype).element_size()
    return es * nbins * (1 + 2 * ncomp) + (2 * es * nbins * ncomp
                                           if with_minmax else 0)


def joint_shared_bytes(nbins: int, dtype: torch.dtype) -> int:
    return 3 * nbins * nbins * torch.empty((), dtype=dtype).element_size()


def _blocks(n: int, target: int) -> int:
    return max(1, min(-(-n // (8 * THREADS)), target),
               -(-n // _MAX_BLOCK_CELLS))


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_binned(bin_vals, avg_vals, weight, mask, edges, nbins, clamp,
                   with_minmax, shift):
    global BINNED_LAUNCHES
    dev, T = bin_vals.device, bin_vals.dtype
    n, ncomp = bin_vals.numel(), avg_vals.shape[0]
    bv = _flat(bin_vals)
    comps = [_flat(avg_vals[k]) for k in range(ncomp)]
    m = _flat(mask)
    has_w, wscal, wt = _weight_args(weight, bin_vals)
    shared = binned_shared_bytes(nbins, ncomp, with_minmax, T) \
        <= max_shared_bytes()
    nblocks = _blocks(n, 4 * _sms(dev)) if shared else \
        max(1, min(-(-n // THREADS), 8 * _sms(dev)))
    p = _BinnedParams(n=n, ncomp=ncomp, nbins=nbins, clamp=int(clamp),
                      minmax=int(with_minmax), has_w=has_w, nblocks=nblocks,
                      divide=int(edges[2]), wscal=wscal, lo=edges[0],
                      scale=edges[1], bin_ptr=bv.data_ptr(),
                      w_ptr=wt.data_ptr() if wt is not None else 0,
                      mask_ptr=m.data_ptr(), shift_ptr=shift.data_ptr())
    for k, c in enumerate(comps):
        p.avg_ptr[k] = c.data_ptr()
    nacc, nmm = nbins * (1 + 2 * ncomp), nbins * ncomp
    enc = torch.int32 if T == torch.float32 else torch.int64
    if shared:
        scratch = torch.empty((nblocks, nacc), dtype=T, device=dev)
        mm = torch.empty((nblocks, 2, nmm) if with_minmax else (0,),
                         dtype=enc, device=dev)
    else:
        scratch = torch.empty(nacc, dtype=torch.float64, device=dev)
        mm = torch.empty((2, nmm) if with_minmax else (0,), dtype=enc,
                         device=dev)
    hits = torch.empty(nbins, dtype=T, device=dev)
    sums = torch.empty((nbins, ncomp), dtype=T, device=dev)
    sumsq = torch.empty((nbins, ncomp), dtype=T, device=dev)
    mins = torch.empty((nbins, ncomp) if with_minmax else (0,), dtype=T,
                       device=dev)
    maxs = torch.empty_like(mins)
    lib = load_library()
    fn = lib.stats_binned_f32 if T == torch.float32 else lib.stats_binned_f64
    with torch.cuda.device(dev):
        err = fn(p, int(shared), scratch.data_ptr(), mm.data_ptr(),
                 hits.data_ptr(), sums.data_ptr(), sumsq.data_ptr(),
                 mins.data_ptr(), maxs.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"stats_binned kernel launch failed: cudaError "
                           f"{err}")
    BINNED_LAUNCHES += 1
    return (hits, sums, sumsq, mins, maxs) if with_minmax \
        else (hits, sums, sumsq)


def _launch_joint(vals, weight, mask, edges, nbins, pairs, shifts, out):
    global JOINT_LAUNCHES
    dev, T = vals[0].device, vals[0].dtype
    n, P = vals[0].numel(), len(pairs)
    vs = [_flat(v) for v in vals]
    m = _flat(mask)
    has_w, wscal, wt = _weight_args(weight, vals[0])
    shared = joint_shared_bytes(nbins, T) <= max_shared_bytes()
    nblocks = _blocks(n, max(1, 2 * _sms(dev) // P)) if shared else \
        max(1, min(-(-n // THREADS), max(1, 8 * _sms(dev) // P)))
    p = _JointParams(n=n, nv=len(vals), npairs=P, nbins=nbins, has_w=has_w,
                     nblocks=nblocks, divide=int(edges[0][2]), wscal=wscal,
                     w_ptr=wt.data_ptr() if wt is not None else 0,
                     mask_ptr=m.data_ptr(), shift_ptr=shifts.data_ptr())
    for k, (v, e) in enumerate(zip(vs, edges)):
        p.v_ptr[k] = v.data_ptr()
        p.lo[k], p.scale[k] = e[0], e[1]
    for q, (i, j) in enumerate(pairs):
        p.pi[q], p.pj[q] = i, j
    nb2 = nbins * nbins
    scratch = (torch.empty((P, nblocks, 3 * nb2), dtype=T, device=dev)
               if shared else
               torch.empty((P, 3 * nb2), dtype=torch.float64, device=dev))
    res = out if out.is_contiguous() else torch.empty_like(out)
    lib = load_library()
    fn = lib.stats_joint_f32 if T == torch.float32 else lib.stats_joint_f64
    with torch.cuda.device(dev):
        err = fn(p, int(shared), scratch.data_ptr(), res.data_ptr(),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"stats_joint kernel launch failed: cudaError "
                           f"{err}")
    if res is not out:
        out.copy_(res)
    JOINT_LAUNCHES += 1


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return cuda_build.library_path(_NAME)


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/stats_hist.cu`` unless this source's build exists."""
    return cuda_build.build(_NAME, verbose)


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        ptrs = [ctypes.c_void_p] * 7
        _LIB = cuda_build.load(_NAME, {
            "stats_binned_f32": [_BinnedParams, ctypes.c_int, *ptrs,
                                 ctypes.c_void_p],
            "stats_binned_f64": [_BinnedParams, ctypes.c_int, *ptrs,
                                 ctypes.c_void_p],
            "stats_joint_f32": [_JointParams, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p],
            "stats_joint_f64": [_JointParams, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p],
            "stats_max_shared_bytes": [ctypes.POINTER(ctypes.c_int)]})
    return _LIB
