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
build or launch raises.  Each kernel call is planned in plain Python
(``plan_binned``, ``plan_joint``: shared, cluster or device-memory
variant, grid, sub-histograms, rounds and the scratch layout) and runs the
histogram kernel and its finishing kernel, counted as one launch.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
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
# components, variables and pairs of one launch (csrc/stats_hist_params.h)
MAXC, MAXV, MAXP = 32, 16, 120

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
    if len(parts) == 1:
        return parts[0]
    return (parts[0][0], *[torch.cat([p[i] for p in parts], dim=1)
                           if with_minmax or i < 3 else None
                           for i in range(1, 5)])


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
    sh = shifts.to(T).contiguous()
    for p0 in range(0, P, MAXP):
        _launch_joint(vals, weight, mask, edges, nbins, pairs[p0:p0 + MAXP],
                      sh, out[:, p0:p0 + MAXP])
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# the launch plan: pure Python, so the CPU tests reach it
VARIANTS = ("shared", "device")
# a block's count of cells stays below 2^24 (and so its integer counts far
# below 2^32)
MAX_BLOCK_CELLS = (1 << 24) - 1
# rounded float32 adds into one slot of a binned sub-histogram between two
# folds into the block's float64 sums: each add rounds by at most 2^-24 of
# the slot's magnitude, so 1024 adds stay within 6.1e-5 of it
BINNED_ADDS = 1024
# shared memory of one SM, and what each resident block takes of it besides
# its own (the H100: 228 KB, 1 KB)
SM_SHARED = 233472
BLOCK_RESERVED = 1024
# (blocks an SM, threads a block) the shared-memory kernels are built for,
# densest first: the binned kernel keeps 32 registers a thread in float32
# (64 in float64), the joint kernel 64; the device-memory kernels run four
# blocks of 512 an SM
BINNED_SHAPES = {torch.float32: ((4, 512), (2, 512), (1, 512)),
                 torch.float64: ((2, 512), (1, 512))}
JOINT_SHAPES = ((2, 512), (1, 1024))


@dataclass(frozen=True)
class Plan:
    """How one launch runs (mirrored by StatsPlan in
    ``csrc/stats_hist_params.h``), and what follows from it."""
    variant: str           # "shared" or "device"
    nblocks: int           # blocks of the histogram kernel
    threads: int           # threads of a block
    ncopies: int           # sub-histograms of a block (binned, shared)
    nparts: int            # partials the finish sums
    vec: int               # cells a thread loads at once
    smem: int              # dynamic shared bytes of a block
    chunk: int             # cells of a block
    round_cells: int       # cells a block adds between float64 folds
    acc_off: int           # scratch layout (bytes)
    mm_off: int
    cnt_off: int
    scratch_bytes: int
    slot_adds: int         # most rounded adds in the state's type into one
                           # histogram slot before float64 (0: none)
    blocks_per_sm: int     # resident blocks an SM the plan counts on

    def struct(self) -> "_StatsPlan":
        return _StatsPlan(
            chunk=self.chunk, round_cells=self.round_cells,
            acc_off=self.acc_off, mm_off=self.mm_off, cnt_off=self.cnt_off,
            scratch_bytes=self.scratch_bytes,
            variant=VARIANTS.index(self.variant), nblocks=self.nblocks,
            threads=self.threads, ncopies=self.ncopies, nparts=self.nparts,
            vec=self.vec, smem=self.smem)


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def _copy_bytes(nb: int, slots: int, nmm: int, counts: bool,
                es: int) -> int:
    """One shared-memory histogram of nb bins (``copy_bytes`` in the
    kernel): sums [nb][slots], min/max keys [2][nb][nmm], counts [nb]."""
    return (_align16(nb * slots * es) + _align16(2 * nb * nmm * es)
            + (_align16(4 * nb) if counts else 0))


def _place(n: int, copy: int, vec: int, sms: int, max_smem: int, shapes,
           copies: bool = False, fixed: int = 0):
    """(variant, threads, ncopies, smem, nblocks, blocks an SM): the
    densest of ``shapes`` (blocks an SM, threads) whose share of an SM's
    shared memory holds ``copy`` bytes of histogram and ``fixed`` more, with
    ``copies`` as many sub-histograms as fit, one a warp where some shape
    holds them all (else fewer, by powers of two); else device memory."""
    least = -(-n // MAX_BLOCK_CELLS)
    for whole in ((True, False) if copies else (True,)):
        for bps, threads in shapes:
            budget = min(max_smem, SM_SHARED // bps - BLOCK_RESERVED)
            k = threads // 32 if copies else 1
            while not whole and k > 1 and k * copy + fixed > budget:
                k //= 2
            if k * copy + fixed > budget:
                continue
            need = -(-n // (threads * vec))
            nblocks = max(min(sms * bps, need), least, 1)
            return "shared", threads, k, k * copy + fixed, nblocks, bps
    return "device", 512, 1, 0, max(min(4 * sms, -(-n // 512)), least, 1), 4


def _scratch(variant, nparts, nb, slots, nmm, counts, acc_es, key_es):
    """(mm_off, cnt_off, bytes) of the partials: sums [nparts][slots][nb],
    keys [nparts][2][nb][nmm], counts [nparts][nb]."""
    mm_off = _align16(nparts * nb * slots * acc_es)
    cnt_off = _align16(mm_off + nparts * 2 * nb * nmm * key_es)
    end = _align16(cnt_off + (nparts * nb * 4 if counts else 0))
    return mm_off, cnt_off, max(16, end)


@functools.lru_cache(maxsize=256)
def plan_binned(n: int, ncomp: int, nbins: int, minmax: bool, has_w: bool,
                dtype: torch.dtype, vec: int, sms: int,
                max_smem: int) -> Plan:
    """The launch of one binned call of n cells and ncomp (<= MAXC)
    components; slots a bin: (sum, sum of squares) a component, then the
    weight sum and a pad with per-cell weights (device memory: the counts
    there too).  Shared variant: a sub-histogram a warp (or fewer) and the
    block's float64 sums, folded every round_cells; partials in float64."""
    es = 8 if dtype == torch.float64 else 4
    nmm = ncomp if minmax else 0
    slots = 2 * ncomp + 2 * int(has_w)
    variant, threads, ncopies, smem, nblocks, bps = _place(
        n, _copy_bytes(nbins, slots, nmm, not has_w, es), vec, sms,
        max_smem, BINNED_SHAPES[dtype], True, 8 * nbins * slots)
    chunk = -(-(-(-n // nblocks)) // 4) * 4
    if variant == "device":
        slots, round_cells, adds, nparts = 2 * ncomp + 2, chunk, 0, 1
    else:
        nparts, round_cells, adds = nblocks, chunk, chunk
        if dtype == torch.float32:
            # a copy serves threads / 32 / ncopies warps, 32 * vec cells
            # each a sweep of the block over threads * vec cells
            per_sweep = threads // 32 // ncopies * 32 * vec
            sweeps = max(1, BINNED_ADDS // per_sweep)
            round_cells, adds = sweeps * threads * vec, sweeps * per_sweep
    mm_off, cnt_off, size = _scratch(
        variant, nparts, nbins, slots, nmm,
        not has_w and variant == "shared", 8, es)
    return Plan(variant, nblocks, threads, ncopies, nparts, vec, smem,
                chunk, round_cells, 0, mm_off, cnt_off, size, adds, bps)


@functools.lru_cache(maxsize=256)
def plan_joint(n: int, npairs: int, nbins: int, has_w: bool,
               dtype: torch.dtype, vec: int, sms: int,
               max_smem: int) -> Plan:
    """The launch of one joint call of n cells and npairs (<= MAXP) pairs:
    one histogram of npairs * nbins^2 bins (bx1, bx2, then the weight sum
    and a pad with per-cell weights; device memory: the counts there too)
    a block; partials in the state's type (float64 in device memory)."""
    es = 8 if dtype == torch.float64 else 4
    nb = npairs * nbins * nbins
    slots = 2 + 2 * int(has_w)
    variant, threads, _, smem, nblocks, bps = _place(
        n, _copy_bytes(nb, slots, 0, not has_w, es), vec, sms, max_smem,
        JOINT_SHAPES)
    chunk = -(-(-(-n // nblocks)) // 4) * 4
    if variant == "device":
        mm_off, cnt_off, size = _scratch(variant, 1, nb, 4, 0, False, 8, es)
        return Plan(variant, nblocks, threads, 1, 1, vec, smem, chunk, chunk,
                    0, mm_off, cnt_off, size, 0, bps)
    mm_off, cnt_off, size = _scratch(variant, nblocks, nb, slots, 0,
                                     not has_w, es, es)
    return Plan(variant, nblocks, threads, 1, nblocks, vec, smem, chunk,
                chunk, 0, mm_off, cnt_off, size, chunk, bps)


def vec_width(dtype: torch.dtype, ptrs: Sequence[int], mask_ptr: int) -> int:
    """Cells a thread loads at once: 16 bytes of every value array (4
    float32, 2 float64) where each is 16-byte aligned and the mask as
    aligned, else 1."""
    v = 2 if dtype == torch.float64 else 4
    if all(p % 16 == 0 for p in ptrs) and mask_ptr % v == 0:
        return v
    return 1


# ---------------------------------------------------------------------------
# kernel launches
class _StatsPlan(ctypes.Structure):
    _fields_ = [("chunk", ctypes.c_longlong),
                ("round_cells", ctypes.c_longlong),
                ("acc_off", ctypes.c_longlong), ("mm_off", ctypes.c_longlong),
                ("cnt_off", ctypes.c_longlong),
                ("scratch_bytes", ctypes.c_longlong),
                ("variant", ctypes.c_int), ("nblocks", ctypes.c_int),
                ("threads", ctypes.c_int), ("ncopies", ctypes.c_int),
                ("nparts", ctypes.c_int), ("vec", ctypes.c_int),
                ("smem", ctypes.c_int), ("pad", ctypes.c_int)]


class _BinnedParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong), ("ncomp", ctypes.c_int),
                ("nbins", ctypes.c_int), ("clamp", ctypes.c_int),
                ("minmax", ctypes.c_int), ("has_w", ctypes.c_int),
                ("divide", ctypes.c_int),
                ("wscal", ctypes.c_double), ("lo", ctypes.c_double),
                ("scale", ctypes.c_double), ("bin_ptr", ctypes.c_ulonglong),
                ("avg_ptr", ctypes.c_ulonglong * MAXC),
                ("w_ptr", ctypes.c_ulonglong), ("mask_ptr", ctypes.c_ulonglong),
                ("shift_ptr", ctypes.c_ulonglong), ("plan", _StatsPlan)]


class _JointParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong), ("nv", ctypes.c_int),
                ("npairs", ctypes.c_int), ("nbins", ctypes.c_int),
                ("has_w", ctypes.c_int), ("divide", ctypes.c_int),
                ("wscal", ctypes.c_double),
                ("lo", ctypes.c_double * MAXV),
                ("scale", ctypes.c_double * MAXV),
                ("pi", ctypes.c_int * MAXP), ("pj", ctypes.c_int * MAXP),
                ("v_ptr", ctypes.c_ulonglong * MAXV),
                ("w_ptr", ctypes.c_ulonglong), ("mask_ptr", ctypes.c_ulonglong),
                ("shift_ptr", ctypes.c_ulonglong), ("plan", _StatsPlan)]


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def _weight_args(weight: Weight, like: torch.Tensor):
    """(has_w, wscal rounded to the state dtype, per-cell tensor or None)"""
    if _is_cell_weight(weight):
        if tuple(weight.shape) != tuple(like.shape):
            raise ValueError(f"weight shape {tuple(weight.shape)} != "
                             f"{tuple(like.shape)}")
        return 1, 0.0, _flat(weight.to(like.dtype))
    T = np.float64 if like.dtype == torch.float64 else np.float32
    return 0, float(T(float(weight))), None


_SMS = {}


def _sms(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


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


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def _on(dev: torch.device):
    """The context that makes dev current, if it is not already."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def binned_plan(bin_vals: torch.Tensor, avg_vals: torch.Tensor,
                weight: Weight, mask: torch.Tensor, nbins: int,
                with_minmax: bool) -> Plan:
    """The plan of one binned launch on these CUDA tensors (avg_vals: at
    most MAXC components; contiguous, as the launch takes them)."""
    T = bin_vals.dtype
    ptrs = [bin_vals.data_ptr(), *(a.data_ptr() for a in avg_vals)]
    if _is_cell_weight(weight):
        ptrs.append(weight.data_ptr())
    return plan_binned(bin_vals.numel(), len(avg_vals), nbins, with_minmax,
                       _is_cell_weight(weight), T,
                       vec_width(T, ptrs, mask.data_ptr()),
                       _sms(bin_vals.device), max_shared_bytes())


def joint_plan(vals: Sequence[torch.Tensor], weight: Weight,
               mask: torch.Tensor, nbins: int, npairs: int) -> Plan:
    """The plan of one joint launch of npairs (<= MAXP) pairs on these
    contiguous CUDA tensors."""
    T = vals[0].dtype
    ptrs = [v.data_ptr() for v in vals]
    if _is_cell_weight(weight):
        ptrs.append(weight.data_ptr())
    return plan_joint(vals[0].numel(), npairs, nbins,
                      _is_cell_weight(weight), T,
                      vec_width(T, ptrs, mask.data_ptr()),
                      _sms(vals[0].device), max_shared_bytes())


def _launch_binned(bin_vals, avg_vals, weight, mask, edges, nbins, clamp,
                   with_minmax, shift):
    global BINNED_LAUNCHES
    dev, T = bin_vals.device, bin_vals.dtype
    n, ncomp = bin_vals.numel(), avg_vals.shape[0]
    bv, m = _flat(bin_vals), _flat(mask)
    comps = [_flat(avg_vals[k]) for k in range(ncomp)]
    has_w, wscal, wt = _weight_args(weight, bin_vals)
    plan = binned_plan(bv, comps, weight if wt is None else wt, m, nbins,
                       with_minmax)
    p = _BinnedParams(n=n, ncomp=ncomp, nbins=nbins, clamp=int(clamp),
                      minmax=int(with_minmax), has_w=has_w,
                      divide=int(edges[2]), wscal=wscal, lo=edges[0],
                      scale=edges[1], bin_ptr=bv.data_ptr(),
                      w_ptr=wt.data_ptr() if wt is not None else 0,
                      mask_ptr=m.data_ptr(), shift_ptr=shift.data_ptr(),
                      plan=plan.struct())
    p.avg_ptr[:ncomp] = [c.data_ptr() for c in comps]
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    hits = torch.empty(nbins, dtype=T, device=dev)
    mom = torch.empty((4 if with_minmax else 2, nbins, ncomp), dtype=T,
                      device=dev)
    lib = load_library()
    fn = lib.stats_binned_f32 if T == torch.float32 else lib.stats_binned_f64
    mm = (mom[2].data_ptr(), mom[3].data_ptr()) if with_minmax else (0, 0)
    with _on(dev):
        err = fn(p, scratch.data_ptr(), hits.data_ptr(), mom[0].data_ptr(),
                 mom[1].data_ptr(), *mm, _stream(dev))
    if err != 0:
        raise RuntimeError(f"stats_binned kernel launch failed: cudaError "
                           f"{err} ({plan})")
    BINNED_LAUNCHES += 1
    return (hits, *mom) if with_minmax else (hits, mom[0], mom[1], None,
                                             None)


def _launch_joint(vals, weight, mask, edges, nbins, pairs, shifts, out):
    global JOINT_LAUNCHES
    dev, T = vals[0].device, vals[0].dtype
    n, P = vals[0].numel(), len(pairs)
    vs = [_flat(v) for v in vals]
    m = _flat(mask)
    has_w, wscal, wt = _weight_args(weight, vals[0])
    plan = joint_plan(vs, weight if wt is None else wt, m, nbins, P)
    p = _JointParams(n=n, nv=len(vals), npairs=P, nbins=nbins, has_w=has_w,
                     divide=int(edges[0][2]), wscal=wscal,
                     w_ptr=wt.data_ptr() if wt is not None else 0,
                     mask_ptr=m.data_ptr(), shift_ptr=shifts.data_ptr(),
                     plan=plan.struct())
    p.v_ptr[:len(vs)] = [v.data_ptr() for v in vs]
    p.lo[:len(edges)] = [e[0] for e in edges]
    p.scale[:len(edges)] = [e[1] for e in edges]
    p.pi[:P] = [i for i, _ in pairs]
    p.pj[:P] = [j for _, j in pairs]
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    res = out if out.is_contiguous() else torch.empty_like(out)
    lib = load_library()
    fn = lib.stats_joint_f32 if T == torch.float32 else lib.stats_joint_f64
    with _on(dev):
        err = fn(p, scratch.data_ptr(), res.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"stats_joint kernel launch failed: cudaError "
                           f"{err} ({plan})")
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
    """The kernel's library, its struct sizes held against the ctypes
    mirrors (a mismatch would reach the card as garbage)."""
    global _LIB
    if _LIB is None:
        ptrs = [ctypes.c_void_p] * 7
        lib = cuda_build.load(_NAME, {
            "stats_binned_f32": [_BinnedParams, *ptrs],
            "stats_binned_f64": [_BinnedParams, *ptrs],
            "stats_joint_f32": [_JointParams, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p],
            "stats_joint_f64": [_JointParams, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p],
            "stats_max_shared_bytes": [ctypes.POINTER(ctypes.c_int)],
            "stats_struct_sizes": [ctypes.POINTER(ctypes.c_int)]})
        sizes = (ctypes.c_int * 3)()
        lib.stats_struct_sizes(sizes)
        mine = [ctypes.sizeof(s) for s in (_StatsPlan, _BinnedParams,
                                           _JointParams)]
        if list(sizes) != mine:
            raise RuntimeError(f"stats_hist structs are {list(sizes)} bytes "
                               f"in the build, {mine} in ctypes")
        _LIB = lib
    return _LIB
