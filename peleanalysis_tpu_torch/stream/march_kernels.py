"""RK4 streamline march: the hand-written CUDA kernel, its plain PyTorch
version, and the dispatcher every march of the stream tool goes through.

Counterpart of ``peleanalysis_tpu/stream/pallas_march.py`` (``march_pallas``,
``_round_kernel``) and of the XLA gather march ``_trace_level`` in
``peleanalysis_tpu/stream/trace.py``: both compute the same march, and so
do ``march_torch`` and the kernel ``csrc/stream_march.cu`` (built and bound
by ``ops/cuda_build.py``).  The TPU's resident-block design, which exists
because gathers are expensive on a TPU, is not carried over: the kernel
gathers each stage's 8 corners straight from device memory.

The field is component-minor, ``[SX, SY, SZ, 3]`` (``prepare_field``), so a
stencil's 8 corners are 4 runs of 6 contiguous values.  Positions and the
arithmetic are in the seeds' dtype (float64 or float32); the field is that
dtype, float32 under float64 positions (a float32 state, marched in float64
as the JAX package marches it with x64 on) or bfloat16, widened exactly
before any arithmetic.

``march`` sends a CPU tensor to ``march_torch`` and a CUDA tensor to the
kernel.  Nothing falls back: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_build

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

# corner order of the trilinear stencil (i, j, k offsets), as
# peleanalysis_tpu/stream/trace.py CORNER_OFFSETS_S
CORNER_OFFSETS_S = np.array(
    [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
     (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)], dtype=np.int64)

_NAME = "stream_march"
_LIB = None
_ENTRY = {(torch.float64, torch.float64): "stream_march_f64",
          (torch.float32, torch.float32): "stream_march_f32",
          (torch.float32, torch.float64): "stream_march_f32_f64",
          (torch.bfloat16, torch.float64): "stream_march_bf16_f64",
          (torch.bfloat16, torch.float32): "stream_march_bf16_f32"}


def prepare_field(vec: torch.Tensor,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[3, SX, SY, SZ]`` -> the march's contiguous ``[SX, SY, SZ, 3]``,
    stored in ``dtype`` (default: ``vec``'s)."""
    if vec.ndim != 4 or vec.shape[0] != 3:
        raise ValueError(f"vector field must be [3, SX, SY, SZ], not "
                         f"{tuple(vec.shape)}")
    return vec.permute(1, 2, 3, 0).to(dtype or vec.dtype).contiguous()


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=like.dtype, device=like.device)


def march_torch(field: torch.Tensor, plo: Sequence[float],
                dx: Sequence[float], h: float, seeds: torch.Tensor,
                n_steps: int, dirs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, vectorised over lines with a Python loop over steps:
    ``(pos [n_steps+1, N, 3], alive [N])`` in ``seeds``' dtype.  The
    operations and their order are the kernel's."""
    dt, dev = seeds.dtype, seeds.device
    SX, SY, SZ, _ = field.shape
    flat = field.reshape(-1, 3)
    plo_t = torch.tensor([float(v) for v in plo], dtype=dt, device=dev)
    dx_t = torch.tensor([float(v) for v in dx], dtype=dt, device=dev)
    hi = torch.tensor([SX - 2, SY - 2, SZ - 2], dtype=dt, device=dev)
    corner = torch.tensor([(o[0] * SY + o[1]) * SZ + o[2]
                           for o in CORNER_OFFSETS_S], device=dev)
    tiny = _const(torch.finfo(dt).tiny, seeds)
    h_half, h_t, h_sixth = (_const(v, seeds) for v in (0.5 * h, h, h / 6.0))
    dirs = dirs[:, None]

    def unit_vec(x):
        xc = (x - plo_t) / dx_t - 0.5
        b = torch.floor(xc)
        ok = ((b >= 0) & (b <= hi)).all(dim=1)
        b = torch.minimum(torch.clamp(b, min=0), hi)   # clamp before gather
        t = torch.clamp(xc - b, 0.0, 1.0)
        bi = b.long()
        base = (bi[:, 0] * SY + bi[:, 1]) * SZ + bi[:, 2]
        c = flat[base[:, None] + corner[None, :]].to(dt)        # [N, 8, 3]
        w1 = [[1 - t[:, d], t[:, d]] for d in range(3)]
        v = None
        for ci, (ox, oy, oz) in enumerate(CORNER_OFFSETS_S):
            w = (w1[0][ox] * w1[1][oy]) * w1[2][oz]
            term = c[:, ci] * w[:, None]
            v = term if v is None else v + term
        n = torch.sqrt((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1])
                       + v[:, 2] * v[:, 2])
        return dirs * v / torch.maximum(n, tiny)[:, None], ok

    x = seeds
    alive = torch.ones(seeds.shape[0], dtype=torch.bool, device=dev)
    out = torch.empty((n_steps + 1,) + tuple(seeds.shape), dtype=dt,
                      device=dev)
    out[0] = seeds
    for s in range(n_steps):
        k1, ok1 = unit_vec(x)
        k2, ok2 = unit_vec(x + h_half * k1)
        k3, ok3 = unit_vec(x + h_half * k2)
        k4, ok4 = unit_vec(x + h_t * k3)
        xn = x + h_sixth * (((k1 + 2 * k2) + 2 * k3) + k4)
        alive = alive & ok1 & ok2 & ok3 & ok4
        x = torch.where(alive[:, None], xn, x)    # freeze dead lines
        out[s + 1] = x
    return out, alive


def march(field: torch.Tensor, plo: Sequence[float], dx: Sequence[float],
          h: float, seeds: torch.Tensor, n_steps: int, dirs: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher: a CPU tensor takes ``march_torch``, a CUDA tensor the
    kernel.  seeds ``[N, 3]`` and dirs ``[N]`` (+-1) in the position dtype,
    float64 or float32; field ``[SX, SY, SZ, 3]`` (``prepare_field``) in
    that dtype, float32 under float64 positions, or bfloat16.  Returns
    ``(pos [n_steps+1, N, 3], alive [N] bool)``."""
    _check(field, plo, dx, seeds, n_steps, dirs)
    if seeds.device.type == "cpu":
        return march_torch(field, plo, dx, h, seeds, n_steps, dirs)
    if seeds.device.type != "cuda":
        raise ValueError(f"march runs on cpu or cuda, not {seeds.device}")
    return _launch(field, plo, dx, h, seeds, n_steps, dirs)


def _check(field, plo, dx, seeds, n_steps, dirs) -> None:
    if (field.dtype, seeds.dtype) not in _ENTRY:
        raise TypeError(f"march takes float64 or float32 positions with a "
                        f"field of that dtype, float32 (float64 positions) "
                        f"or bfloat16, not field {field.dtype} with "
                        f"positions {seeds.dtype}")
    if field.ndim != 4 or field.shape[3] != 3 or min(field.shape[:3]) < 2:
        raise ValueError(f"field must be [SX, SY, SZ, 3] with every S >= 2, "
                         f"not {tuple(field.shape)}")
    if seeds.ndim != 2 or seeds.shape[1] != 3:
        raise ValueError(f"seeds must be [N, 3], not {tuple(seeds.shape)}")
    if tuple(dirs.shape) != (seeds.shape[0],) or dirs.dtype != seeds.dtype:
        raise ValueError("dirs must be [N] in the seeds' dtype")
    if not (field.device == seeds.device == dirs.device):
        raise ValueError("field, seeds and dirs must share a device")
    if not (field.is_contiguous() and seeds.is_contiguous()
            and dirs.is_contiguous()):
        raise ValueError("march needs contiguous tensors")
    if len(plo) != 3 or len(dx) != 3 or n_steps < 0:
        raise ValueError("plo and dx need 3 entries and n_steps >= 0")


def _launch(field, plo, dx, h, seeds, n_steps, dirs):
    global LAUNCHES
    N = seeds.shape[0]
    out = torch.empty((n_steps + 1, N, 3), dtype=seeds.dtype,
                      device=seeds.device)
    alive = torch.empty(N, dtype=torch.bool, device=seeds.device)
    if N == 0:
        return out, alive
    fn = getattr(load_library(), _ENTRY[(field.dtype, seeds.dtype)])
    SX, SY, SZ, _ = field.shape
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream(seeds.device).cuda_stream
        err = fn(field.data_ptr(), seeds.data_ptr(), dirs.data_ptr(),
                 out.data_ptr(), alive.data_ptr(), N, n_steps, SX, SY, SZ,
                 *(float(v) for v in plo), *(float(v) for v in dx),
                 float(h), stream)
    if err != 0:
        raise RuntimeError(f"stream_march kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out, alive


def library_path():
    return cuda_build.library_path(_NAME)


def build(verbose: bool = False):
    """Compile ``csrc/stream_march.cu`` unless this source's build exists."""
    return cuda_build.build(_NAME, verbose)


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        sig = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5
               + [ctypes.c_double] * 7 + [ctypes.c_void_p])
        _LIB = cuda_build.load(_NAME, {name: sig for name in _ENTRY.values()})
    return _LIB
