"""Gradient + magnitude: the hand-written CUDA kernel, its plain PyTorch
version, and the dispatcher every gradient of the grad and curvature tools
goes through.

Counterpart of ``peleanalysis_tpu/ops/pallas_kernels.py`` (``grad_mag``,
``grad_mag_pallas``, ``_grad_mag_kernel``).  The kernel source is
``csrc/grad_mag.cu``; ``ops/cuda_build.py`` compiles it with ``nvcc`` on
first use and binds its plain C entry points with ``ctypes``.

``grad_mag`` sends a CPU tensor to ``grad_mag_torch`` and a CUDA tensor to
the kernel.  Nothing falls back: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence

import torch

from . import cuda_build
from .cuda_build import BUILD_DIR, NVCC_FLAGS  # noqa: F401 (public names)
from ..telemetry import count
from .stencil import centered_gradient, magnitude

_NAME = "grad_mag"
_LIB = None


def grad_mag_torch(grown: torch.Tensor, dx: Sequence[float],
                   with_mag: bool = True) -> torch.Tensor:
    """Plain version: grown [X+2, Y+2, Z+2] (or [1, X+2, Y+2, Z+2]) ->
    [4, X, Y, Z] (gx, gy, gz, |grad|), or [3, X, Y, Z] without the
    magnitude."""
    gx, gy, gz = centered_gradient(grown.reshape(grown.shape[-3:]), dx, 1)
    comps = [gx, gy, gz]
    if with_mag:
        comps.append(magnitude(gx, gy, gz))
    return torch.stack(comps)


def grad_mag(grown: torch.Tensor, dx: Sequence[float],
             with_mag: bool = True) -> torch.Tensor:
    """Dispatcher: a CPU tensor takes ``grad_mag_torch``, a CUDA tensor the
    kernel.  Same shapes and results as ``grad_mag_torch``."""
    if grown.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"grad_mag takes float32 or float64, not {grown.dtype}")
    if grown.ndim not in (3, 4) or (grown.ndim == 4 and grown.shape[0] != 1):
        raise ValueError("grad_mag takes [X+2, Y+2, Z+2] or [1, X+2, Y+2, Z+2], "
                         f"not {tuple(grown.shape)}")
    if min(grown.shape[-3:]) < 3:
        raise ValueError(f"grown shape {tuple(grown.shape)} has no interior cell")
    if not grown.is_contiguous():
        raise ValueError("grad_mag needs a contiguous tensor")
    if len(dx) != 3:
        raise ValueError(f"dx needs 3 entries, got {len(dx)}")
    if grown.device.type == "cpu":
        return grad_mag_torch(grown, dx, with_mag)
    if grown.device.type != "cuda":
        raise ValueError(f"grad_mag runs on cpu or cuda, not {grown.device}")
    return _launch(grown, dx, with_mag)


def _launch(grown: torch.Tensor, dx: Sequence[float],
            with_mag: bool) -> torch.Tensor:
    X, Y, Z = (s - 2 for s in grown.shape[-3:])
    if X > 65535 or (Y + 7) // 8 > 65535:
        raise ValueError(f"grid too large for the kernel's launch: {(X, Y, Z)}")
    out = torch.empty((4 if with_mag else 3, X, Y, Z), dtype=grown.dtype,
                      device=grown.device)
    lib = load_library()
    fn = lib.grad_mag_f32 if grown.dtype == torch.float32 else lib.grad_mag_f64
    with torch.cuda.device(grown.device):
        stream = torch.cuda.current_stream(grown.device).cuda_stream
        err = fn(grown.data_ptr(), out.data_ptr(), X, Y, Z,
                 2.0 * float(dx[0]), 2.0 * float(dx[1]), 2.0 * float(dx[2]),
                 int(bool(with_mag)), stream)
    if err != 0:
        raise RuntimeError(f"grad_mag kernel launch failed: cudaError {err}")
    # a run shows its gradients went through the kernel by this counter
    count("kernel.grad_mag")
    return out


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return cuda_build.library_path(_NAME)


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/grad_mag.cu`` unless this source's build exists."""
    return cuda_build.build(_NAME, verbose)


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        sig = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
               ctypes.c_double, ctypes.c_double, ctypes.c_int,
               ctypes.c_void_p]
        _LIB = cuda_build.load(_NAME, {"grad_mag_f32": sig,
                                       "grad_mag_f64": sig})
    return _LIB
