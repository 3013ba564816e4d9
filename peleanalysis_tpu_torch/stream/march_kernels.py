"""RK4 streamline march: the hand-written CUDA kernel, its plain PyTorch
version, and the dispatcher every march of the stream tool goes through.

Counterpart of ``peleanalysis_tpu/stream/pallas_march.py`` (``march_pallas``,
``_round_kernel``) and of the XLA gather march ``_trace_level`` in
``peleanalysis_tpu/stream/trace.py``: both compute the same march, and so
do ``march_torch`` and the kernel ``csrc/stream_march.cu`` (built and bound
by ``ops/cuda_build.py``).  The TPU's resident-block design, which exists
because gathers are expensive on a TPU, is not carried over: the kernel
gathers each stage's 8 corners straight from device memory.

The field is component-minor, ``[SX, SY, SZ, C]`` (``prepare_field``): a
float32 or bfloat16 cell is padded with a zero 4th component so that the
kernel reads a corner in one aligned vector load, a float64 cell keeps its
3 (``COMPONENTS``); the plain version ignores the pad.  Positions and the
arithmetic are in the seeds' dtype (float64 or float32); the field is that
dtype, float32 under float64 positions (a float32 state, marched in float64
as the JAX package marches it with x64 on) or bfloat16, widened exactly
before any arithmetic.

On the card, the float64 variant (``ORDERED``) marches its lines in
locality order: ``order_key`` (a kernel of the same source) gives each line
the Morton code of its seed cell, ``torch.argsort`` sorts them, and the
kernel reads line ``order[i]`` and writes it at its own index, so the
result does not depend on the order.

``march`` sends a CPU tensor to ``march_torch`` and a CUDA tensor to the
kernel.  Nothing falls back: a failed build or launch raises.  Given
``origin=`` and ``shape=``, ``march`` marches over a window of a larger
volume (the migrating march of partStream, ``parallel/particles.py``):
every coordinate and bound is the whole volume's, so a line whose stencils
stay in the window computes what it computes in the whole volume, bit for
bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_build
from ..telemetry import count

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
# components a field cell holds, by field dtype: a float32 or bfloat16 cell
# is padded to one aligned vector load, a float64 cell is not (PERF.md)
COMPONENTS = {torch.float64: 3, torch.float32: 4, torch.bfloat16: 4}
# (field dtype, position dtype) of the variants whose lines the kernel
# marches in locality order, sorted by ``order_key``: the float64 field, the
# one whose 24-byte gathers bound the kernel.  Under float64 arithmetic over
# a float32 or bfloat16 field the float64 pipe bounds it, and there the sort
# would only add its cost (PERF.md).
ORDERED = {(torch.float64, torch.float64)}
_KEY = "stream_march_key_f64"


def prepare_field(vec: torch.Tensor,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[3, SX, SY, SZ]`` -> the march's contiguous ``[SX, SY, SZ, C]``
    stored in ``dtype`` (default: ``vec``'s): C = 3 in float64, 4 with a
    zero component 3 in float32 and bfloat16 (``COMPONENTS``)."""
    if vec.ndim != 4 or vec.shape[0] != 3:
        raise ValueError(f"vector field must be [3, SX, SY, SZ], not "
                         f"{tuple(vec.shape)}")
    dtype = dtype or vec.dtype
    field = torch.zeros(tuple(vec.shape[1:]) + (COMPONENTS.get(dtype, 3),),
                        dtype=dtype, device=vec.device)
    field[..., :3] = vec.permute(1, 2, 3, 0)
    return field


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=like.dtype, device=like.device)


def march_torch(field: torch.Tensor, plo: Sequence[float],
                dx: Sequence[float], h: float, seeds: torch.Tensor,
                n_steps: int, dirs: torch.Tensor,
                origin: Sequence[int] = (0, 0, 0),
                shape: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, vectorised over lines with a Python loop over steps:
    ``(pos [n_steps+1, N, 3], alive [N])`` in ``seeds``' dtype.  The
    operations and their order are the kernel's.  ``field`` may be a window
    at ``origin`` of a volume of ``shape`` cells (``march``)."""
    dt, dev = seeds.dtype, seeds.device
    LX, SY, SZ, _ = field.shape
    SX, GY, GZ = shape if shape is not None else (LX, SY, SZ)
    flat = field.reshape(-1, field.shape[3])[:, :3]
    plo_t = torch.tensor([float(v) for v in plo], dtype=dt, device=dev)
    dx_t = torch.tensor([float(v) for v in dx], dtype=dt, device=dev)
    hi = torch.tensor([SX - 2, GY - 2, GZ - 2], dtype=dt, device=dev)
    org = torch.tensor([int(v) for v in origin], device=dev)
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
        bi = b.long() - org
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
          h: float, seeds: torch.Tensor, n_steps: int, dirs: torch.Tensor,
          origin: Sequence[int] = (0, 0, 0),
          shape: Optional[Sequence[int]] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher: a CPU tensor takes ``march_torch``, a CUDA tensor the
    kernel.  seeds ``[N, 3]`` and dirs ``[N]`` (+-1) in the position dtype,
    float64 or float32; field ``[SX, SY, SZ, C]`` (``prepare_field``) in
    that dtype, float32 under float64 positions, or bfloat16.  Returns
    ``(pos [n_steps+1, N, 3], alive [N] bool)``.

    With ``shape``, ``field`` is a window of a volume of ``shape`` cells
    whose lower corner is at ``plo``: it holds the cells ``origin`` ..
    ``origin + L - 1``.  Each line's stencils must stay in the window while
    it is alive (the caller's halo); a line frozen outside the volume is
    clamped into it, so the window must reach the volume's edge wherever a
    line can leave it."""
    _check(field, plo, dx, seeds, n_steps, dirs)
    origin = tuple(int(v) for v in origin)
    shape = tuple(int(v) for v in (shape or field.shape[:3]))
    for d in range(3):
        if not (0 <= origin[d] and origin[d] + field.shape[d] <= shape[d]):
            raise ValueError(f"window at {origin} of {tuple(field.shape[:3])}"
                             f" cells is not inside the volume {shape}")
    if seeds.device.type == "cpu":
        return march_torch(field, plo, dx, h, seeds, n_steps, dirs, origin,
                           shape)
    if seeds.device.type != "cuda":
        raise ValueError(f"march runs on cpu or cuda, not {seeds.device}")
    LY, LZ, C = field.shape[1:]
    if ((shape[0] - 1) * LY * LZ + (shape[1] - 1) * LZ + shape[2]) * C \
            >= 2 ** 31:
        raise ValueError(f"a window of a volume of {shape} cells: the "
                         "kernel's 32-bit offsets take fewer than 2**31 "
                         "elements")
    return _launch(field, plo, dx, h, seeds, n_steps, dirs, shape, origin)


def _check(field, plo, dx, seeds, n_steps, dirs) -> None:
    if (field.dtype, seeds.dtype) not in _ENTRY:
        raise TypeError(f"march takes float64 or float32 positions with a "
                        f"field of that dtype, float32 (float64 positions) "
                        f"or bfloat16, not field {field.dtype} with "
                        f"positions {seeds.dtype}")
    C = COMPONENTS[field.dtype]
    if field.ndim != 4 or field.shape[3] != C or min(field.shape[:3]) < 2:
        raise ValueError(f"a {field.dtype} field must be [SX, SY, SZ, {C}] "
                         f"(prepare_field) with every S >= 2, not "
                         f"{tuple(field.shape)}")
    if field.numel() >= 2 ** 31:
        raise ValueError(f"field of {field.numel()} elements: the kernel's "
                         f"32-bit offsets take fewer than 2**31")
    if seeds.ndim != 2 or seeds.shape[1] != 3:
        raise ValueError(f"seeds must be [N, 3], not {tuple(seeds.shape)}")
    if tuple(dirs.shape) != (seeds.shape[0],) or dirs.dtype != seeds.dtype:
        raise ValueError("dirs must be [N] in the seeds' dtype")
    if not (field.device == seeds.device == dirs.device):
        raise ValueError("field, seeds and dirs must share a device")
    if not (field.is_contiguous() and seeds.is_contiguous()
            and dirs.is_contiguous()):
        raise ValueError("march needs contiguous tensors")
    if field.data_ptr() % 16:
        raise ValueError("the field must start on a 16-byte boundary (the "
                         "kernel's vector loads)")
    if len(plo) != 3 or len(dx) != 3 or n_steps < 0:
        raise ValueError("plo and dx need 3 entries and n_steps >= 0")


def _launch(field, plo, dx, h, seeds, n_steps, dirs, shape, origin):
    N = seeds.shape[0]
    out = torch.empty((n_steps + 1, N, 3), dtype=seeds.dtype,
                      device=seeds.device)
    alive = torch.empty(N, dtype=torch.bool, device=seeds.device)
    if N == 0:
        return out, alive
    fn = getattr(load_library(), _ENTRY[(field.dtype, seeds.dtype)])
    order = None
    if (field.dtype, seeds.dtype) in ORDERED:
        # the kernel reads line order[i] and writes it at its own index
        order = torch.argsort(order_key(shape, plo, dx, seeds, dirs))
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream(seeds.device).cuda_stream
        err = fn(field.data_ptr(), seeds.data_ptr(), dirs.data_ptr(),
                 None if order is None else order.data_ptr(),
                 out.data_ptr(), alive.data_ptr(), N, n_steps, *shape,
                 field.shape[1], field.shape[2], *origin,
                 *(float(v) for v in plo), *(float(v) for v in dx),
                 float(h), stream)
    if err != 0:
        raise RuntimeError(f"stream_march kernel launch failed: "
                           f"cudaError {err}")
    count("kernel.march")
    return out, alive


def _order_shift(shape: Sequence[int]) -> int:
    """Right shift of the base cell index that fits the largest into the
    10 bits a dimension of the order key."""
    return max(0, (max(shape) - 2).bit_length() - 10)


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of ``v`` (int32) onto every third bit of 30."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def order_key_torch(shape: Sequence[int], plo: Sequence[float],
                    dx: Sequence[float], seeds: torch.Tensor,
                    dirs: torch.Tensor) -> torch.Tensor:
    """Plain version of the order key: the Morton code of each seed's
    clamped base cell (the march's own arithmetic), shifted right by
    ``_order_shift``, with bit 30 set for a negative direction.  Sorted, it
    puts lines that start in neighbouring cells and go the same way next to
    each other.  int32 ``[N]``."""
    dt, dev = seeds.dtype, seeds.device
    plo_t = torch.tensor([float(v) for v in plo], dtype=dt, device=dev)
    dx_t = torch.tensor([float(v) for v in dx], dtype=dt, device=dev)
    hi = torch.tensor([s - 2 for s in shape], dtype=dt, device=dev)
    xc = (seeds - plo_t) / dx_t - 0.5
    b = torch.minimum(torch.clamp(torch.floor(xc), min=0), hi)
    b = b.to(torch.int32) >> _order_shift(shape)
    return (_spread3(b[:, 0]) | (_spread3(b[:, 1]) << 1)
            | (_spread3(b[:, 2]) << 2) | ((dirs < 0).to(torch.int32) << 30))


def order_key(shape: Sequence[int], plo: Sequence[float],
              dx: Sequence[float], seeds: torch.Tensor,
              dirs: torch.Tensor) -> torch.Tensor:
    """Dispatcher of the order key of float64 positions (the ``ORDERED``
    march): ``order_key_torch`` for a CPU tensor, the kernel
    ``stream_march_key_f64`` for a CUDA tensor."""
    if seeds.dtype != torch.float64 or dirs.dtype != torch.float64:
        raise TypeError(f"the order key takes float64 seeds and dirs, not "
                        f"{seeds.dtype} and {dirs.dtype}")
    if seeds.device.type == "cpu":
        return order_key_torch(shape, plo, dx, seeds, dirs)
    if seeds.device.type != "cuda":
        raise ValueError(f"order_key runs on cpu or cuda, not {seeds.device}")
    N = seeds.shape[0]
    key = torch.empty(N, dtype=torch.int32, device=seeds.device)
    if N == 0:
        return key
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream(seeds.device).cuda_stream
        err = getattr(load_library(), _KEY)(
            seeds.data_ptr(), dirs.data_ptr(), key.data_ptr(), N, *shape,
            *(float(v) for v in plo), *(float(v) for v in dx),
            _order_shift(shape), stream)
    if err != 0:
        raise RuntimeError(f"stream_march order key launch failed: "
                           f"cudaError {err}")
    count("kernel.order_key")
    return key


def library_path():
    return cuda_build.library_path(_NAME)


def build(verbose: bool = False):
    """Compile ``csrc/stream_march.cu`` unless this source's build exists."""
    return cuda_build.build(_NAME, verbose)


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        sig = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 10
               + [ctypes.c_double] * 7 + [ctypes.c_void_p])
        key_sig = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4
                   + [ctypes.c_double] * 6 + [ctypes.c_int, ctypes.c_void_p])
        sigs = {name: sig for name in _ENTRY.values()}
        sigs[_KEY] = key_sig
        sigs.update({f"{name}_report": [ctypes.c_void_p]
                     for name in _ENTRY.values()})
        _LIB = cuda_build.load(_NAME, sigs)
    return _LIB


def kernel_report(field_dtype: torch.dtype, dtype: torch.dtype) -> dict:
    """Registers and local (spill) bytes per thread, threads per block and
    resident blocks per SM of one variant, as the card reports them."""
    vals = (ctypes.c_int * 4)()
    fn = getattr(load_library(), f"{_ENTRY[(field_dtype, dtype)]}_report")
    err = fn(ctypes.addressof(vals))
    if err != 0:
        raise RuntimeError(f"stream_march report failed: cudaError {err}")
    return dict(zip(("registers", "local_bytes", "threads_per_block",
                     "blocks_per_sm"), vals))
