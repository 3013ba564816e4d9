"""The explicit ring halo exchange, and the gradient over shards with it.

Counterpart of ``peleanalysis_tpu/parallel/halo.py`` (``shard_map`` +
``ppermute``).  Shards are a list of per-shard ``[C, X, Y, Z]`` tensors,
each on its own device, in the row-major order of a ``Mesh`` whose axes
name the spatial dims they cut.  ``halo_exchange`` grows every shard of a
ring by g planes a side from its neighbours, wrapping at the ends as
``ppermute`` does (callers overwrite the physical-BC layers of the
outermost shards); a plane moves with one ``.to(device)``.  ``halo_grad``
exchanges one plane along each cut dim, applies the first-order
extrapolation of the outermost shards (grad.cpp:136-144's default) and
runs the ``grad_mag`` kernel (``ops/grad_kernels.py``; the plain version on
CPU tensors) on each grown shard: the global gradient, shard by shard.
The tools window their shards instead (``dense_shard.py``); this is the
building block of a halo update between the windows of an iterative
solve (ROADMAP.md Queue 1 item 9b).  No tool calls this module yet:
``halo_grad_x`` (the JAX X-slab form), ``split_blocks`` and
``join_blocks`` serve the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.grad_kernels import grad_mag
from .mesh import Mesh


def _planes(t: torch.Tensor, dim: int, sl: slice) -> torch.Tensor:
    idx = [slice(None)] * t.ndim
    idx[t.ndim - 3 + dim] = sl
    return t[tuple(idx)]


def halo_exchange(shards: Sequence[torch.Tensor], g: int,
                  dim: int) -> List[torch.Tensor]:
    """Each shard of the ring grown by g planes a side along spatial dim
    ``dim``: its left neighbour's last g planes before it, its right
    neighbour's first g after it (the ends wrap round)."""
    n = len(shards)
    out = []
    for i, t in enumerate(shards):
        lo = _planes(shards[(i - 1) % n], dim, slice(-g, None)).to(t.device)
        hi = _planes(shards[(i + 1) % n], dim, slice(0, g)).to(t.device)
        out.append(torch.cat([lo, t, hi], dim=t.ndim - 3 + dim))
    return out


def _rings(mesh: Mesh, axis: int):
    """Shard indices of each ring along mesh axis ``axis``, in order."""
    rings = {}
    for s in range(mesh.size):
        idx = list(mesh.index(s))
        idx[axis] = 0
        rings.setdefault(tuple(idx), []).append(s)
    return list(rings.values())


def _edge_pad(t: torch.Tensor, dim: int) -> torch.Tensor:
    ax = t.ndim - 3 + dim
    return torch.cat([_planes(t, dim, slice(0, 1)), t,
                      _planes(t, dim, slice(-1, None))], dim=ax)


def halo_grad(shards: Sequence[torch.Tensor], dx, mesh: Mesh,
              axis_specs: Sequence[Optional[str]]) -> List[torch.Tensor]:
    """Gradient + |grad| of a ``[1, X, Y, Z]`` field cut over ``mesh``:
    ``axis_specs[d]`` names the mesh axis that cuts spatial dim d, or None.
    Non-periodic boundaries extrapolate to first order.  Returns each
    shard's ``[4, x, y, z]`` (gx, gy, gz, |grad|), on its device."""
    grown = [t for t in shards]
    for d in range(3):
        name = axis_specs[d]
        if name is None:
            grown = [_edge_pad(t, d) for t in grown]
            continue
        axis = mesh.axis_names.index(name)
        for ring in _rings(mesh, axis):
            ext = halo_exchange([grown[s] for s in ring], 1, d)
            # the physical BC (foextrap) on the outermost shards
            ext[0] = torch.cat([_planes(ext[0], d, slice(1, 2)),
                                _planes(ext[0], d, slice(1, None))],
                               dim=ext[0].ndim - 3 + d)
            ext[-1] = torch.cat([_planes(ext[-1], d, slice(0, -1)),
                                 _planes(ext[-1], d, slice(-2, -1))],
                                dim=ext[-1].ndim - 3 + d)
            for s, t in zip(ring, ext):
                grown[s] = t
    return [grad_mag(t.contiguous(), dx, with_mag=True) for t in grown]


def halo_grad_x(shards: Sequence[torch.Tensor], dx, mesh: Mesh,
                axis_name: str = "x") -> List[torch.Tensor]:
    """``halo_grad`` of X slabs: one exchange along x, edge pads in y and
    z."""
    return halo_grad(shards, dx, mesh, (axis_name, None, None))


def split_blocks(arr: torch.Tensor, mesh: Mesh,
                 axis_specs: Sequence[Optional[str]]) -> List[torch.Tensor]:
    """A ``[C, X, Y, Z]`` tensor cut into the mesh's blocks (near-equal
    parts along each cut dim), each copied to its shard's device."""
    bounds = []
    for d in range(3):
        name = axis_specs[d]
        n = 1 if name is None else mesh.shape[mesh.axis_names.index(name)]
        cuts = np.linspace(0, arr.shape[1 + d], n + 1).round().astype(int)
        bounds.append(cuts)
    out = []
    for s in range(mesh.size):
        idx = mesh.index(s)
        sl = [slice(None)]
        for d in range(3):
            name = axis_specs[d]
            i = 0 if name is None else idx[mesh.axis_names.index(name)]
            sl.append(slice(int(bounds[d][i]), int(bounds[d][i + 1])))
        out.append(arr[tuple(sl)].to(mesh.devices[s]))
    return out


def join_blocks(shards: Sequence[torch.Tensor], mesh: Mesh,
                axis_specs: Sequence[Optional[str]],
                device=None) -> torch.Tensor:
    """The inverse of ``split_blocks``, on ``device`` (the first shard's by
    default)."""
    device = shards[0].device if device is None else device
    pieces = [t.to(device) for t in shards]
    # concatenate along the mesh's axes from the last to the first
    shape = list(mesh.shape)
    arr = np.empty(mesh.size, dtype=object)
    for s in range(mesh.size):
        arr[s] = pieces[s]
    arr = arr.reshape(shape)
    for axis in range(len(shape) - 1, -1, -1):
        d = next(d for d in range(3) if axis_specs[d] == mesh.axis_names[axis])
        red = np.empty(arr.shape[:axis] + arr.shape[axis + 1:], dtype=object)
        for idx in np.ndindex(*red.shape):
            parts = [arr[idx[:axis] + (i,) + idx[axis:]]
                     for i in range(arr.shape[axis])]
            red[idx] = torch.cat(parts, dim=1 + d)
        arr = red
    return arr.item() if isinstance(arr, np.ndarray) else arr
