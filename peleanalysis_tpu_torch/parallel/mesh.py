"""The device mesh of the port: which device holds each shard.

Counterpart of ``peleanalysis_tpu/parallel/mesh.py``.  A :class:`Mesh` is
a list of devices, one per shard, in row-major order over its block shape,
with one axis name per dimension of that shape ("x", "y", "z";
"clusters"; "parts").  Shards go round-robin over the cards of the run's
device type, so ``ndevices=4`` on one card makes four shards on it.  The
JAX package truncates instead (``jax.devices()[:n]``) and runs that request
unsharded on one chip; the outputs are the same either way.  On the CPU
every shard is on the CPU, as the JAX tests' eight virtual host devices
are.

The JAX ``shard_state`` / ``box_sharding`` lay out the batched-box model,
which the port does not have (its device model is the dense one,
``amr/dense.py``): they have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[s]`` holds shard s; shard s sits at
    ``np.unravel_index(s, shape)`` of the block grid."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if int(np.prod(self.shape)) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} != "
                             f"{len(self.devices)} devices")
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} do not match "
                             f"the shape {self.shape}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def index(self, s: int) -> Tuple[int, ...]:
        """Block-grid position of shard s."""
        return tuple(int(i) for i in np.unravel_index(s, self.shape))

    def shard(self, idx: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(idx), self.shape))


def shard_devices(n: int, device: Union[str, torch.device, None] = None):
    """n devices, round robin over the cards of ``device``'s type
    (``cuda``: every visible card; ``cpu``: the CPU n times)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        return (torch.device("cpu"),) * n
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (cuda|cpu)")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("shards on cuda requested but torch.cuda has no "
                           "device (pass device=cpu to run on the CPU)")
    return tuple(torch.device("cuda", i % count) for i in range(n))


def make_mesh(n: int, device, axis_names: Sequence[str],
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of n shards (``shard_devices``), 1-D over ``axis_names[0]``
    unless ``shape`` is given."""
    shape = (int(n),) if shape is None else tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(shard_devices(n, device), shape,
                tuple(axis_names)[: len(shape)])
