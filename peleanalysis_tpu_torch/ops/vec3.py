"""Float64 3-vector arithmetic in numpy's order of operations, on tensors
of any device: the MEF tools and the streamline post-processing compute
with these so that on the CPU they agree bitwise with the JAX package's
numpy, and on the card to the rounding of its scattered sums.

numpy reduces a length-3 axis as ((a + b) + c), forms ``np.cross`` from
single products and differences and takes a correctly rounded square
root.  The card's float64 sqrt is correctly rounded; PyTorch's vectorised
CPU sqrt is not always (about 1 value in 130 differs by one ulp on an
AVX-512 build), so on the CPU the root goes through numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of ``x`` on its device."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def sum3(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 3, as ((x0 + x1) + x2)."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.cross`` of 3-vectors [..., 3]."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def norm(x: torch.Tensor) -> torch.Tensor:
    """``np.linalg.norm(x, axis=-1)`` of 3-vectors."""
    return sqrt(sum3(x * x))


def triangle_areas(p0: torch.Tensor, p1: torch.Tensor,
                   p2: torch.Tensor) -> torch.Tensor:
    """Areas of 3-D triangles given their corners [..., 3]:
    0.5 |(p1 - p0) x (p2 - p0)|."""
    return 0.5 * norm(cross(p1 - p0, p2 - p0))
