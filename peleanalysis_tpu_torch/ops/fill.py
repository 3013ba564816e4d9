"""Physical boundary-condition modes of the ghost fill.

Reference grad.cpp:136-144 builds Periodic / Neumann (-> foextrap ghost) /
reflect from ``is_per`` / ``sym_dir``; the dense fill (ops/dense_fill.py)
consumes these per-dimension, per-side modes.
"""
from __future__ import annotations

from typing import Tuple

FOEXTRAP = "foextrap"
REFLECT_EVEN = "reflect_even"
REFLECT_ODD = "reflect_odd"

BCSpec = Tuple[Tuple[str, str], ...]  # ((lo_mode, hi_mode) per dim)


def default_bc(ndim: int) -> BCSpec:
    return tuple((FOEXTRAP, FOEXTRAP) for _ in range(ndim))
