"""Plain PyTorch references of what the timed path produces.

They compute again from the same generated fields (``portbench.gen``) and
import nothing of the program.  Every function takes the ``dtype`` it
computes in: float64 for the reference, one precision below the
configuration's for the control (see ``lower``).
"""
from __future__ import annotations

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
# the nearest precision below each stated one
LOWER = {"float64": "float32", "float32": "bfloat16"}


def accumulate_dtype(dtype: torch.dtype) -> torch.dtype:
    """Sums of a bfloat16 computation accumulate in float32 and are
    rounded once, as PyTorch's own bfloat16 reductions do."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A sum accumulated in ``accumulate_dtype`` rounded to ``dtype``, and
    back to float64 for the comparison."""
    return x.to(dtype).to(torch.float64)
