"""Global compute configuration of the PyTorch port.

Plotfiles store float64; compute defaults to float32, with float64 on the
CLI's ``dtype=float64``.  Tensors always carry an explicit device: there is
no global default device, and ``get_device`` refuses a CUDA device that is
not there instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch

compute_dtype = torch.float32

# full-precision float32 products everywhere (TF32 keeps ~3 digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def set_compute_dtype(dtype: torch.dtype) -> None:
    global compute_dtype
    compute_dtype = dtype


def get_device(name: str = "cuda") -> torch.device:
    """``cuda`` (or ``cuda:N``) only when a card is present, else raise;
    ``cpu`` runs every op on its plain PyTorch version."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={name} requested but torch.cuda is not "
                           "available (pass device=cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda|cpu)")
    return dev
