"""Build and load the port's CUDA kernels: one ``nvcc`` path for every
``csrc/*.cu`` source.

Each source compiles on first use into a shared library with a plain C
interface under ``build/peleanalysis_tpu_torch/`` at the repository root,
named by the hash of the source and the flags (an edited source rebuilds),
and is loaded with ``ctypes``.  Nothing here runs at import time, so the
CPU-only tests import every module without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "peleanalysis_tpu_torch"
# --fmad=false: no multiply-add contraction, so a kernel rounds like its
# plain PyTorch version (one rounding per operation)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` with the current flags lives."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError("nvcc not found on PATH or under CUDA_HOME; "
                                "the port's CUDA kernels need the CUDA toolkit")
    return path


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source's build exists.
    ``verbose`` prints nvcc's report (registers, spills) to stderr."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, file=sys.stderr)
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` (built if needed), with each entry
    point of ``signatures`` given its ``argtypes`` and an ``int`` return
    (the launch's cudaError_t, 0 on success).  Callers keep the handle."""
    lib = ctypes.CDLL(str(build(name)))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
