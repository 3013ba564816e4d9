"""AMReX native FAB ("FArrayBox") binary record I/O.

The on-disk record is an ASCII header line describing the real-number format
and the index-space box, followed by raw floating-point data in Fortran order
(first index fastest) with components outermost.  Format reverse-documented
from the reference's own python parser (PeleAnalysis Src/PythonScripts/
mef2vtk.py:11-23) and the AMReX IO docs cited in Docs/source/data.rst.
"""
from __future__ import annotations

import re
from typing import BinaryIO, Tuple

import numpy as np

from ..amr.box import Box

# Native-format descriptors AMReX writes for IEEE doubles / floats.
_FAB_HEADER_F64 = "FAB ((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1)))"
# (byte count 4 — AMReX FPC::Native32RealDescriptor; writing 8 here would
# make the reference's own reader mis-stride the payload)
_FAB_HEADER_F32 = "FAB ((4, (32 8 23 0 1 9 0 127)),(4, (4 3 2 1)))"

_BOX_RE = re.compile(r"\(\(([-\d,]+)\)\s*\(([-\d,]+)\)\s*\(([-\d,]+)\)\)\s*(\d+)\s*$")

# Full RealDescriptor: ((nbytes, (bit-format ...)), (nbytes, (byte-order ...)))
# AMReX FPC byte orders: ascending (1 2 .. n) = big-endian "normal order",
# descending (n .. 2 1) = little-endian "reverse order" (x86 native).
_DESC_RE = re.compile(
    r"FAB \(\((\d+), \(([\d\s]+)\)\),\((\d+), \(([\d\s]+)\)\)\)")


def _dtype_from_header(header: str) -> np.dtype:
    m = _DESC_RE.match(header)
    if m is None:
        raise ValueError(f"unsupported FAB real descriptor: {header!r}")
    nbytes = int(m.group(1))
    fmt = [int(x) for x in m.group(2).split()]
    order = [int(x) for x in m.group(4).split()]
    # IEEE layouts only: (nbits exp mant ...) must match float32/float64
    if nbytes == 8 and fmt[:3] == [64, 11, 52]:
        kind = "f8"
    elif nbytes == 4 and fmt[:3] == [32, 8, 23]:
        kind = "f4"
    else:
        raise ValueError(f"non-IEEE FAB real descriptor: {header!r}")
    if order == list(range(nbytes, 0, -1)):
        return np.dtype("<" + kind)
    if order == list(range(1, nbytes + 1)):
        return np.dtype(">" + kind)
    raise ValueError(f"unsupported FAB byte order {order} in {header!r}")


def read_fab_header(f: BinaryIO) -> Tuple[Box, int, np.dtype]:
    """Read the ASCII FAB header line; returns (box, ncomp, dtype)."""
    line = f.readline().decode("ascii")
    m = _BOX_RE.search(line)
    if m is None:
        raise ValueError(f"bad FAB header: {line!r}")
    lo = tuple(int(x) for x in m.group(1).split(","))
    hi = tuple(int(x) for x in m.group(2).split(","))
    ncomp = int(m.group(4))
    return Box(lo, hi), ncomp, _dtype_from_header(line)


def read_fab(f: BinaryIO) -> Tuple[Box, np.ndarray]:
    """Read one FAB record.  Returns (box, data[ncomp, *shape_c_order]).

    On disk the data is Fortran ordered (x fastest) per component; we return
    a C-ordered array indexed ``[comp, i, j, k]`` (i = x index).
    """
    box, ncomp, dtype = read_fab_header(f)
    shape = box.shape
    count = int(np.prod(shape)) * ncomp
    raw = np.fromfile(f, dtype=dtype, count=count)
    if raw.size != count:
        raise EOFError("truncated FAB data")
    raw = np.ascontiguousarray(raw, dtype=dtype.newbyteorder("="))
    # file layout: comp outermost, then z, y, x (x fastest)
    data = raw.reshape((ncomp,) + shape[::-1])
    # -> [comp, x, y, z]
    axes = (0,) + tuple(range(len(shape), 0, -1))
    return box, np.transpose(data, axes)


def fab_header_str(box: Box, ncomp: int, dtype=np.float64) -> bytes:
    dt = np.dtype(dtype)
    if dt == np.float64:
        desc = _FAB_HEADER_F64
    elif dt == np.float32:
        desc = _FAB_HEADER_F32
    else:
        raise ValueError(f"unsupported FAB dtype {dt}")
    return (desc + repr(box) + f" {ncomp}\n").encode("ascii")


def write_fab(f: BinaryIO, box: Box, data: np.ndarray, dtype=np.float64) -> None:
    """Write one FAB record from a C-ordered array ``[comp, i, j, k]``."""
    ncomp = data.shape[0]
    if tuple(data.shape[1:]) != box.shape:
        raise ValueError(f"data shape {data.shape[1:]} != box shape {box.shape}")
    f.write(fab_header_str(box, ncomp, dtype))
    ndim = box.ndim
    axes = (0,) + tuple(range(ndim, 0, -1))  # [comp, k, j, i]
    np.ascontiguousarray(np.transpose(data, axes), dtype=dtype).tofile(f)


def write_raw_node_fab(f: BinaryIO, data: np.ndarray, dtype=np.float64) -> None:
    """Write the MEF node FAB: header claims box (0:N-1,0,0) x nfields, but the
    payload is node-major [N, nfields] C order — matching the reference writer
    (PeleAnalysis Src/isosurface.cpp:2000-2010, mef2vtk.py:40-45)."""
    n, nfields = data.shape
    box = Box((0, 0, 0), (n - 1, 0, 0))
    f.write(fab_header_str(box, nfields, dtype))
    np.ascontiguousarray(data, dtype=dtype).tofile(f)


def read_raw_node_fab(f: BinaryIO) -> np.ndarray:
    """Read an MEF node FAB written by write_raw_node_fab (node-major)."""
    box, ncomp, dtype = read_fab_header(f)
    n = box.shape[0]
    raw = np.fromfile(f, dtype=dtype, count=n * ncomp)
    if raw.size != n * ncomp:
        raise EOFError("truncated MEF node FAB")
    return np.ascontiguousarray(raw, dtype=dtype.newbyteorder("=")).reshape(
        n, ncomp)
