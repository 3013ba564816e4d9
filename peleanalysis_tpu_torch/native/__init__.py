"""Native (C++) host code of the port, loaded through ``ctypes``: the
parallel VisMF/FAB loader (``vismf_io.cpp``, ``load_fabs``), the
snprintf text formatter (``fmt.cpp``: ``tecplot_zones``, ``format_g_rows``,
``format_i_rows``) and the quadric-error mesh decimation of decimateMEF
(``qem.cpp``, ``qem_decimate``).

Copies of ``peleanalysis_tpu/native``, so the port reads, writes and
decimates to the same bytes without importing the JAX package.  The
sources compile with g++ on first use into one shared
library under ``build/peleanalysis_tpu_torch/`` at the repository root,
named by the hash of the sources and the flags; nothing runs at import
time.  A failed build raises: there is no pure-Python fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import io
import os
import re
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops.cuda_build import BUILD_DIR

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("qem.cpp", "vismf_io.cpp", "fmt.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# load_fabs never starts more threads than this
MAX_THREADS = 16

_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    """Where the build of the current sources with the current flags
    lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libpele_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless this build exists.  The output is
    written under a temporary name and renamed, so processes that build
    at once never load half a file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, *(str(SRC_DIR / s) for s in SOURCES),
           "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed (rc {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The native library, built and loaded on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.qem_decimate.restype = ctypes.c_int
            lib.qem_decimate.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                ctypes.c_int, ctypes.c_double,
                ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_double,
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                np.ctypeslib.ndpointer(np.int32, flags="C"),
            ]
            lib.load_fabs.restype = ctypes.c_int
            lib.load_fabs.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                np.ctypeslib.ndpointer(np.int64, flags="C"),
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int, ctypes.c_int,
            ]
            lib.tecplot_zones.restype = ctypes.c_long
            lib.tecplot_zones.argtypes = [
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_long]
            lib.format_g_rows.restype = ctypes.c_long
            lib.format_g_rows.argtypes = [
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                ctypes.c_long, ctypes.c_long, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_long]
            lib.format_i_rows.restype = ctypes.c_long
            lib.format_i_rows.argtypes = [
                np.ctypeslib.ndpointer(np.int64, flags="C"),
                ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_long]
            _LIB = lib
    return _LIB


def _text(fill, cap: int, what: str) -> bytes:
    """Run ``fill(buffer_address, cap)``, which returns the bytes it wrote
    (negative on overflow), on an uninitialised buffer of ``cap`` bytes;
    only the bytes written are copied out."""
    buf = np.empty(cap, np.uint8)
    n = fill(buf.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"{what}: buffer overflow")
    return buf[:n].tobytes()


def tecplot_zones(lines: np.ndarray) -> bytes:
    """Format [nlines, st, ncols] float64 stations as per-line Tecplot
    zones: a ``ZONE T="line<i>" I=<st> DATAPACKING=POINT`` header and st
    rows of ``%.9g`` values each."""
    lib = get_lib()
    nl, st, nc = lines.shape
    lines = np.ascontiguousarray(lines, np.float64)
    return _text(lambda p, cap: lib.tecplot_zones(lines, nl, st, nc, p, cap),
                 nl * (96 + st * (nc * 32 + 1)) + 64, "tecplot_zones")


def _rows(arr: np.ndarray, dtype) -> np.ndarray:
    rows = np.ascontiguousarray(arr, dtype)
    if rows.ndim == 1:
        rows = rows[:, None]
    if rows.ndim != 2:
        raise ValueError(f"rows must be 1-D or 2-D, got shape {rows.shape}")
    return rows


def format_g_rows(rows: np.ndarray, prec: int = 9) -> bytes:
    """Format [nrows, ncols] float64 as ``%.<prec>g`` space-separated
    lines."""
    lib = get_lib()
    rows = _rows(rows, np.float64)
    nr, nc = rows.shape
    return _text(lambda p, cap: lib.format_g_rows(rows, nr, nc, int(prec),
                                                  p, cap),
                 nr * (nc * 40 + 1) + 64, "format_g_rows")


def format_i_rows(rows: np.ndarray) -> bytes:
    """Format [nrows, ncols] integers as ``%d`` space-separated lines."""
    lib = get_lib()
    rows = _rows(rows, np.int64)
    nr, nc = rows.shape
    return _text(lambda p, cap: lib.format_i_rows(rows, nr, nc, p, cap),
                 nr * (nc * 24 + 1) + 64, "format_i_rows")


def savetxt_fast(f, arr: np.ndarray, fmt: str = "%.9g") -> None:
    """``np.savetxt(f, arr, fmt=fmt)`` for the text writers: ``%.<N>g``
    floats and ``%d`` integers go through the native formatter (the same
    text, apart from the sign of a NaN, see fmt.cpp); other formats go to
    ``np.savetxt``.  ``f`` is a binary or a text file object."""
    arr = np.asarray(arr)
    m = re.fullmatch(r"%\.(\d+)g", fmt)
    if m:
        body = format_g_rows(arr.astype(np.float64, copy=False),
                             int(m.group(1)))
    elif fmt == "%d":
        body = format_i_rows(arr)
    else:
        np.savetxt(f, arr, fmt=fmt)
        return
    f.write(body.decode() if isinstance(f, io.TextIOBase) else body)


def loader_threads() -> int:
    """Threads ``load_fabs`` starts: the CPUs this process may run on, at
    most MAX_THREADS."""
    return max(1, min(len(os.sched_getaffinity(0)), MAX_THREADS))


def load_fabs(paths, offsets, dims, sel, itemsize: int, dests) -> None:
    """Read many FAB records concurrently, on ``loader_threads()`` threads
    (see the ABI in vismf_io.cpp).

    paths: list of FAB file paths; offsets: the records' byte offsets;
    dims: [n, 3] box sizes (nz = 1 for DIM=2); sel: the on-disk component
    indices to read, in output order; itemsize: 4 or 8 (little-endian
    IEEE); dests: float64 C-contiguous arrays of len(sel) * nx * ny * nz
    elements, [comp, x, y, z] order.  Raises OSError if a record cannot
    be read (missing file, short read)."""
    n = len(paths)
    offsets = np.ascontiguousarray(offsets, np.int64)
    dims = np.ascontiguousarray(dims, np.int32).reshape(-1, 3)
    sel = np.ascontiguousarray(sel, np.int32)
    if not (len(offsets) == len(dims) == len(dests) == n):
        raise ValueError("load_fabs: paths, offsets, dims and dests differ "
                         "in length")
    if itemsize not in (4, 8):
        raise ValueError(f"load_fabs: itemsize {itemsize} is not 4 or 8")
    if (dims < 1).any() or (sel < 0).any():
        raise ValueError("load_fabs: empty box or negative component")
    for d, s in zip(dests, dims):
        if not (isinstance(d, np.ndarray) and d.dtype == np.float64
                and d.flags.c_contiguous
                and d.size == len(sel) * int(np.prod(s))):
            raise ValueError("load_fabs: each destination must be a "
                             "C-contiguous float64 array of len(sel) * "
                             "nx * ny * nz elements")
    if n == 0:
        return
    lib = get_lib()
    cpaths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    cdests = (ctypes.c_void_p * n)(*[d.ctypes.data for d in dests])
    rc = lib.load_fabs(
        cpaths, offsets, dims.ravel(), len(sel), sel, int(itemsize),
        ctypes.cast(cdests, ctypes.POINTER(ctypes.c_void_p)), n,
        loader_threads())
    if rc != 0:
        raise OSError(f"load_fabs: record {rc - 1} ({paths[rc - 1]}, "
                      f"offset {int(offsets[rc - 1])}) could not be read")


def qem_decimate(verts: np.ndarray, tris: np.ndarray, face_target: int,
                 boundary_weight: float = 1000.0,
                 attrs: np.ndarray = None,
                 placement_policy: int = 3,
                 weighting_policy: int = 1,
                 meshing_penalty: float = 1.0,
                 compactness_ratio: float = 0.0):
    """Decimate (verts [n,3] float64, tris [m,3] int32) to ~face_target
    faces.  Config surface mirrors the reference's qslim command line
    (Tools/qslim/cmdline.cpp:25-36): placement_policy 0=endpoints
    1=endormid 2=line 3=optimal; weighting_policy 0=uniform 1=area
    2=angle; meshing_penalty > 1 penalizes collapses that flip normals or
    create faces below compactness_ratio.
    Returns (verts, tris, attrs or None)."""
    lib = get_lib()
    verts = np.ascontiguousarray(verts, np.float64)
    tris = np.ascontiguousarray(tris, np.int32)
    n, m = len(verts), len(tris)
    n_attr = 0 if attrs is None else attrs.shape[1]
    if attrs is not None:
        attrs = np.ascontiguousarray(attrs, np.float64)
    out_v = np.empty((n, 3), np.float64)
    out_a = (np.empty((n, n_attr), np.float64) if n_attr else
             np.empty((1, 1), np.float64))
    out_t = np.empty((m, 3), np.int32)
    counts = np.zeros(2, np.int32)
    rc = lib.qem_decimate(
        n, m, n_attr, verts,
        attrs.ctypes.data if n_attr else None,
        tris, int(face_target), float(boundary_weight),
        int(placement_policy), int(weighting_policy),
        float(meshing_penalty), float(compactness_ratio),
        out_v, out_a.ctypes.data, out_t, counts)
    if rc != 0:
        raise RuntimeError(f"qem_decimate failed rc={rc}")
    nv, nf = int(counts[0]), int(counts[1])
    if n_attr:
        return out_v[:nv], out_t[:nf], out_a[:nv]
    return out_v[:nv], out_t[:nf], None
