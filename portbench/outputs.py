"""Readers of the files the timed path writes, the benchmark's own."""
from __future__ import annotations

import re

import numpy as np

_BOX = re.compile(r"\(\(([-\d,]+)\)\s*\(([-\d,]+)\)\s*\(([-\d,]+)\)\)"
                  r"\s*(\d+)\s*$")


def read_mef(path: str) -> dict:
    """A binary MEF: label, names, a node FAB (node-major float64 ``[n,
    nvars]``), then 1-based int32 connectivity."""
    with open(path, "rb") as f:
        label = f.readline().decode("ascii").rstrip("\n")
        names = f.readline().decode("ascii").split()
        ne, npe = (int(x) for x in f.readline().decode("ascii").split())
        head = f.readline().decode("ascii")
        m = _BOX.search(head)
        if m is None or not head.startswith("FAB ((8,"):
            raise ValueError(f"{path}: unexpected node FAB header {head!r}")
        lo = [int(x) for x in m.group(1).split(",")]
        hi = [int(x) for x in m.group(2).split(",")]
        n, nv = hi[0] - lo[0] + 1, int(m.group(4))
        nodes = np.fromfile(f, dtype="<f8", count=n * nv)
        conn = np.fromfile(f, dtype="<i4", count=ne * npe)
    if nodes.size != n * nv or conn.size != ne * npe or nv != len(names):
        raise ValueError(f"{path}: truncated or inconsistent MEF")
    return {"label": label, "names": names, "nodes": nodes.reshape(n, nv),
            "elements": conn.reshape(ne, npe).astype(np.int64) - 1}


def mef_area(mef: dict) -> float:
    p = mef["nodes"][:, :3]
    e = mef["elements"]
    if e.size and (e.min() < 0 or e.max() >= p.shape[0]):
        return float("nan")
    a, b, c = p[e[:, 0]], p[e[:, 1]], p[e[:, 2]]
    return float(0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1).sum())


def read_table(path: str, skip: int = 0) -> np.ndarray:
    """Whitespace-separated numbers after ``skip`` header lines, one row a
    line."""
    with open(path) as f:
        lines = f.read().splitlines()[skip:]
    rows = [[float(x) for x in ln.split()] for ln in lines if ln.strip()
            and not ln.lstrip().startswith("#")]
    return np.asarray(rows, dtype=np.float64)
