"""Canonical marching-cubes lookup tables.

A copy of ``peleanalysis_tpu/geom/mc_tables.py`` (numpy only).

``edge_table`` (256 uint) and ``tri_table`` (256x16 int8) are the standard
public-domain tables from Paul Bourke's "Polygonising a scalar field"
(paulbourke.net/geometry/polygonise) — the same universal constants every MC
implementation (including the reference's Src/isosurface.cpp:451-741) shares.
Stored as a compressed npz blob; validated at load (edge bits == edges used
by triangles) and by the watertight-sphere tests in tests/test_isosurface.py
and tests/test_torch_isosurface.py.

Corner numbering (matches the reference's p0..p7, isosurface.cpp:425-433):
  0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0) 4:(0,0,1) 5:(1,0,1) 6:(1,1,1)
  7:(0,1,1)
Edge e connects CORNER_PAIRS[e].
"""
from __future__ import annotations

import os

import numpy as np

_blob = np.load(os.path.join(os.path.dirname(__file__), "mc_tables.npz"))
EDGE_TABLE: np.ndarray = _blob["edge_table"]         # [256] int32 bitmasks
TRI_TABLE: np.ndarray = _blob["tri_table"].astype(np.int32)  # [256,16]

# consistency check (cheap, runs at import)
for _ci in (0, 1, 254, 255, 90, 165):
    _used = set(int(v) for v in TRI_TABLE[_ci] if v >= 0)
    _bits = set(e for e in range(12) if EDGE_TABLE[_ci] & (1 << e))
    assert _used == _bits, f"MC tables corrupt at case {_ci}"

# corner offsets (i,j,k)
CORNER_OFFSETS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], dtype=np.int64)

# the two corners each of the 12 edges connects
CORNER_PAIRS = np.array(
    [(0, 1), (1, 2), (2, 3), (3, 0),
     (4, 5), (5, 6), (6, 7), (7, 4),
     (0, 4), (1, 5), (2, 6), (3, 7)], dtype=np.int64)

# number of triangles per case
TRI_COUNT = np.array([(TRI_TABLE[c] >= 0).sum() // 3 for c in range(256)],
                     dtype=np.int32)
