"""VTK-family converters for MEF surfaces: the dependency-free
replacement for the reference's PythonScripts
(Src/PythonScripts/{mef2vtk,mef2vtu,datToVTP}.py, which need meshio / the
vtk package; these writers emit the formats by hand).

A copy of ``peleanalysis_tpu/io/vtk.py``: the same bytes, the text through
the port's native formatter.
"""
from __future__ import annotations

import base64
import struct

import numpy as np

from ..native import savetxt_fast

from .mef import MEF


def write_vtk_legacy(path: str, mef: MEF) -> None:
    """Legacy ASCII .vtk PolyData (mef2vtk.py analog)."""
    pos = mef.positions()
    if mef.ndim == 2:
        pos = np.concatenate([pos, np.zeros((len(pos), 1))], axis=1)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"{mef.label}\n")
        f.write("ASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {mef.n_nodes} double\n")
        savetxt_fast(f, pos, fmt="%.12g")
        npe = mef.nodes_per_elt
        if npe == 3:
            f.write(f"POLYGONS {mef.n_elts} {mef.n_elts * 4}\n")
        else:
            # cell-list size = per-row (count + npe ids), any npe (r5 fix)
            f.write(f"LINES {mef.n_elts} {mef.n_elts * (npe + 1)}\n")
        conn = np.concatenate(
            [np.full((mef.n_elts, 1), npe, dtype=np.int64),
             mef.elements.astype(np.int64)], axis=1)
        savetxt_fast(f, conn, fmt="%d")
        fields = mef.names[mef.ndim:]
        if fields:
            f.write(f"POINT_DATA {mef.n_nodes}\n")
            for name in fields:
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                savetxt_fast(f, mef.field(name), fmt="%.12g")


def _b64(arr: np.ndarray) -> str:
    raw = np.ascontiguousarray(arr).tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def write_vtu(path: str, mef: MEF) -> None:
    """XML .vtu UnstructuredGrid with base64 payload (mef2vtu.py analog)."""
    pos = mef.positions()
    if mef.ndim == 2:
        pos = np.concatenate([pos, np.zeros((len(pos), 1))], axis=1)
    npe = mef.nodes_per_elt
    cell_type = 5 if npe == 3 else 3  # VTK_TRIANGLE / VTK_LINE
    fields = mef.names[mef.ndim:]
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{mef.n_nodes}" '
                f'NumberOfCells="{mef.n_elts}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                'format="binary">\n')
        f.write(_b64(pos.astype("<f8")) + "\n</DataArray></Points>\n")
        f.write("<Cells>\n")
        f.write('<DataArray type="Int32" Name="connectivity" '
                'format="binary">\n')
        f.write(_b64(mef.elements.astype("<i4")) + "\n</DataArray>\n")
        f.write('<DataArray type="Int32" Name="offsets" format="binary">\n')
        offs = (np.arange(1, mef.n_elts + 1) * npe).astype("<i4")
        f.write(_b64(offs) + "\n</DataArray>\n")
        f.write('<DataArray type="UInt8" Name="types" format="binary">\n')
        f.write(_b64(np.full(mef.n_elts, cell_type, dtype=np.uint8))
                + "\n</DataArray>\n</Cells>\n")
        if fields:
            f.write("<PointData>\n")
            for name in fields:
                f.write(f'<DataArray type="Float64" Name="{name}" '
                        'format="binary">\n')
                f.write(_b64(mef.field(name).astype("<f8"))
                        + "\n</DataArray>\n")
            f.write("</PointData>\n")
        f.write("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")


def write_vtp(path: str, mef: MEF) -> None:
    """XML .vtp PolyData (datToVTP.py analog)."""
    pos = mef.positions()
    if mef.ndim == 2:
        pos = np.concatenate([pos, np.zeros((len(pos), 1))], axis=1)
    npe = mef.nodes_per_elt
    fields = mef.names[mef.ndim:]
    tag = "Polys" if npe == 3 else "Lines"
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="PolyData" version="0.1" '
                'byte_order="LittleEndian">\n<PolyData>\n')
        f.write(f'<Piece NumberOfPoints="{mef.n_nodes}" '
                f'NumberOf{tag}="{mef.n_elts}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                'format="binary">\n')
        f.write(_b64(pos.astype("<f8")) + "\n</DataArray></Points>\n")
        f.write(f"<{tag}>\n")
        f.write('<DataArray type="Int32" Name="connectivity" '
                'format="binary">\n')
        f.write(_b64(mef.elements.astype("<i4")) + "\n</DataArray>\n")
        f.write('<DataArray type="Int32" Name="offsets" format="binary">\n')
        offs = (np.arange(1, mef.n_elts + 1) * npe).astype("<i4")
        f.write(_b64(offs) + f"\n</DataArray>\n</{tag}>\n")
        if fields:
            f.write("<PointData>\n")
            for name in fields:
                f.write(f'<DataArray type="Float64" Name="{name}" '
                        'format="binary">\n')
                f.write(_b64(mef.field(name).astype("<f8"))
                        + "\n</DataArray>\n")
            f.write("</PointData>\n")
        f.write("</Piece>\n</PolyData>\n</VTKFile>\n")
