"""XDMF surface output (isosurface surfFormat=XDMF, the reference's
Src/isosurface.cpp:2135-2229): an .xmf XML descriptor plus a .mesh binary
blob laid out [int32 connectivity | float64 XYZ | float64 per-component node
data].  A copy of ``peleanalysis_tpu/io/xdmf.py``.
"""
from __future__ import annotations

import numpy as np

from .mef import MEF


def write_xdmf(outfile_base: str, mef: MEF, iso_comp_name: str = "",
               iso_val: float = 0.0, time: float = 0.0) -> None:
    ndim = mef.ndim
    n_elts = mef.n_elts
    n_nodes = mef.n_nodes
    field_names = mef.names[ndim:]
    mesh_file = outfile_base + ".mesh"

    npe = mef.nodes_per_elt
    # conn size follows the ACTUAL nodes per element (r5 review fix: a 3-D
    # segment MEF — e.g. assembled lines — has npe=2, and assuming 3 put
    # every Seek 4*n_elts bytes past the real data)
    conn_bytes = 4 * npe * n_elts
    seek = conn_bytes
    with open(outfile_base + ".xmf", "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<Xdmf Version="3.0" xmlns:xi='
                '"http://www.w3.org/2001/XInclude">\n')
        f.write("   <Domain>\n")
        f.write('      <Grid Name="isoSurface">\n')
        f.write(f'      <Information Name="Variable" '
                f'Value="{iso_comp_name}"/>\n')
        f.write(f'      <Information Name="IsoValue" Value="{iso_val}"/>\n')
        f.write(f'      <Time Value="{time}"/>\n')
        if npe == 2:
            f.write(f'         <Topology TopologyType="Polyline" '
                    f'NodesPerElement="2" NumberOfElements="{n_elts}">\n')
        else:
            f.write(f'         <Topology TopologyType="Triangle" '
                    f'NumberOfElements="{n_elts}">\n')
        f.write(f'            <DataItem Name="Conn" Format="Binary" '
                f'DataType="Int" Dimensions="{mef.nodes_per_elt * n_elts}"'
                f'>\n               {mesh_file}\n            </DataItem>\n')
        f.write("         </Topology>\n")
        f.write(f'         <Geometry GeometryType='
                f'"{"XY" if ndim == 2 else "XYZ"}">\n')
        f.write(f'            <DataItem Name="Coord" Format="Binary" '
                f'Precision="8" DataType="Float" Seek="{seek}" '
                f'Dimensions="{ndim * n_nodes}">\n'
                f'               {mesh_file}\n            </DataItem>\n')
        f.write("         </Geometry>\n")
        seek += 8 * ndim * n_nodes
        for name in field_names:
            f.write(f'         <Attribute Name="{name}" '
                    f'AttributeType="Scalar" Center="Node">\n')
            f.write(f'            <DataItem Format="Binary" Precision="8" '
                    f'DataType="Float" Seek="{seek}" '
                    f'Dimensions="{n_nodes}">\n'
                    f'               {mesh_file}\n            </DataItem>\n')
            f.write("         </Attribute>\n")
            seek += 8 * n_nodes
        f.write("      </Grid>\n   </Domain>\n</Xdmf>\n")

    with open(mesh_file, "wb") as f:
        np.asarray(mef.elements, dtype="<i4").tofile(f)
        np.ascontiguousarray(mef.positions(), dtype="<f8").tofile(f)
        for k in range(len(field_names)):
            np.ascontiguousarray(mef.nodes[:, ndim + k],
                                 dtype="<f8").tofile(f)
