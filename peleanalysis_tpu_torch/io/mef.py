"""MEF ("Marc's Element Format") surface I/O — the shared module the
reference never had (each tool carries its own read_iso/write_iso copy,
acknowledged TODO in the reference's Docs/source/data.rst "MEF").

On-disk layout (data.rst "MEF"; writer at Src/isosurface.cpp:2108-2130):
  line 1: label (typically the plotfile time)
  line 2: space-separated variable names (first ndim are X Y [Z])
  line 3: "<nElts> <nodesPerElt>"
  FAB record whose payload is node-major float64 [Nnodes, nvars]
  raw int32 [nElts, nodesPerElt] connectivity, 1-based.

A copy of ``peleanalysis_tpu/io/mef.py``; the Tecplot writer formats its
text with the port's copy of the JAX package's native formatter.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..native import savetxt_fast
from ..telemetry import span
from .fab import read_raw_node_fab, write_raw_node_fab


@dataclasses.dataclass
class MEF:
    label: str
    names: List[str]            # per-node field names, X Y [Z] first
    nodes: np.ndarray           # [Nnodes, nvars] float64
    elements: np.ndarray        # [Nelts, nodesPerElt] int32, 0-based in memory

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_elts(self) -> int:
        return self.elements.shape[0]

    @property
    def nodes_per_elt(self) -> int:
        return self.elements.shape[1]

    @property
    def ndim(self) -> int:
        return 3 if "Z" in self.names[:3] else 2

    def positions(self) -> np.ndarray:
        return self.nodes[:, : self.ndim]

    def field(self, name: str) -> np.ndarray:
        return self.nodes[:, self.names.index(name)]

    def validate(self) -> None:
        if self.elements.size and (self.elements.min() < 0
                                   or self.elements.max() >= self.n_nodes):
            raise ValueError("MEF connectivity references nonexistent nodes")

    # -- geometry helpers (triangle surfaces) -------------------------------
    def triangle_areas(self) -> np.ndarray:
        """Per-element area (3D triangles) or length (2D segments)."""
        p = self.positions()
        e = self.elements
        if self.nodes_per_elt == 3 and self.ndim == 3:
            a, b, c = p[e[:, 0]], p[e[:, 1]], p[e[:, 2]]
            return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
        if self.nodes_per_elt == 2:
            a, b = p[e[:, 0]], p[e[:, 1]]
            return np.linalg.norm(b - a, axis=1)
        raise ValueError(f"unsupported element type {self.nodes_per_elt}-node")

    def total_area(self) -> float:
        return float(self.triangle_areas().sum())


def read_mef(path: str) -> MEF:
    with open(path, "rb") as f:
        label = f.readline().decode("ascii").rstrip("\n")
        names = f.readline().decode("ascii").split()
        ne_line = f.readline().decode("ascii").split()
        n_elts, npe = int(ne_line[0]), int(ne_line[1])
        nodes = read_raw_node_fab(f)
        conn = np.fromfile(f, dtype="<i4", count=n_elts * npe)
        if conn.size != n_elts * npe:
            raise EOFError("truncated MEF connectivity")
        elements = conn.reshape(n_elts, npe).astype(np.int32) - 1  # to 0-based
    if nodes.shape[1] != len(names):
        raise ValueError(f"MEF var-count mismatch: {nodes.shape[1]} vs {len(names)}")
    return MEF(label, names, nodes, elements)


def write_mef(path: str, mef: MEF) -> None:
    mef.validate()
    with span("write.mef"), open(path, "wb") as f:
        f.write((mef.label + "\n").encode("ascii"))
        f.write((" ".join(mef.names) + "\n").encode("ascii"))
        f.write(f"{mef.n_elts} {mef.nodes_per_elt}\n".encode("ascii"))
        write_raw_node_fab(f, np.asarray(mef.nodes, dtype=np.float64))
        (np.asarray(mef.elements, dtype=np.int32) + 1).tofile(f)


def write_mef_tecplot(path: str, mef: MEF) -> None:
    """MEF -> Tecplot ASCII FEPOINT (surfMEFtoDAT analog,
    reference: Src/surfMEFtoDAT.cpp:5-13)."""
    zone_type = "TRIANGLE" if mef.nodes_per_elt == 3 else "FELINESEG"
    with span("write.mef"), open(path, "w") as f:
        f.write("VARIABLES = " + " ".join(f'"{n}"' for n in mef.names) + "\n")
        f.write(
            f'ZONE T="{mef.label}" N={mef.n_nodes} E={mef.n_elts} '
            f"F=FEPOINT ET={zone_type}\n"
        )
        savetxt_fast(f, mef.nodes, fmt="%.12g")
        savetxt_fast(f, mef.elements + 1, fmt="%d")


def _zone_fields(zone: str) -> dict:
    """Parse a Tecplot ZONE line into {KEY: value}.  Quoted values are
    captured first (titles may contain spaces or '=' — r5 review fix:
    dict(kv.split('=')) crashed on 'T="t=0.00125"'), then bare KEY=VALUE
    tokens with at most one split."""
    import re
    out = {}
    for k, v in re.findall(r'(\w+)\s*=\s*"([^"]*)"', zone):
        out[k.upper()] = v
    z = re.sub(r'"[^"]*"', '""', zone)
    for kv in z.replace(",", " ").split():
        if "=" in kv:
            k, v = kv.split("=", 1)
            out.setdefault(k.upper(), v)
    return out


def read_mef_tecplot(path: str) -> MEF:
    """Tecplot ASCII FEPOINT -> MEF (surfDATtoMEF analog,
    reference: Src/surfDATtoMEF.cpp:10-35)."""
    with open(path, "r") as f:
        var_line = f.readline()
        names = [s.strip().strip('"') for s in
                 var_line.split("=", 1)[1].replace(",", " ").split()]
        names = [n for n in names if n]
        zone = f.readline()
        fields = _zone_fields(zone)
        if "N" not in fields and "I" in fields:
            # line zones (the stream tool's per-line output): chain each
            # zone's points into 2-node segments (the reference's datToVTP
            # rejects these; converting them is strictly more useful)
            all_nodes, all_segs, off = [], [], 0
            npts = int(fields["I"])
            while True:
                pts = np.loadtxt(f, max_rows=npts).reshape(npts, len(names))
                all_nodes.append(pts)
                seg = np.stack([np.arange(npts - 1), np.arange(1, npts)],
                               axis=1) + off
                all_segs.append(seg)
                off += npts
                zone = f.readline()
                if not zone.strip():
                    break
                fields = _zone_fields(zone)
                npts = int(fields["I"])
            return MEF("lines", names, np.concatenate(all_nodes),
                       np.concatenate(all_segs).astype(np.int32))
        n_nodes = int(fields["N"])
        n_elts = int(fields["E"])
        nodes = np.loadtxt(f, max_rows=n_nodes).reshape(n_nodes, len(names))
        elems = np.loadtxt(f, max_rows=n_elts, dtype=np.int64)
        elems = np.atleast_2d(elems).astype(np.int32) - 1
    label = fields.get("T", "surface").strip('"') or "surface"
    return MEF(label, names, nodes, elems)
