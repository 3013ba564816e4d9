"""StreamData on-disk format ("Oddball-multilevel-connected-data-format").

Shared reader/writer replacing the reference's per-tool copies
(write_ml_streamline_data reference Src/stream.cpp:2091-2225, reader
Src/StreamData.cpp:81-293; layout documented in Docs/source/data.rst
"StreamData"):

  Header      — format name, #levels, #vars, var names
  Elements    — nElts, nodesPerElt, 1-based element node list, then per level
                the per-box distribution: "num_non_zero" then rows
                "<box> <count> <1-based line ids...>"
  Level_%d/Str(_H) — VisMF; each box's FAB has Box (0:Nlocal-1, -n:+n, 0),
                j = arclength station (j=0 at the seed), comps = X,Y,Z +
                fields; seedless boxes get the 1-point ZBOX marker
                (stream.cpp:756-763).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

from ..amr.box import Box, BoxArray
from ..native import savetxt_fast
from .fab import read_fab
from .plotfile import _parse_vismf_header, _write_vismf

FORMAT_NAME = "Oddball-multilevel-connected-data-format"
FORMAT_NAME_10 = FORMAT_NAME + "-1.0"
ZBOX = Box((0, 0, 0), (0, 0, 0))


@dataclasses.dataclass
class StreamData:
    names: List[str]                      # X Y Z + fields
    elements: np.ndarray                  # [nElts, npe] int32, 0-based
    inside_nodes: List[List[np.ndarray]]  # [lev][box] -> 1-based line ids
    lines: np.ndarray                     # [nLines, npts, nvars] (j=mid seed)

    @property
    def n_levels(self) -> int:
        return len(self.inside_nodes)

    @property
    def n_lines(self) -> int:
        return self.lines.shape[0]

    @property
    def n_pts(self) -> int:
        return self.lines.shape[1]

    # -- distributed unstructured-surface machinery --------------------------
    def global_node_map(self):
        """line id (0-based) -> (level, box, position-in-box) — the
        GlobalNodeMap/MLloc of the reference (StreamData.cpp:447-467)."""
        out = {}
        for lev, per_box in enumerate(self.inside_nodes):
            for ib, ids in enumerate(per_box):
                for p, gid in enumerate(ids):
                    out[int(gid) - 1] = (lev, ib, p)
        return out

    def partition_elements(self, n_parts: int, seed: int = 0):
        """Assign each element to the partition owning its first node (ties
        broken deterministically from `seed`), and compute the ghost-node
        exchange lists — PartitionElements/remote_nodes/tosend_nodes
        (StreamData.cpp:468-610).  Node ownership is round-robin by line id
        (the resident-array analog of rank data placement).

        Returns (elt_part [ne], remote_nodes, tosend_nodes) where
        remote_nodes[p] = node ids partition p must receive, and
        tosend_nodes[p][q] = node ids p must send to q."""
        ne = len(self.elements)
        node_part = (np.arange(self.n_lines) + seed) % max(n_parts, 1)
        elt_part = node_part[self.elements[:, 0]] if ne else             np.zeros(0, dtype=np.int64)
        remote_nodes = [[] for _ in range(n_parts)]
        tosend = [[[] for _ in range(n_parts)] for _ in range(n_parts)]
        for e in range(ne):
            p = int(elt_part[e])
            for nid in self.elements[e]:
                q = int(node_part[nid])
                if q != p:
                    remote_nodes[p].append(int(nid))
                    tosend[q][p].append(int(nid))
        remote_nodes = [np.unique(np.array(r, dtype=np.int64))
                        for r in remote_nodes]
        tosend = [[np.unique(np.array(t, dtype=np.int64)) for t in row]
                  for row in tosend]
        return elt_part, remote_nodes, tosend


def compute_inside_nodes(meta, seeds: np.ndarray) -> List[List[np.ndarray]]:
    """Per-level per-box 1-based seed ownership (setInsideNodes semantics,
    stream.cpp:140-215: inside the box, not inside any coarsened finer box)."""
    out: List[List[np.ndarray]] = []
    taken = np.zeros(len(seeds), dtype=bool)
    # finest-first ownership, then assemble per level in box order
    owner_lev = np.full(len(seeds), -1, dtype=np.int32)
    owner_box = np.full(len(seeds), -1, dtype=np.int32)
    for lev in range(meta.n_levels - 1, -1, -1):
        geom = meta.geoms[lev]
        dx = np.array(geom.dx)
        plo = np.array(geom.prob_lo)
        for ib, b in enumerate(meta.bas[lev]):
            lo = plo + (np.array(b.lo) - np.array(geom.domain.lo)) * dx
            hi = plo + (np.array(b.hi) + 1 - np.array(geom.domain.lo)) * dx
            inb = np.all((seeds >= lo) & (seeds < hi), axis=1) & ~taken
            owner_lev[inb] = lev
            owner_box[inb] = ib
            taken |= inb
    for lev in range(meta.n_levels):
        per_box = []
        for ib in range(len(meta.bas[lev])):
            ids = np.nonzero((owner_lev == lev) & (owner_box == ib))[0]
            per_box.append(ids.astype(np.int64) + 1)  # 1-based
        out.append(per_box)
    return out


def write_stream_data(path: str, sd: StreamData, meta=None,
                      version: str = "0") -> None:
    """version="1.0" writes the extended header (element-file name/format,
    probLo/probHi, per-level prob domains, per-level VisMF names) in the
    layout the reference READER expects (StreamData.cpp:147-200) — the
    reference's own v1.0 writer (StreamData.cpp:333-344) emits boxArrays its
    reader never consumes, so we follow the reader."""
    if version not in ("0", "1.0"):
        raise ValueError(f"unknown StreamData version {version!r}")
    if version == "1.0" and meta is None:
        raise ValueError("version='1.0' needs meta for probLo/probHi/domains")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "Header"), "w") as f:
        f.write((FORMAT_NAME_10 if version == "1.0" else FORMAT_NAME) + "\n")
        f.write(f"{sd.n_levels}\n")
        f.write(f"{len(sd.names)}\n")
        for n in sd.names:
            f.write(n + "\n")
        if version == "1.0":
            f.write("Elements\nELEMENT_DATA_ASCII\n")
            g0 = meta.geoms[0]
            f.write(" ".join(f"{v:.17g}" for v in g0.prob_lo) + " \n")
            f.write(" ".join(f"{v:.17g}" for v in g0.prob_hi) + " \n")
            for lev in range(sd.n_levels):
                f.write(repr(meta.geoms[lev].domain) + "\n")
            for lev in range(sd.n_levels):
                f.write(f"Level_{lev}/Str\n")
    with open(os.path.join(path, "Elements"), "w") as f:
        npe = sd.elements.shape[1] if sd.elements.size else 3
        f.write(f"{len(sd.elements)}\n{npe}\n")
        if len(sd.elements):
            # one element per line (readers are token-based)
            savetxt_fast(f, np.asarray(sd.elements, np.int64) + 1, fmt="%d")
        f.write(" \n")
        for lev in range(sd.n_levels):
            nz = [(j, ids) for j, ids in enumerate(sd.inside_nodes[lev])
                  if len(ids) > 0]
            f.write(f"{len(nz)}\n")
            for j, ids in nz:
                f.write(f"{j} {len(ids)} " + " ".join(str(int(i))
                                                      for i in ids) + "\n")
    n_half = (sd.n_pts - 1) // 2
    for lev in range(sd.n_levels):
        lev_dir = os.path.join(path, f"Level_{lev}")
        boxes, fabs = [], []
        for ids in sd.inside_nodes[lev]:
            if len(ids) == 0:
                boxes.append(ZBOX)
                fabs.append(np.zeros((len(sd.names), 1, 1, 1)))
            else:
                boxes.append(Box((0, -n_half, 0),
                                 (len(ids) - 1, n_half, 0)))
                # FAB layout [comp, i(line), j(station), k=0]
                blk = sd.lines[ids - 1]          # [ni, npts, nvars]
                fabs.append(np.transpose(blk, (2, 0, 1))[..., None])
        _write_vismf(lev_dir, "Str", BoxArray(boxes), fabs, np.float64, 64)


def read_stream_data(path: str) -> StreamData:
    with open(os.path.join(path, "Header")) as f:
        fmt = f.readline().strip()
        if not fmt.startswith(FORMAT_NAME):
            raise ValueError(f"not a StreamData folder: {fmt!r}")
        n_levels = int(f.readline())
        n_vars = int(f.readline())
        names = [f.readline().strip() for _ in range(n_vars)]
        elements_file = "Elements"
        mf_paths = [f"Level_{lev}/Str" for lev in range(n_levels)]
        if fmt.strip() == FORMAT_NAME_10:
            # extended header: element file name/format, probLo/probHi,
            # per-level prob domains, then per-level VisMF names
            # (StreamData.cpp:147-200); files from the reference's own v1.0
            # writer carry boxArrays instead of VisMF names — tolerated by
            # keeping the defaults when no path-like lines follow
            elements_file = f.readline().split()[0]
            rest = [ln.strip() for ln in f if ln.strip()]
            paths = [ln.split()[0] for ln in rest if "/" in ln.split()[0]]
            if len(paths) >= n_levels:
                mf_paths = paths[:n_levels]
    def _next_nonblank(f):
        while True:
            line = f.readline()
            if line == "":
                raise EOFError("truncated Elements file")
            if line.strip():
                return line

    with open(os.path.join(path, elements_file)) as f:
        n_elts = int(_next_nonblank(f))
        npe = int(_next_nonblank(f))
        face = []
        while len(face) < n_elts * npe:
            ln = f.readline()
            if not ln:
                raise EOFError(
                    f"truncated Elements file: {len(face)} of "
                    f"{n_elts * npe} connectivity tokens")
            face.extend(int(x) for x in ln.split())
        elements = (np.array(face[: n_elts * npe], dtype=np.int32)
                    .reshape(n_elts, npe) - 1) if n_elts else \
            np.zeros((0, npe), np.int32)
        inside_nodes: List[List[np.ndarray]] = []
        for lev in range(n_levels):
            nz = int(_next_nonblank(f))
            rows = {}
            max_box = -1
            for _ in range(nz):
                parts = f.readline().split()
                j, cnt = int(parts[0]), int(parts[1])
                rows[j] = np.array([int(x) for x in parts[2 : 2 + cnt]],
                                   dtype=np.int64)
                max_box = max(max_box, j)
            inside_nodes.append([rows.get(j, np.zeros(0, np.int64))
                                 for j in range(max_box + 1)])

    # line data: total lines & station count from the level FABs
    n_lines = max((int(ids.max()) for lev in inside_nodes for ids in lev
                   if len(ids)), default=0)
    lines = None
    for lev in range(n_levels):
        lev_dir, mf_base = os.path.split(mf_paths[lev])
        hdr = _parse_vismf_header(os.path.join(path, lev_dir,
                                               mf_base + "_H"))
        # pad inside_nodes with empties to the VisMF box count
        while len(inside_nodes[lev]) < len(hdr["boxes"]):
            inside_nodes[lev].append(np.zeros(0, np.int64))
        for ib, (fname, off) in enumerate(hdr["fabs"]):
            ids = inside_nodes[lev][ib]
            if len(ids) == 0:
                continue
            with open(os.path.join(path, lev_dir, fname), "rb") as fb:
                fb.seek(off)
                box, data = read_fab(fb)   # [ncomp, ni, nj, 1]
            if lines is None:
                lines = np.zeros((n_lines, box.shape[1], len(names)))
            lines[ids - 1] = np.transpose(data[..., 0], (1, 2, 0))
    if lines is None:
        lines = np.zeros((0, 1, len(names)))
    return StreamData(names, elements, inside_nodes, lines)
