"""Box hierarchies and the plotfile writer of the benchmark's inputs.

The benchmark writes its own inputs, so that a change to the program's
writer cannot change what is measured.  The layout is AMReX's plotfile
(``HyperCLaw-V1.1``): a ``Header``, and per level a ``Cell_H`` index and
``Cell_D_<n>`` files of float64 FAB records in Fortran order.  The nested
hierarchy is data: a configuration gives each level's patches as physical
boxes, which are widened to whole blocks and cut into boxes of at most
``amr.max_grid_size`` cells a side, as AMReX's grid generation does.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

Box = Tuple[Tuple[int, int, int], Tuple[int, int, int]]   # (lo, hi), inclusive

FAB_F64 = "FAB ((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1)))"
FABS_PER_FILE = 64


def box_shape(b: Box) -> Tuple[int, int, int]:
    return tuple(h - l + 1 for l, h in zip(*b))


def box_str(b: Box) -> str:
    lo, hi = b
    return (f"(({lo[0]},{lo[1]},{lo[2]}) ({hi[0]},{hi[1]},{hi[2]}) "
            "(0,0,0))")


def decompose(b: Box, max_grid_size: int) -> List[Box]:
    """Near-equal chunks of at most ``max_grid_size`` cells a side."""
    splits = []
    for d in range(3):
        lo, n = b[0][d], b[1][d] - b[0][d] + 1
        k = (n + max_grid_size - 1) // max_grid_size
        sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
        offs = np.cumsum([0] + sizes)
        splits.append([(lo + offs[i], lo + offs[i + 1] - 1)
                       for i in range(k)])
    return [((x[0], y[0], z[0]), (x[1], y[1], z[1]))
            for x in splits[0] for y in splits[1] for z in splits[2]]


@dataclass
class Hierarchy:
    """Levels of a box domain of cubic cells: each level's domain box, its
    boxes and their union's bounding box."""
    n_cell: Tuple[int, int, int]            # level 0's cells a side
    ref_ratio: int
    prob_lo: Tuple[float, float, float]
    dx0: float                              # level 0's cell size
    domains: List[Box]
    boxes: List[List[Box]]
    bboxes: List[Box]

    @property
    def n_levels(self) -> int:
        return len(self.boxes)

    def dx(self, lev: int) -> float:
        return self.dx0 / self.ref_ratio ** lev

    def prob_hi(self) -> Tuple[float, float, float]:
        return tuple(lo + n * self.dx0 for lo, n in zip(self.prob_lo,
                                                        self.n_cell))

    def cells(self) -> int:
        return sum(int(np.prod(box_shape(b))) for bs in self.boxes
                   for b in bs)

    def _mask(self, lev: int, boxes: List[Box], r: int) -> np.ndarray:
        lo = self.bboxes[lev][0]
        m = np.zeros(box_shape(self.bboxes[lev]), dtype=bool)
        for b in boxes:
            sl = tuple(slice(max(b[0][d] // r - lo[d], 0),
                             max(b[1][d] // r - lo[d] + 1, 0))
                       for d in range(3))
            m[sl] = True
        return m

    def owned(self, lev: int) -> np.ndarray:
        """Cells of level ``lev``'s bounding box that lie in one of its
        boxes."""
        return self._mask(lev, self.boxes[lev], 1)

    def covered(self, lev: int) -> np.ndarray:
        """Cells of level ``lev``'s bounding box under the next finer
        level."""
        if lev + 1 >= self.n_levels:
            return np.zeros(box_shape(self.bboxes[lev]), dtype=bool)
        return self._mask(lev, self.boxes[lev + 1], self.ref_ratio)

    def valid(self, lev: int) -> np.ndarray:
        """Cells of level ``lev``'s bounding box that hold the solution:
        in one of its boxes and under no finer one."""
        return self.owned(lev) & ~self.covered(lev)


def _snap(lo: Sequence[float], hi: Sequence[float], h0: Sequence[float],
          dx: float, n: Sequence[int], bf: int) -> Box:
    """The index box of level cells over physical ``[lo, hi]``, widened
    to whole blocks of ``bf`` cells and clipped to the level's domain."""
    a = [max(0, int(np.floor((l - o) / dx / bf + 1e-9)) * bf)
         for l, o in zip(lo, h0)]
    b = [min(m, int(np.ceil((u - o) / dx / bf - 1e-9)) * bf) - 1
         for u, o, m in zip(hi, h0, n)]
    return tuple(int(x) for x in a), tuple(int(x) for x in b)


def _bbox(bs: List[Box]) -> Box:
    return (tuple(min(b[0][d] for b in bs) for d in range(3)),
            tuple(max(b[1][d] for b in bs) for d in range(3)))


def hierarchy(cfg: dict) -> Hierarchy:
    """The hierarchy a configuration file states, in the names of the
    AMReX inputs: ``geometry.prob_lo`` and ``prob_hi``, ``amr.n_cell``,
    ``amr.ref_ratio``, ``amr.blocking_factor``, ``amr.max_grid_size``;
    ``refined`` lists, for each level above the base, its patches as
    physical boxes ``[[lo...], [hi...]]``, widened to whole blocks."""
    n = tuple(int(x) for x in cfg["amr.n_cell"])
    r = int(cfg.get("amr.ref_ratio", 2))
    mgs = int(cfg["amr.max_grid_size"])
    bf = int(cfg.get("amr.blocking_factor", 1))
    plo = tuple(float(x) for x in cfg["geometry.prob_lo"])
    phi = tuple(float(x) for x in cfg["geometry.prob_hi"])
    dxs = [(u - l) / m for l, u, m in zip(plo, phi, n)]
    if max(dxs) - min(dxs) > 1e-12 * max(dxs):
        raise ValueError(f"cells are not cubic: dx {dxs}")
    dom = ((0, 0, 0), tuple(m - 1 for m in n))
    domains, boxes, bboxes = [dom], [decompose(dom, mgs)], [dom]
    for lev, patches in enumerate(cfg.get("refined", []), start=1):
        nl = tuple(m * r ** lev for m in n)
        domains.append(((0, 0, 0), tuple(m - 1 for m in nl)))
        subs = [_snap(p[0], p[1], plo, dxs[0] / r ** lev, nl, bf)
                for p in patches]
        boxes.append([c for s in subs for c in decompose(s, mgs)])
        bboxes.append(_bbox(subs))
    return Hierarchy(n, r, plo, dxs[0], domains, boxes, bboxes)


def cell_centres(h: Hierarchy, lev: int) -> List[np.ndarray]:
    """Float64 cell-centre coordinates of level ``lev``'s union box, per
    axis."""
    dx = h.dx(lev)
    return [h.prob_lo[d] + (np.arange(h.bboxes[lev][0][d],
                                      h.bboxes[lev][1][d] + 1) + 0.5) * dx
            for d in range(3)]


def write_plotfile(path: str, h: Hierarchy, names: Sequence[str],
                   level_payloads, time: float = 0.0) -> None:
    """A float64 plotfile of ``h``: ``level_payloads[lev]`` is a host
    buffer holding every box of the level in turn, each box's
    ``[comp, k, j, i]`` payload contiguous (the FAB order)."""
    os.makedirs(path, exist_ok=True)
    nc = len(names)
    with open(os.path.join(path, "Header"), "w") as f:
        f.write("HyperCLaw-V1.1\n" f"{nc}\n")
        f.write("".join(nm + "\n" for nm in names))
        f.write(f"3\n{time!r}\n{h.n_levels - 1}\n")
        f.write("".join(f"{x!r} " for x in h.prob_lo) + "\n")
        f.write("".join(f"{x!r} " for x in h.prob_hi()) + "\n")
        f.write(" ".join(str(h.ref_ratio) for _ in range(h.n_levels - 1))
                + " \n")
        f.write(" ".join(box_str(d) for d in h.domains) + " \n")
        f.write(" ".join("0" for _ in range(h.n_levels)) + " \n")
        for lev in range(h.n_levels):
            dx = h.dx(lev)
            f.write(f"{dx!r} {dx!r} {dx!r} \n")
        f.write("0\n0\n")
        for lev, bs in enumerate(h.boxes):
            dx = h.dx(lev)
            f.write(f"{lev} {len(bs)} {time!r}\n0\n")
            for b in bs:
                for d in range(3):
                    lo = h.prob_lo[d]
                    f.write(f"{lo + b[0][d] * dx!r} "
                            f"{lo + (b[1][d] + 1) * dx!r}\n")
            f.write(f"Level_{lev}/Cell\n")
    for lev, bs in enumerate(h.boxes):
        _write_level(os.path.join(path, f"Level_{lev}"), bs, nc,
                     level_payloads[lev])


def _write_level(dirname: str, bs: List[Box], nc: int, payload) -> None:
    os.makedirs(dirname, exist_ok=True)
    flat = np.ascontiguousarray(payload).reshape(-1)
    entries, mins, maxs, at = [], [], [], 0
    for first in range(0, len(bs), FABS_PER_FILE):
        fname = f"Cell_D_{first // FABS_PER_FILE:05d}"
        with open(os.path.join(dirname, fname), "wb") as f:
            for b in bs[first: first + FABS_PER_FILE]:
                n = nc * int(np.prod(box_shape(b)))
                block = flat[at: at + n]
                entries.append((fname, f.tell()))
                f.write(f"{FAB_F64}{box_str(b)} {nc}\n".encode("ascii"))
                f.write(memoryview(block))
                mins.append(block.reshape(nc, -1).min(axis=1))
                maxs.append(block.reshape(nc, -1).max(axis=1))
                at += n
            # on disk before the window opens: the kernel's write-back of a
            # run's gigabyte of inputs would otherwise land inside it
            f.flush()
            os.fsync(f.fileno())
    with open(os.path.join(dirname, "Cell_H"), "w") as f:
        f.write(f"1\n1\n{nc}\n0\n({len(bs)} 0\n")
        f.write("".join(box_str(b) + "\n" for b in bs))
        f.write(f")\n{len(bs)}\n")
        f.write("".join(f"FabOnDisk: {fn} {off}\n" for fn, off in entries))
        for table in (mins, maxs):
            f.write(f"\n{len(bs)},{nc}\n")
            f.write("".join(",".join(repr(float(v)) for v in row) + ",\n"
                            for row in table))
