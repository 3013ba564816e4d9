"""AMReX particle-plotfile I/O (the ParticleContainer::WritePlotFile format
used by the reference's partStream, Src/partStream.cpp:199 + StreamPC.cpp;
layout per the AMReX particle IO docs).  A copy of
``peleanalysis_tpu/io/particles.py`` (numpy only):

  <dir>/<ptype>/Header           ASCII:
      Version_Two_Dot_Zero_double
      <ndim> / <n extra reals> / names / <n extra ints> / names
      <is_checkpoint> <nparticles> <next_id> <finest_level>
      per level: <ngrids>, then per grid "<which_file> <count> <offset>"
  <dir>/<ptype>/Level_L/DATA_xxxxx   binary per grid:
      int32 block  [count, 2]            (id, cpu)      + extra ints
      float64 block [count, ndim + n_extra_reals]

Both writer and reader live here so StreamData/partStream outputs round-trip
without AMReX.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

VERSION = "Version_Two_Dot_Zero_double"


def write_particles(
    plt_dir: str,
    positions: np.ndarray,              # [N, ndim]
    real_comps: Optional[Dict[str, np.ndarray]] = None,   # name -> [N]
    int_comps: Optional[Dict[str, np.ndarray]] = None,
    ptype: str = "particles",
) -> None:
    real_comps = real_comps or {}
    int_comps = int_comps or {}
    n, ndim = positions.shape
    base = os.path.join(plt_dir, ptype)
    os.makedirs(os.path.join(base, "Level_0"), exist_ok=True)

    with open(os.path.join(base, "Header"), "w") as f:
        f.write(VERSION + "\n")
        f.write(f"{ndim}\n")
        f.write(f"{len(real_comps)}\n")
        for k in real_comps:
            f.write(k + "\n")
        f.write(f"{len(int_comps)}\n")
        for k in int_comps:
            f.write(k + "\n")
        f.write("0\n")            # is_checkpoint
        f.write(f"{n}\n")         # total particles
        f.write(f"{n + 1}\n")     # next id
        f.write("0\n")            # finest level
        f.write("1\n")            # ngrids at level 0
        f.write(f"0 {n} 0\n")     # which_file count offset

    ints = np.empty((n, 2 + len(int_comps)), dtype="<i4")
    ints[:, 0] = np.arange(1, n + 1)   # ids (1-based like AMReX)
    ints[:, 1] = 0                     # cpu
    for k, arr in enumerate(int_comps.values()):
        ints[:, 2 + k] = arr
    reals = np.empty((n, ndim + len(real_comps)), dtype="<f8")
    reals[:, :ndim] = positions
    for k, arr in enumerate(real_comps.values()):
        reals[:, ndim + k] = arr
    with open(os.path.join(base, "Level_0", "DATA_00000"), "wb") as f:
        ints.tofile(f)
        reals.tofile(f)


def read_particles(plt_dir: str, ptype: str = "particles"):
    """Returns (positions [N,ndim], real_comps dict, int_comps dict)."""
    base = os.path.join(plt_dir, ptype)
    with open(os.path.join(base, "Header")) as f:
        version = f.readline().strip()
        if not version.startswith("Version_Two"):
            raise ValueError(f"unsupported particle header {version!r}")
        ndim = int(f.readline())
        nr = int(f.readline())
        rnames = [f.readline().strip() for _ in range(nr)]
        ni = int(f.readline())
        inames = [f.readline().strip() for _ in range(ni)]
        _ckpt = int(f.readline())
        n_total = int(f.readline())
        _next_id = int(f.readline())
        finest = int(f.readline())
        grids = []
        for lev in range(finest + 1):
            ng = int(f.readline())
            lev_grids = []
            for _ in range(ng):
                which, count, where = (int(x) for x in f.readline().split())
                lev_grids.append((which, count, where))
            grids.append(lev_grids)

    pos_all, reals_all, ints_all = [], [], []
    for lev, lev_grids in enumerate(grids):
        for which, count, where in lev_grids:
            if count == 0:
                continue
            path = os.path.join(base, f"Level_{lev}", f"DATA_{which:05d}")
            with open(path, "rb") as f:
                f.seek(where)
                ints = np.fromfile(f, dtype="<i4",
                                   count=count * (2 + ni)).reshape(count,
                                                                   2 + ni)
                reals = np.fromfile(f, dtype="<f8",
                                    count=count * (ndim + nr)).reshape(
                    count, ndim + nr)
            pos_all.append(reals[:, :ndim])
            reals_all.append(reals[:, ndim:])
            ints_all.append(ints[:, 2:])
    pos = np.concatenate(pos_all) if pos_all else np.zeros((0, ndim))
    reals = np.concatenate(reals_all) if reals_all else np.zeros((0, nr))
    ints = np.concatenate(ints_all) if ints_all else np.zeros((0, ni), int)
    return (pos, {n: reals[:, i] for i, n in enumerate(rnames)},
            {n: ints[:, i] for i, n in enumerate(inames)})
