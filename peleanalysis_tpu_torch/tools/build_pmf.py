"""``buildPMF`` -- turn a 1-D premixed-flame solution table into an
interpolation function (documented in PeleAnalysis
Docs/source/buildPMF.rst; the implementation lives in PelePhysics
Utility/PMF).

Counterpart of ``peleanalysis_tpu/tools/build_pmf.py``, host numpy as
there: a text table of a few thousand rows has no device work.  It takes
``device=`` as every verb of the port does (``cuda`` by default, refused
without a card).

Given a text table of states over 1-D points (PREMIX / Cantera output),
emits:
  * a PelePhysics-compatible ``pmf.dat`` (VARIABLES header + point rows)
  * optionally a Fortran-90 module whose ``pmf(xlo, xhi, y)`` returns the
    AVERAGE of each state over [xlo, xhi] (the documented semantics), via
    exact piecewise-linear integration of the table.

The same averaging interpolator is available in Python as
:func:`pmf_average` for in-framework initialization.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import config
from ..parmparse import ParmParse


def read_table(path: str) -> Tuple[List[str], np.ndarray]:
    """Read a whitespace table with optional VARIABLES = "..." header."""
    names = None
    rows = []
    with open(path) as f:
        for ln in f:
            s = ln.strip()
            if not s or s.startswith("#"):
                continue
            if s.upper().startswith("VARIABLES"):
                names = [t.strip().strip('"') for t in
                         s.split("=", 1)[1].replace(",", " ").split()]
                names = [n for n in names if n]
                continue
            if s.upper().startswith("ZONE"):
                continue
            rows.append([float(x) for x in s.split()])
    data = np.array(rows)
    if names is None:
        names = ["X"] + [f"var{i}" for i in range(1, data.shape[1])]
    return names, data


def pmf_average(x: np.ndarray, states: np.ndarray, xlo: float,
                xhi: float) -> np.ndarray:
    """Average of each state column over [xlo, xhi], exact for the
    piecewise-linear table (the documented 'average of each state between
    two locations')."""
    if xhi < xlo:
        xlo, xhi = xhi, xlo
    xlo = max(xlo, x[0])
    xhi = min(xhi, x[-1])
    if xhi <= xlo:
        i = int(np.clip(np.searchsorted(x, xlo) - 1, 0, len(x) - 2))
        t = (xlo - x[i]) / max(x[i + 1] - x[i], 1e-300)
        return states[i] + t * (states[i + 1] - states[i])
    # integrate the piecewise-linear interpolant
    grid = np.unique(np.concatenate([[xlo, xhi],
                                     x[(x > xlo) & (x < xhi)]]))
    acc = np.zeros(states.shape[1])
    for a, b in zip(grid[:-1], grid[1:]):
        va = np.array([np.interp(a, x, states[:, c])
                       for c in range(states.shape[1])])
        vb = np.array([np.interp(b, x, states[:, c])
                       for c in range(states.shape[1])])
        acc += 0.5 * (va + vb) * (b - a)
    return acc / (xhi - xlo)


FORTRAN_TEMPLATE = """module pmf_module
  implicit none
  integer, parameter :: pmf_N = {npts}
  integer, parameter :: pmf_M = {nvars}
  double precision, save :: pmf_X(pmf_N)
  double precision, save :: pmf_Y(pmf_N, pmf_M)
  logical, save :: pmf_initialized = .false.
contains
  subroutine pmf_init()
    implicit none
{data_stmts}
    pmf_initialized = .true.
  end subroutine pmf_init

  ! Average of each state over [xlo, xhi] (piecewise-linear table)
  subroutine pmf(xlo, xhi, y_vector)
    implicit none
    double precision, intent(in) :: xlo, xhi
    double precision, intent(out) :: y_vector(pmf_M)
    double precision :: a, b, xa, xb, va, vb, s
    integer :: i, c
    if (.not. pmf_initialized) call pmf_init()
    a = max(min(xlo, xhi), pmf_X(1))
    b = min(max(xlo, xhi), pmf_X(pmf_N))
    do c = 1, pmf_M
      if (b <= a) then
        do i = 1, pmf_N-1
          if (pmf_X(i+1) >= a) exit
        end do
        s = (a - pmf_X(i)) / max(pmf_X(i+1) - pmf_X(i), 1.d-300)
        y_vector(c) = pmf_Y(i,c) + s*(pmf_Y(i+1,c) - pmf_Y(i,c))
      else
        y_vector(c) = 0.d0
        do i = 1, pmf_N-1
          xa = max(pmf_X(i), a)
          xb = min(pmf_X(i+1), b)
          if (xb > xa) then
            s = max(pmf_X(i+1) - pmf_X(i), 1.d-300)
            va = pmf_Y(i,c) + (xa-pmf_X(i))/s*(pmf_Y(i+1,c)-pmf_Y(i,c))
            vb = pmf_Y(i,c) + (xb-pmf_X(i))/s*(pmf_Y(i+1,c)-pmf_Y(i,c))
            y_vector(c) = y_vector(c) + 0.5d0*(va+vb)*(xb-xa)
          end if
        end do
        y_vector(c) = y_vector(c) / (b - a)
      end if
    end do
  end subroutine pmf
end module pmf_module
"""


def write_fortran(path: str, x: np.ndarray, states: np.ndarray) -> None:
    stmts = []
    for i, xi in enumerate(x):
        stmts.append(f"    pmf_X({i+1}) = {xi:.17e}".replace("e", "d"))
    for c in range(states.shape[1]):
        for i in range(len(x)):
            stmts.append(
                f"    pmf_Y({i+1},{c+1}) = "
                + f"{states[i, c]:.17e}".replace("e", "d"))
    src = FORTRAN_TEMPLATE.format(npts=len(x), nvars=states.shape[1],
                                  data_stmts="\n".join(stmts))
    with open(path, "w") as f:
        f.write(src)


def main(args: dict) -> None:
    """CLI: buildPMF infile=<table> [outfile=pmf.dat] [fortran=pmf.f90]
    [device=cuda|cpu]"""
    pp = ParmParse(args)
    config.get_device(pp.query_str("device", "cuda"))
    names, data = read_table(pp.get_str("infile"))
    x = data[:, 0]
    states = data[:, 1:]
    out = pp.query_str("outfile", "pmf.dat")
    with open(out, "w") as f:
        f.write('VARIABLES = ' + ' '.join(f'"{n}"' for n in names) + "\n")
        f.write(f'ZONE I={len(x)} FORMAT=POINT\n')
        np.savetxt(f, data, fmt="%.17e")
    print(f"wrote {out}")
    if pp.contains("fortran"):
        write_fortran(pp.get_str("fortran"), x, states)
        print(f"wrote {pp.get_str('fortran')}")
