"""A premixed flame sheet as PeleLMeX writes it (``Exec/RegTests/
FlameSheet``): a laminar front across a domain periodic in x and y,
fresh gas entering at z-lo, burnt gas leaving at z-hi, displaced in z by
the case's sum of sinusoidal modes (``prob.pertmag``).

Every component of the case's plotfile is written, as a function of the
progress ``c = (1 + tanh((z - z_f(x, y)) / thickness)) / 2``: ``temp``
from the unburnt to the burnt temperature, ``density`` at constant
pressure, the species' ``rho.Y`` from the reactants' to the products'
mass fractions with the intermediates peaking inside the front, the
velocity, enthalpy, pressure, divergence and pressure gradient of a
steady planar flame.  The seed translates the perturbation in x and y
(both periodic): every seed gives the same surface, of the same area,
moved across the domain.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.amr import Hierarchy, cell_centres


def offsets(cfg: dict, seed: int, member: int) -> List[float]:
    """The translation of plotfile ``member``'s perturbation in x and
    y."""
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 1000 + member])
    lo, hi = cfg["geometry.prob_lo"], cfg["geometry.prob_hi"]
    return [float(rng.uniform(0.0, hi[d] - lo[d])) for d in range(2)]


def front_z(cfg: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The front's height over ``(x, y)``: ``front_z`` plus the case's
    perturbation, each mode ``amp * sin(2 pi kx (x - x0) / Lx) * sin(2 pi
    ky (y - y0) / Ly)`` (no y factor where ``ky`` is 0)."""
    lo, hi = cfg["geometry.prob_lo"], cfg["geometry.prob_hi"]
    lx, ly = hi[0] - lo[0], hi[1] - lo[1]
    pert = torch.zeros_like(x)
    for amp, kx, ky, x0, y0 in cfg["pert_modes"]:
        m = amp * torch.sin(2 * math.pi * kx * (x - x0) / lx)
        if ky:
            m = m * torch.sin(2 * math.pi * ky * (y - y0) / ly)
        pert = pert + m
    return cfg["front_z"] + cfg["prob.pertmag"] * pert


def level_fields(cfg: dict, h: Hierarchy, seed: int, member: int, lev: int,
                 device, dtype=torch.float64,
                 names: Optional[Sequence[str]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Dense fields of level ``lev``'s bounding box, ``[X, Y, Z]`` each,
    by name: every component, or ``names``."""
    names = list(cfg["components"] if names is None else names)
    sx, sy = offsets(cfg, seed, member)
    xs = [torch.from_numpy(c).to(device, torch.float64)
          for c in cell_centres(h, lev)]
    x, y = torch.meshgrid(xs[0] - sx, xs[1] - sy, indexing="ij")
    zf = front_z(cfg, x, y)[:, :, None]
    del x, y
    th = cfg["front_thickness"]
    c = 0.5 * (1.0 + torch.tanh((xs[2][None, None, :] - zf) / th))
    dc = 2.0 * c * (1.0 - c) / th                   # dc/dz
    tu, tb, ru = cfg["t_unburnt"], cfg["t_burnt"], cfg["rho_unburnt"]
    sl, sig = cfg["flame_speed"], cfg["t_burnt"] / cfg["t_unburnt"]
    temp = tu + (tb - tu) * c
    rho = ru * tu / temp
    out = {}
    for n in names:
        if n == "temp":
            v = temp
        elif n == "density":
            v = rho
        elif n.startswith("rho.Y("):
            sp = n[len("rho.Y("):-1]
            y = ((1.0 - c) * cfg["reactants"].get(sp, 0.0)
                 + c * cfg["products"].get(sp, 0.0)
                 + 4.0 * c * (1.0 - c) * cfg["intermediates"].get(sp, 0.0))
            v = rho * y
        elif n == "z_velocity":
            v = sl * temp / tu
        elif n in ("x_velocity", "y_velocity", "gradpx", "gradpy"):
            v = torch.zeros_like(c)
        elif n == "rhoh":
            v = rho * cfg["enthalpy"]
        elif n == "RhoRT":
            v = torch.full_like(c, cfg["pressure"])
        elif n == "divu":
            v = (sig - 1.0) * sl * dc
        elif n == "gradpz":
            v = -ru * sl * sl * (sig - 1.0) * dc
        else:
            raise KeyError(f"flame_sheet makes no component {n!r}")
        out[n] = v.to(dtype)
    return out


class _Level(dict):
    """One level's dense fields, each made when first asked for."""

    def __init__(self, make):
        super().__init__()
        self._make = make

    def __missing__(self, name):
        v = self[name] = self._make(name)
        return v


class State:
    """One plotfile's fields as the reference holds them: each level's
    dense fields in ``dtype`` on ``device``, made when first read, the
    valid masks, and the finest level's curvatures on demand."""

    def __init__(self, cfg: dict, h: Hierarchy, seed: int, member: int,
                 device, dtype: torch.dtype):
        self.cfg, self.h, self.dtype, self.device = cfg, h, dtype, device

        def maker(lev):
            return lambda n: level_fields(cfg, h, seed, member, lev, device,
                                          names=[n])[n].to(dtype)
        self.levels = [_Level(maker(lev)) for lev in range(h.n_levels)]
        self.valid = [torch.from_numpy(h.valid(lev)).to(device)
                      for lev in range(h.n_levels)]
        self._derived: Dict[str, torch.Tensor] = {}

    def finest(self, name: str) -> torch.Tensor:
        """A field of the finest level's box: a component, or a curvature
        of ``temp`` (``portbench.reference.flame.curvature``)."""
        if name in self.cfg["components"]:
            return self.levels[-1][name]
        if not self._derived:
            from portbench.reference.flame import curvature
            self._derived = curvature(self, "temp")
        return self._derived[name]
