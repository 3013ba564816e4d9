"""Chemistry layer: species, molecular weights, NASA7 thermo, simple
transport -- the PelePhysics EOS(Fuego)/Transport(Simple) analog behind the
ModelSpecificAnalysis tools.

Counterpart of ``peleanalysis_tpu/chem/mechanism.py``.  The host parsing
(formulas, weights, CHEMKIN ``therm.dat``) is a copy; the conversions,
thermo sums and transport take tensors and run on their device, in numpy's
order of operations: each species sum adds the species one after another,
as numpy's reduction over the leading axis does, and ``cp_mass``/``h_mass``
keep the species loop.  ``Nasa7`` keeps its numpy polynomials (the tests'
oracles) beside the tensor ones.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch

R_UNIV = 8.31446261815324e7  # erg/(mol K), CGS like PelePhysics

ATOMIC_MASS = {
    "H": 1.00794, "HE": 4.002602, "C": 12.0107, "N": 14.0067,
    "O": 15.9994, "F": 18.9984032, "NE": 20.1797, "AR": 39.948,
    "S": 32.065, "CL": 35.453, "SI": 28.0855,
}

# species whose names aren't plain formulas (common combustion mechanisms)
SPECIAL_FORMULAS = {
    "AR": {"AR": 1}, "HE": {"HE": 1}, "N2": {"N": 2},
    "CH2GSG": {"C": 1, "H": 2}, "CH2(S)": {"C": 1, "H": 2},
    "C2H5OH": {"C": 2, "H": 6, "O": 1},
}


def parse_formula(name: str) -> Dict[str, int]:
    """Element composition from a species name like CH4, C2H5OH, HO2.

    Combustion-mechanism isomer conventions are handled before parsing: a
    leading n-/i-/N-/I-/NEO prefix on a C_xH_y(O_z) skeleton marks
    normal/iso/neopentyl isomers, not elements ('NC7H16' has no nitrogen,
    'N-C4H10' is butane)."""
    key = name.upper().strip()
    if key in SPECIAL_FORMULAS:
        return dict(SPECIAL_FORMULAS[key])
    key = key.split("(")[0]
    # N-C4H10 / I-C8H18: the dash separates the isomer prefix
    m = re.fullmatch(r"(N|I|NEO|T|S)-(.+)", key)
    if m:
        key = m.group(2)
    else:
        key = key.split("-")[0]
        # NC7H16 / IC8H18 / NEOC5H12: prefix + pure hydrocarbon skeleton
        m = re.fullmatch(r"(N|I|NEO)(C\d*H\d+[A-Z0-9]*)", key)
        if m and m.group(1) in ("N", "I", "NEO"):
            key = m.group(2)
    comp: Dict[str, int] = {}
    i = 0
    while i < len(key):
        # try two-letter elements first
        for ln in (2, 1):
            sym = key[i : i + ln]
            if sym in ATOMIC_MASS and (ln == 1 or sym not in ("CH", "CO",
                                                              "CN", "NO",
                                                              "OH", "HO")):
                m = re.match(r"(\d+)", key[i + ln:])
                cnt = int(m.group(1)) if m else 1
                comp[sym] = comp.get(sym, 0) + cnt
                i += ln + (len(m.group(1)) if m else 0)
                break
        else:
            raise ValueError(f"cannot parse species formula {name!r}")
    return comp


def molecular_weight(name: str) -> float:
    return sum(ATOMIC_MASS[e] * n for e, n in parse_formula(name).items())


def atom_count(name: str, element: str) -> int:
    return parse_formula(name).get(element.upper(), 0)


@dataclasses.dataclass
class Nasa7:
    t_low: float
    t_mid: float
    t_high: float
    lo: np.ndarray   # 7 coeffs valid below t_mid
    hi: np.ndarray   # 7 coeffs above t_mid

    def cp_R(self, T):
        a = np.where(np.asarray(T)[..., None] < self.t_mid, self.lo, self.hi)
        return (a[..., 0] + a[..., 1] * T + a[..., 2] * T**2
                + a[..., 3] * T**3 + a[..., 4] * T**4)

    def h_RT(self, T):
        a = np.where(np.asarray(T)[..., None] < self.t_mid, self.lo, self.hi)
        return (a[..., 0] + a[..., 1] * T / 2 + a[..., 2] * T**2 / 3
                + a[..., 3] * T**3 / 4 + a[..., 4] * T**4 / 5
                + a[..., 5] / T)

    def s_R(self, T):
        """Standard-state entropy S0/R.  Kinetics._g_RT evaluates the same
        polynomials from batched per-mechanism tables; this per-species form
        is the test oracle for it."""
        a = np.where(np.asarray(T)[..., None] < self.t_mid, self.lo, self.hi)
        return (a[..., 0] * np.log(T) + a[..., 1] * T + a[..., 2] * T**2 / 2
                + a[..., 3] * T**3 / 3 + a[..., 4] * T**4 / 4 + a[..., 6])

    # -- the same polynomials on a tensor T, on its device --------------------
    def _coeffs(self, T: torch.Tensor):
        """The 7 coefficients, each [*T.shape], of the range T falls in."""
        lo = torch.as_tensor(self.lo, dtype=T.dtype, device=T.device)
        hi = torch.as_tensor(self.hi, dtype=T.dtype, device=T.device)
        a = torch.where(T[..., None] < self.t_mid, lo, hi)
        return [a[..., k] for k in range(7)]

    def cp_R_tensor(self, T: torch.Tensor) -> torch.Tensor:
        a = self._coeffs(T)
        return (a[0] + a[1] * T + a[2] * T**2 + a[3] * T**3 + a[4] * T**4)

    def h_RT_tensor(self, T: torch.Tensor) -> torch.Tensor:
        a = self._coeffs(T)
        return (a[0] + a[1] * T / 2 + a[2] * T**2 / 3 + a[3] * T**3 / 4
                + a[4] * T**4 / 5 + a[5] / T)

    def s_R_tensor(self, T: torch.Tensor) -> torch.Tensor:
        a = self._coeffs(T)
        return (a[0] * torch.log(T) + a[1] * T + a[2] * T**2 / 2
                + a[3] * T**3 / 3 + a[4] * T**4 / 4 + a[6])


def parse_chemkin_thermo(path: str) -> Dict[str, Nasa7]:
    """Parse a CHEMKIN-format NASA7 thermo file (therm.dat)."""
    out: Dict[str, Nasa7] = {}
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    # THERMO header default temperature ranges: 'THERMO' then a line of
    # 'Tlow Tmid Thigh' -- species with a blank T_common field use the
    # global default (CHEMKIN semantics)
    default_mid = 1000.0
    for j, ln in enumerate(lines):
        if ln.strip().upper().startswith("THER"):
            nums = re.findall(r"[-+]?[\d.]+(?:[eE][-+]?\d+)?",
                              lines[j + 1] if j + 1 < len(lines) else "")
            if len(nums) >= 3:
                default_mid = float(nums[1])
            break
    i = 0
    while i < len(lines):
        ln = lines[i]
        if len(ln) >= 80 and ln[79:80] == "1":
            name = ln[:18].split()[0]
            try:
                t_low = float(ln[45:55])
                t_high = float(ln[55:65])
                mid_s = ln[65:73].strip()
                t_mid = float(mid_s) if mid_s else default_mid
            except ValueError:
                i += 1
                continue
            def nums(s, n):
                return [float(s[15 * k : 15 * (k + 1)]) for k in range(n)]
            c = nums(lines[i + 1], 5) + nums(lines[i + 2], 5) \
                + nums(lines[i + 3], 4)
            hi = np.array(c[:7])
            lo = np.array(c[7:14])
            out[name] = Nasa7(t_low, t_mid, t_high, lo, hi)
            i += 4
        else:
            i += 1
    return out


def species_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (species) axis, the species added one after
    another as numpy's reduction over a leading axis adds them."""
    acc = t[0].clone()
    for k in range(1, t.shape[0]):
        acc += t[k]
    return acc


class Mechanism:
    """Species set + optional thermo; the per-tool chemistry context."""

    def __init__(self, species: Sequence[str],
                 thermo: Optional[Dict[str, Nasa7]] = None):
        self.species = list(species)
        self.W = np.array([molecular_weight(s) for s in self.species])
        self.thermo = thermo or {}

    @classmethod
    def from_plotfile_vars(cls, var_names: Sequence[str],
                           prefix: str = "X") -> "Mechanism":
        """Discover species from X(name)/Y(name) plotfile variables
        (plotXtoY.cpp:72-99 naming convention)."""
        pat = re.compile(re.escape(prefix) + r"\(([^)]+)\)$")
        sp = [m.group(1) for n in var_names if (m := pat.match(n))]
        if not sp:
            raise ValueError(f"no {prefix}(species) variables in plotfile")
        return cls(sp)

    def _w(self, t: torch.Tensor) -> torch.Tensor:
        """The weights shaped [nspec, 1, ...] against ``t`` [nspec, ...]."""
        return torch.as_tensor(self.W, dtype=t.dtype, device=t.device) \
            .reshape((-1,) + (1,) * (t.dim() - 1))

    # -- conversions (EOS X<->Y, plotXtoY.cpp / plotYtoX.cpp) ----------------
    def x_to_y(self, X: torch.Tensor) -> torch.Tensor:
        """mole -> mass fractions; X: [nspec, ...]."""
        num = X * self._w(X)
        return num / torch.clamp_min(species_sum(num), 1e-300)

    def y_to_x(self, Y: torch.Tensor) -> torch.Tensor:
        num = Y / self._w(Y)
        return num / torch.clamp_min(species_sum(num), 1e-300)

    def mean_weight_from_y(self, Y: torch.Tensor) -> torch.Tensor:
        return 1.0 / torch.clamp_min(species_sum(Y / self._w(Y)), 1e-300)

    # -- thermo ---------------------------------------------------------------
    def cp_mass(self, T: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """Mixture cp [erg/(g K)] from NASA7 (requires thermo data)."""
        cp = torch.zeros_like(T)
        for k, s in enumerate(self.species):
            th = self.thermo[s]
            cp = cp + Y[k] * th.cp_R_tensor(T) * R_UNIV / float(self.W[k])
        return cp

    def h_mass(self, T: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        h = torch.zeros_like(T)
        for k, s in enumerate(self.species):
            th = self.thermo[s]
            h = h + Y[k] * th.h_RT_tensor(T) * R_UNIV * T / float(self.W[k])
        return h

    def T_from_h(self, h: torch.Tensor, Y: torch.Tensor, T0=1000.0,
                 n_iter: int = 30) -> torch.Tensor:
        """Newton inversion of mixture enthalpy (testTsolve.cpp analog)."""
        T = torch.full_like(h, float(T0))
        for _ in range(n_iter):
            f = self.h_mass(T, Y) - h
            cp = self.cp_mass(T, Y)
            T = torch.clamp(T - f / torch.clamp_min(cp, 1e-300), 200.0,
                            6000.0)
        return T


@dataclasses.dataclass
class SimpleTransport:
    """Mixture transport analog of PelePhysics Transport(Simple): Sutherland
    viscosity, conductivity via Prandtl, species diffusivities via fixed
    Lewis numbers.  Coefficients overridable per run; tensors in, tensors
    out on their device."""

    mu_ref: float = 1.716e-4      # g/(cm s) at T_ref (air, CGS)
    T_ref: float = 273.15
    S_mu: float = 110.4
    prandtl: float = 0.7
    lewis: float = 1.0

    def viscosity(self, T: torch.Tensor) -> torch.Tensor:
        return (self.mu_ref * (T / self.T_ref) ** 1.5
                * (self.T_ref + self.S_mu) / (T + self.S_mu))

    def conductivity(self, T, cp_mass):
        return self.viscosity(T) * cp_mass / self.prandtl

    def diffusivity(self, T, rho, cp_mass, lewis=None):
        le = self.lewis if lewis is None else lewis
        lam = self.conductivity(T, cp_mass)
        return lam / (torch.clamp_min(rho, 1e-300) * cp_mass * le)
