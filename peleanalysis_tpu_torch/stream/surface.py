"""Streamline-derived surface operations: alt-surface construction and the
per-line decorators (thermal thickness, cold-side strain, inclination angle).

A copy of ``peleanalysis_tpu/stream/surface.py``; the crossing search,
the station interpolation and the arclength run in torch, on tensors of
any device (stream2plt's predicates and streamTubeStats on the card) and
on numpy arrays through torch on the CPU, bitwise as numpy computes them.

Replaces the reference's per-line scan -> MPI_Gatherv -> IOProc descramble
pattern (reference Src/stream.cpp:1840-2074 build_surface_at_isoVal,
:1554-1840 add_thermal_thickness_to_surf, :1369-1553 add_cold_strain_to_surf,
:1211-1368 add_angle_to_surf) with vectorized crossing searches over the
resident [nlines, npts, nvars] array — no communication needed.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.vec3 import sqrt


def _on_torch(fn):
    """Run a torch implementation on numpy arguments too: they go through
    torch on the CPU (no copy) and the results come back as numpy."""
    @functools.wraps(fn)
    def wrapper(*args):
        if not any(isinstance(a, np.ndarray) for a in args):
            return fn(*args)
        out = fn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                   for a in args))
        if isinstance(out, tuple):
            return tuple(o.numpy() for o in out)
        return out.numpy()
    return wrapper


@_on_torch
def _crossings_from_mid(vals, target: float):
    """The reference's per-line crossing scan, vectorized (all three
    decorators share it: stream.cpp:1895-1930 / 1420-1446 / 1670-1700).
    From the line's LOW end, take the first upward bracket
    ``lVal <= target < rVal``; when ``target <= v[lo]`` clamp to the low
    endpoint (frac=0), when ``target > v[hi]`` clamp to the last interval
    (frac=1); a non-monotone line with no upward bracket walks to the last
    interval and lerps from it, exactly like the reference's loop falling
    through.  (r5 review fix: the previous version scanned outward from
    the MIDPOINT and zero-filled unfound lines.)

    vals: [nl, npts] (a tensor on any device, or numpy).  Returns (jlo
    [nl], frac [nl], found [nl]) — found marks a genuine bracket; clamped
    values are still usable (the reference uses them unconditionally)."""
    nl, npts = vals.shape
    r = torch.arange(nl, device=vals.device)
    up = (vals[:, :-1] <= target) & (vals[:, 1:] > target)
    found = up.any(dim=1)
    # the first upward bracket (argmax returns the first maximum)
    jlo = torch.argmax(up.to(torch.int32), dim=1)
    a = vals[r, jlo]
    b = vals[r, jlo + 1]
    frac = torch.where(b != a, (target - a) / torch.where(b != a, b - a,
                                                          1.0), 0.0)
    above = target > vals[:, -1]           # clamp to the hi end
    at_lo = ~above & ~(target > vals[:, 0])  # clamp to the lo end
    # unfound within range: the reference's scan exhausts and lerps from
    # the last interval
    tail = ~found & ~above & ~at_lo
    la, lb = vals[:, -2], vals[:, -1]
    f_last = torch.where(lb != la, (target - la) / torch.where(
        lb != la, lb - la, 1.0), 0.0)
    jlo = torch.where(above | tail, npts - 2, torch.where(at_lo, 0, jlo))
    frac = torch.where(above, 1.0, torch.where(
        at_lo, 0.0, torch.where(tail, f_last, frac)))
    return jlo, frac, found


@_on_torch
def _interp_at(lines, jlo, frac):
    """Linear interp of all comps at station jlo+frac. [nl, nvars]."""
    r = torch.arange(lines.shape[0], device=lines.device)
    a = lines[r, jlo]
    b = lines[r, jlo + 1]
    return a + frac[:, None] * (b - a)


def build_surface_at_isoval(lines: np.ndarray, names, comp_name: str,
                            iso_val: float, with_distance: bool = False):
    """Point on each line where comp crosses iso_val (the alt-surface nodes,
    stream.cpp:1840-2074).  Returns (points [nl, nvars], found [nl]) — or
    (points, found, distance [nl]) with with_distance: the arclength from
    the seed station (j=0) to the crossing, the reference's
    ``distance_iso_to_alt`` surface variable (stream.cpp:1008,1636-1650)."""
    c = names.index(comp_name)
    jlo, frac, found = _crossings_from_mid(lines[:, :, c], iso_val)
    pts = _interp_at(lines, jlo, frac)
    if not with_distance:
        return pts, found
    s = arc_length(lines)
    nl = lines.shape[0]
    mid = (lines.shape[1] - 1) // 2
    s_cross = (s[np.arange(nl), jlo]
               + frac * (s[np.arange(nl), jlo + 1]
                         - s[np.arange(nl), jlo]))
    # SIGNED distance from the seed station (stream.cpp:1946-1977 subtracts
    # when the crossing lies upstream of j=0; r5 review fix: abs() hid
    # which side of the seed surface the alt surface sits on)
    dist = s_cross - s[:, mid]
    return pts, found, dist


@_on_torch
def arc_length(lines):
    """Cumulative arclength along each line [nl, npts] (a tensor on any
    device, or numpy); each step's length is numpy's norm,
    sqrt((dx*dx + dy*dy) + dz*dz)."""
    d = lines[:, 1:, :3] - lines[:, :-1, :3]
    d = d * d
    seg = sqrt((d[..., 0] + d[..., 1]) + d[..., 2])
    return torch.cat([torch.zeros((lines.shape[0], 1), dtype=lines.dtype,
                                  device=lines.device),
                      torch.cumsum(seg, dim=1)], dim=1)


def thermal_thickness(lines: np.ndarray, names, thick_comp: str,
                      lo_val: float, hi_val: float) -> np.ndarray:
    """Arclength between the loVal and hiVal crossings of thick_comp
    (add_thermal_thickness_to_surf, stream.cpp:1554-1840)."""
    c = names.index(thick_comp)
    s = arc_length(lines)
    jl, fl, okl = _crossings_from_mid(lines[:, :, c], lo_val)
    jh, fh, okh = _crossings_from_mid(lines[:, :, c], hi_val)
    nl = lines.shape[0]
    sl = s[np.arange(nl), jl] + fl * (s[np.arange(nl), jl + 1]
                                      - s[np.arange(nl), jl])
    sh = s[np.arange(nl), jh] + fh * (s[np.arange(nl), jh + 1]
                                      - s[np.arange(nl), jh])
    # clamped crossings are used as-is, like the reference's fall-through
    # loop (stream.cpp:1670-1760); no zero-fill
    return np.abs(sh - sl)


def cold_strain(lines: np.ndarray, names, strain_comp: str, t_comp: str,
                t_val: float) -> np.ndarray:
    """strain sampled where t_comp crosses t_val (add_cold_strain_to_surf,
    stream.cpp:1369-1553)."""
    ct = names.index(t_comp)
    cs = names.index(strain_comp)
    jlo, frac, _found = _crossings_from_mid(lines[:, :, ct], t_val)
    # clamped crossings are sampled as-is (stream.cpp:1448-1451 uses
    # lIdx/rIdx/frac unconditionally)
    return _interp_at(lines, jlo, frac)[:, cs]


def inclination_angle(lines: np.ndarray, up_dir: int = 2) -> np.ndarray:
    """Angle (RADIANS, [0, pi]) of the line through the two points
    bracketing the midpoint vs vertical: acos(dx[up]/|dx|) with
    dx = pth(mid-1) - pth(mid+1) (add_angle_to_surf, stream.cpp:1248-1266;
    r5 review fix: this returned degrees from the Y axis with the sign
    folded by abs(), so no value could exceed 90 deg)."""
    mid = (lines.shape[1] - 1) // 2
    d = lines[:, mid - 1, :3] - lines[:, mid + 1, :3]
    n = np.linalg.norm(d, axis=1)
    cosang = d[:, up_dir] / np.maximum(n, 1e-300)
    return np.arccos(np.clip(cosang, -1.0, 1.0))


def advect_points(points: np.ndarray, names, dt: float) -> np.ndarray:
    """Advance surface points by u*dt (stream.cpp:1038-1103).  Only the
    velocity components present advance their axis (a DIM=2 plotfile has
    no z_velocity — r5 review fix: names.index raised after the whole
    integration had completed)."""
    out = points.copy()
    for d, n in enumerate(("x_velocity", "y_velocity", "z_velocity")):
        if n in names:
            out[:, d] += dt * points[:, names.index(n)]
    return out
