"""The inputs of every run, made from ``--seed``.

A configuration's ``kind`` names the module ``kinds/<kind>.py`` that
makes its fields; this one writes them.  Fields are evaluated in float64
on the run's device, level by level, in large calls, and come to the host
once a level in the FAB order.  ``level_fields`` gives the same dense
arrays to the reference.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .amr import Hierarchy, hierarchy as box_hierarchy, write_plotfile
from .spec import load_kind


def hierarchy(cfg: dict) -> Hierarchy:
    """The configuration's levels: its kind's own rule, or the boxes its
    file states."""
    return getattr(load_kind(cfg["kind"]), "hierarchy", box_hierarchy)(cfg)


def level_fields(cfg: dict, h: Hierarchy, seed: int, member: int, lev: int,
                 device, dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """Dense fields of one level's bounding box, by name."""
    return load_kind(cfg["kind"]).level_fields(cfg, h, seed, member, lev,
                                               device, dtype)


def _fab_payload(fields: List[torch.Tensor], h: Hierarchy,
                 lev: int) -> torch.Tensor:
    """Every box of the level in turn, ``[comp, k, j, i]`` each, in one
    host array (one device-to-host copy)."""
    lo = h.bboxes[lev][0]
    d = torch.stack(fields)
    parts = []
    for b in h.boxes[lev]:
        sl = tuple(slice(b[0][a] - lo[a], b[1][a] - lo[a] + 1)
                   for a in range(3))
        parts.append(d[(slice(None),) + sl].permute(0, 3, 2, 1).reshape(-1))
    return torch.cat(parts).cpu().numpy()


def write_inputs(cfg: dict, seed: int, paths: List[str], device) -> Hierarchy:
    """The run's plotfiles, one member each, written from the seed."""
    kind = load_kind(cfg["kind"])
    if hasattr(kind, "write_inputs"):
        return kind.write_inputs(cfg, seed, paths, device)
    h = hierarchy(cfg)
    names = cfg["components"]
    for member, path in enumerate(paths):
        payloads = []
        for lev in range(h.n_levels):
            f = kind.level_fields(cfg, h, seed, member, lev, device)
            payloads.append(_fab_payload([f.pop(n) for n in names], h, lev))
            del f
        write_plotfile(path, h, names, payloads, time=float(member))
    return h
