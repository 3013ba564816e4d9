"""The inputs of every run, made from ``--seed``.

A configuration's ``kind`` names the module ``kinds/<kind>.py`` that
makes its fields; this one writes them.  Fields are evaluated in float64
on the run's device, level by level, in large calls, and come to the host
once a piece in the FAB order.  A piece is as many of a level's
components as fit in ``PIECE_BYTES`` over the level's box, one where a
single component does not: so neither the card nor the host holds more
than a piece, and a level that fits is written in one.  ``level_fields``
gives the same dense arrays to the reference.
"""
from __future__ import annotations

import shutil
from typing import Dict, List, Tuple

import numpy as np
import torch

from .amr import (Hierarchy, box_shape, hierarchy as box_hierarchy,
                  level_bytes, write_plotfile)
from .spec import load_kind

PIECE_BYTES = 1 << 30


class NoRoom(OSError):
    """The inputs would not fit on the disk."""


def hierarchy(cfg: dict) -> Hierarchy:
    """The configuration's levels: its kind's own rule, or the boxes its
    file states."""
    return getattr(load_kind(cfg["kind"]), "hierarchy", box_hierarchy)(cfg)


def level_fields(cfg: dict, h: Hierarchy, seed: int, member: int, lev: int,
                 device, dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """Dense fields of one level's bounding box, by name."""
    return load_kind(cfg["kind"]).level_fields(cfg, h, seed, member, lev,
                                               device, dtype)


def input_bytes(cfg: dict, n_plotfiles: int) -> int:
    """Bytes of the FAB records of a run's plotfiles, known from the
    hierarchy and the components before any is written."""
    nc = len(cfg["components"])
    return n_plotfiles * sum(level_bytes(bs, nc)
                             for bs in hierarchy(cfg).boxes)


def check_room(need: int, where: str) -> None:
    """Raise ``NoRoom`` where ``need`` bytes do not fit under ``where``."""
    free = shutil.disk_usage(where).free
    if need > free:
        raise NoRoom(f"the inputs need {need} B and {where} has {free} B "
                     "free")


def pieces(h: Hierarchy, lev: int, nc: int) -> List[Tuple[int, int]]:
    """Component ranges ``(c0, c1)`` of level ``lev``: as many float64
    components of its box a piece as ``PIECE_BYTES`` holds, at least
    one."""
    per = max(1, PIECE_BYTES // (8 * int(np.prod(box_shape(h.bboxes[lev])))))
    return [(c, min(c + per, nc)) for c in range(0, nc, per)]


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
    """The run's plotfiles, one member each, written from the seed.  A
    kind's ``level_fields`` makes the components ``names`` asks for."""
    kind = load_kind(cfg["kind"])
    if hasattr(kind, "write_inputs"):
        return kind.write_inputs(cfg, seed, paths, device)
    h = hierarchy(cfg)
    names = cfg["components"]

    def level(member: int, lev: int):
        for c0, c1 in pieces(h, lev, len(names)):
            part = names[c0:c1]
            f = kind.level_fields(cfg, h, seed, member, lev, device,
                                  names=part)
            payload = _fab_payload([f.pop(n) for n in part], h, lev)
            del f
            yield c0, c1, payload

    for member, path in enumerate(paths):
        write_plotfile(path, h, names,
                       [level(member, lev) for lev in range(h.n_levels)],
                       time=float(member))
    return h
