"""``amrToFE`` — the valid AMR hierarchy as an unstructured finite-element
mesh.

Counterpart of ``peleanalysis_tpu/tools/amr_to_fe.py``, itself the
replacement for the reference's Src/amrToFE.cpp.  ``connect_cc=1`` (the
default, amrToFE.cpp:93-113): nodes at the valid cells' centres, one
8-node brick (a 4-node quad on a DIM=2 plotfile) wherever the 2x2x2
corners of a level's dual grid are all valid; coarse-fine seams stay open
as in the reference's per-level meshing.  ``connect_cc=0``: nodes at the
cells' corners, valued by the mean of the adjacent valid cells, one
element per valid cell.  ``box=`` keeps the refined images of a level-0
box (amrToFE.cpp:374-387), ``nGrowPer=`` grows periodic levels first.

Everything is built on the device: node ids are the exclusive cumsum of
the valid mask in C order (``torch.nonzero`` is C order, so the numbering
is ``np.argwhere``'s), and the element corners are gathered there.
Output: Tecplot ASCII (``outType=tec``, the native ``%.9g`` formatter) or
the raw ``flt`` tables, cast on the device and written from pinned host
copies.  Computes in the compute dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import config
from ..amr.box import Box
from ..amr.dense import DenseAmrState
from ..native import savetxt_fast
from ..parmparse import ParmParse
from ..session import load_dense, var_names
from .grad import refuse_unported

BRICK = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),     # Tecplot FEBRICK
         (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
QUAD = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))


def _wrap(t: torch.Tensor, pads) -> torch.Tensor:
    """``np.pad(mode="wrap")`` of the last three axes."""
    for d, (lo, hi) in enumerate(pads):
        if lo or hi:
            ax = t.ndim - 3 + d
            n = t.shape[ax]
            idx = torch.arange(-lo, n + hi, device=t.device) % n
            t = torch.index_select(t, ax, idx)
    return t


def _numbered(mask: torch.Tensor):
    """(node id grid, C-order indices) of the True cells of ``mask``."""
    flat = mask.reshape(-1)
    ids = torch.cumsum(flat.to(torch.int64), 0) - 1
    return torch.where(flat, ids, -1).reshape(mask.shape), \
        torch.nonzero(mask)


def _corners(node_id: torch.Tensor, base: torch.Tensor, offs):
    """[M, len(offs)] node ids at ``base + o`` for each corner offset."""
    o = torch.tensor(offs, dtype=torch.int64, device=base.device)
    c = base[:, None, :] + o[None]
    return node_id[c[..., 0], c[..., 1], c[..., 2]]


def level_fe_mesh(ds: DenseAmrState, lev: int, names: Sequence[str],
                  sub: Optional[Box] = None, connect_cc: bool = True,
                  n_grow_per: int = 0):
    """(nodes [N, 3+ncomp] float64, elements [M, 8|4] int64) of one level,
    on the state's device."""
    meta = ds.meta
    geom = meta.geoms[lev]
    bbox = ds.lmeta[lev].bbox
    dev = ds.device
    valid = ds.valid_mask(lev)
    data = ds.data[lev][[ds.comp(n) for n in names]]
    if n_grow_per > 0:
        pads = [(n_grow_per, n_grow_per) if geom.is_periodic[d] else (0, 0)
                for d in range(3)]
        valid = _wrap(valid, pads)
        data = _wrap(data, pads)
        bbox = Box(tuple(bbox.lo[d] - pads[d][0] for d in range(3)),
                   tuple(bbox.hi[d] + pads[d][1] for d in range(3)))
    if sub is not None:
        s = sub
        for l in range(lev):
            s = s.refine(meta.ref_ratio[l])
        box_mask = torch.zeros_like(valid)
        isect = bbox.intersect(s)
        if not isect.is_empty():
            box_mask[tuple(slice(isect.lo[d] - bbox.lo[d],
                                 isect.hi[d] - bbox.lo[d] + 1)
                           for d in range(3))] = True
        valid = valid & box_mask
    two_d = valid.shape[2] == 1     # promoted DIM=2 plotfile (nz == 1)
    f64 = dict(dtype=torch.float64, device=dev)
    off = torch.tensor([bbox.lo[d] - geom.domain.lo[d] for d in range(3)],
                       dtype=torch.int64, device=dev)
    dx = torch.tensor(geom.dx, **f64)
    plo = torch.tensor(geom.prob_lo, **f64)
    if not connect_cc:
        return _corner_mesh(valid, data, off, dx, plo, two_d)
    node_id, idx = _numbered(valid)
    pos = ((idx + off).to(torch.float64) + 0.5) * dx + plo
    nodes = torch.cat([pos, data[:, valid].T.to(torch.float64)], dim=1)
    sx, sy, sz = valid.shape
    if two_d:
        # 4-node quads in the z=0 plane
        ok = valid[:-1, :-1, :]
        for o in QUAD[1:]:
            ok = ok & valid[o[0]: sx - 1 + o[0], o[1]: sy - 1 + o[1], :]
        offs = QUAD
    else:
        ok = valid[:-1, :-1, :-1]
        for o in BRICK[1:]:
            ok = ok & valid[o[0]: sx - 1 + o[0], o[1]: sy - 1 + o[1],
                            o[2]: sz - 1 + o[2]]
        offs = BRICK
    return nodes, _corners(node_id, torch.nonzero(ok), offs)


def _corner_mesh(valid, data, off, dx, plo, two_d: bool):
    """connect_cc=0: one element per valid cell; nodes at the cell corners
    with values averaged from the adjacent valid cells (float64, in the
    JAX version's order of accumulation)."""
    sx, sy, sz = valid.shape
    z_offs = (0,) if two_d else (0, 1)
    nshape = (sx + 1, sy + 1, sz + (0 if two_d else 1))
    f64 = dict(dtype=torch.float64, device=valid.device)
    acc = torch.zeros((data.shape[0],) + nshape, **f64)
    cnt = torch.zeros(nshape, **f64)
    v = valid.to(torch.float64)
    dv = data.to(torch.float64) * v
    for oi in (0, 1):
        for oj in (0, 1):
            for ok in z_offs:
                sl = (slice(oi, sx + oi), slice(oj, sy + oj),
                      slice(ok, sz + ok))
                cnt[sl] += v
                acc[(slice(None),) + sl] += dv
    used = cnt > 0
    vals = acc / torch.clamp(cnt, min=1.0)
    node_id, idx = _numbered(used)
    pos = (idx + off).to(torch.float64) * dx + plo
    if two_d:   # cell-centre z for the single plane
        pos[:, 2] += 0.5 * dx[2]
    nodes = torch.cat([pos, vals[:, used].T], dim=1)
    return nodes, _corners(node_id, torch.nonzero(valid),
                           QUAD if two_d else BRICK)


def _pinned(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host: one copy into pinned memory from a card."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def write_tec_febrick(path: str, names: Sequence[str], zones) -> None:
    with open(path, "wb") as f:
        f.write(("VARIABLES = X Y Z " + " ".join(names) + "\n").encode())
        for zi, (nodes, elems) in enumerate(zones):
            if len(nodes) == 0:
                continue
            npe = elems.shape[1]
            et = "QUADRILATERAL" if npe == 4 else "BRICK"
            f.write((f'ZONE T="level{zi}" N={len(nodes)} '
                     f"E={max(len(elems), 1)} F=FEPOINT ET={et}\n").encode())
            savetxt_fast(f, _pinned(nodes), fmt="%.9g")
            if len(elems) == 0:
                f.write((" ".join(["1"] * npe) + "\n").encode())
            else:
                savetxt_fast(f, _pinned(elems + 1), fmt="%d")


def write_flt(path: str, names: Sequence[str], zones) -> None:
    """Raw tables: the zone count, then per zone [N, ncols, M] int32, the
    nodes as float32 and the elements as int32 (amrToFE.cpp "flt")."""
    with open(path, "wb") as f:
        np.int32(len(zones)).tofile(f)
        for nodes, elems in zones:
            np.array([nodes.shape[0], nodes.shape[1], elems.shape[0]],
                     dtype=np.int32).tofile(f)
            _pinned(nodes.to(torch.float32)).tofile(f)
            _pinned(elems.to(torch.int32)).tofile(f)


def main(args: dict) -> None:
    """CLI: amrToFE infile= [vars=all | comps= | sComp= nComp=]
    [outType=tec|flt] [connect_cc=1] [box=lo... hi...] [nGrowPer=0]
    [finestLevel=] [outfile=<infile>.dat|.flt] [device=cuda|cpu]."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    avail = var_names(args, infile)
    names = pp.query_str_list(
        "comps", None) or pp.query_str_list("vars", avail)
    if pp.contains("sComp") or pp.contains("nComp"):
        s = pp.query_int("sComp", 0)        # comp range (amrToFE.cpp:365-367)
        names = avail[s: s + pp.query_int("nComp", 1)]
    if pp.query_bool("doBin", False):
        print("amrToFE: doBin=1 (binary Tecplot, USE_TEC_BIN_IO build "
              "option) is not supported — writing ASCII")
    ds = load_dense(args, infile, device, config.compute_dtype,
                    names=list(dict.fromkeys(names)),
                    max_level=pp.query_int("finestLevel", None))
    sub = None
    if pp.contains("box"):
        b = pp.get_int_list("box")
        sub = Box(tuple(b[:3]), tuple(b[3:6]))
    connect_cc = pp.query_bool("connect_cc", True)
    n_grow_per = pp.query_int("nGrowPer", 0)
    zones = [level_fe_mesh(ds, lev, names, sub, connect_cc, n_grow_per)
             for lev in range(ds.meta.n_levels)]
    out_type = pp.query_str("outType", "tec")
    outfile = pp.query_str("outfile",
                           infile + (".dat" if out_type == "tec" else ".flt"))
    if out_type == "tec":
        write_tec_febrick(outfile, names, zones)
    else:
        write_flt(outfile, names, zones)
    print(f"wrote {outfile}")
