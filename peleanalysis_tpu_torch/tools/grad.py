"""``grad`` — gradient + magnitude of a scalar on all AMR levels.

Counterpart of ``peleanalysis_tpu/tools/grad.py`` (dense path), itself the
replacement for the reference's Src/grad.cpp: read a plotfile variable
(default ``temp``), fill one ghost ring on every level (quadratic
coarse-fine interpolation by default), and write a plotfile with components
``[gradVar, aux..., <var>_gx, <var>_gy, <var>_gz, ||grad<var>||]``.  Each
level's four output components come from one ``grad_mag`` call, the CUDA
kernel on the card.  ``fluxMatch=1`` takes the MLMG-style flux-matched
gradient instead (``ops/restrict.py``), plain torch as in the JAX package,
where that path has no kernel either.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import config
from ..amr.dense import DenseAmrState, needs_clustering
from ..amr.hierarchy import load_plotfile_fabs
from ..ops.dense_fill import fill_dense_multilevel
from ..ops.fill import FOEXTRAP, REFLECT_EVEN
from ..ops.grad_kernels import grad_mag
from ..ops.restrict import flux_matched_gradient
from ..ops.stencil import magnitude
from ..parmparse import ParmParse


def grad_bc(is_per: Sequence[bool], sym_dir: Optional[Sequence[int]] = None):
    ndim = len(is_per)
    bc = []
    for d in range(ndim):
        mode = REFLECT_EVEN if (sym_dir and sym_dir[d]) else FOEXTRAP
        bc.append((mode, mode))
    return tuple(bc)


def refuse_unported(pp: ParmParse) -> None:
    """Options of the JAX tools that the port does not run yet: raise
    instead of quietly taking another path."""
    if pp.query_int("ndevices", 1) > 1:
        raise NotImplementedError(
            "ndevices>1 is not ported yet (ROADMAP.md Queue 1: multi-GPU)")
    if pp.query_int("shape_bucket", 0):
        raise NotImplementedError(
            "shape_bucket= shares XLA compiles and has no PyTorch "
            "counterpart yet (ROADMAP.md Queue 1: sparse refinement)")


def refuse_sparse(meta, levels: Sequence[int]) -> None:
    if meta.n_levels > 1 and any(needs_clustering(meta.bas[l])
                                 for l in levels):
        raise NotImplementedError(
            "sparse refinement (a level's union bbox wastes >4x its cells) "
            "is not ported yet (ROADMAP.md Queue 1: sparse refinement); "
            "pass force_dense=1 to run the dense path anyway")


def compute_grad_dense(dstate: DenseAmrState, var: str,
                       aux: Sequence[str] = (),
                       sym_dir: Optional[Sequence[int]] = None,
                       interp: str = "linear",
                       flux_match: bool = False) -> DenseAmrState:
    """Ghost fill + gradient kernel per level; with ``flux_match`` the
    flux-matched gradient of all levels (plain torch)."""
    meta = dstate.meta
    bc = grad_bc([False] * meta.ndim, sym_dir)
    ic = dstate.comp(var)
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]
    scalars = [d[ic: ic + 1] for d in dstate.data]
    grown = fill_dense_multilevel(meta, dstate.lmeta, scalars, masks, 1, bc,
                                  interp)
    if flux_match:
        # MLMG-style: c-f interface faces take the restricted fine flux
        # (grad.cpp:178-219 composite apply + getFluxes)
        covered = [dstate.covered_mask_np(l) for l in range(meta.n_levels)]
        gall = flux_matched_gradient(meta, dstate.lmeta, grown, covered,
                                     dstate.flux_face_masks)
        gcomps = [torch.cat([*g, magnitude(*g)], dim=0) for g in gall]
    else:
        gcomps = [grad_mag(g.contiguous(), meta.geoms[lev].dx, with_mag=True)
                  for lev, g in enumerate(grown)]
    out_levels = []
    for lev, gcomp in enumerate(gcomps):
        passthrough = [dstate.data[lev][dstate.comp(n): dstate.comp(n) + 1]
                       for n in (var,) + tuple(aux)]
        out_levels.append(torch.cat(passthrough + [gcomp], dim=0))
    names = [var, *aux,
             f"{var}_gx", f"{var}_gy", f"{var}_gz", f"||grad{var}||"]
    return dstate.with_data(names, out_levels)


def main(args: dict) -> None:
    """CLI: grad infile=<plt> [gradVar=temp] [outfile=...]
    [Aux_Variables=...] [is_per=1 1 1] [sym_dir=0 0 0] [finestLevel=]
    [cf_interp=quadratic] [fluxMatch=0] [force_dense=0] [device=cuda|cpu]."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    var = pp.query_str("gradVar", "temp")
    aux = pp.query_str_list("Aux_Variables", [])
    is_per = pp.query_int_list("is_per", [1, 1, 1])
    sym_dir = pp.query_int_list("sym_dir", [0, 0, 0])
    outfile = pp.query_str("outfile", infile + "_gt")
    finest = pp.query_int("finestLevel", None)
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    flux_match = pp.query_bool("fluxMatch", False)
    interp = pp.query_str("cf_interp", "quadratic")

    meta, names, fabs = load_plotfile_fabs(
        infile, names=[var] + list(aux), max_level=finest,
        is_periodic=[bool(p) for p in is_per])
    if not pp.query_bool("force_dense", False):
        refuse_sparse(meta, range(meta.n_levels))
    dstate = DenseAmrState.from_level_fabs(meta, names, fabs, device,
                                           config.compute_dtype)
    out = compute_grad_dense(dstate, var, aux=tuple(aux), sym_dir=sym_dir,
                             interp=interp, flux_match=flux_match)
    out.to_plotfile(outfile)
    print(f"wrote {outfile}")
