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

Sparse refinement (any level's union bbox wasting >4x its cells, over more
than one level) takes the clustered path (JAX :229-315, amr/cluster.py):
one coarse pass over levels 0..fin-1, then the finest level cluster by
cluster, each cluster's boxes packed into the plotfile before the next is
built.  ``force_dense=1`` builds the union bbox instead; ``fluxMatch=1``
forces it.

``ndevices=N`` (JAX :316-323, :247-276): the dense path cuts the hierarchy
into N deep-halo windows over a spatial mesh (X slabs, or ``mesh_shape=a b
[c]`` blocks; ``parallel/dense_shard.py``) and gathers each window's owned
cells into the plotfile; the clustered path deals the clusters over N
shards (``parallel/cluster_shard.py``).  Shards go round-robin over the
cards (all N on the CPU with ``device=cpu``); the files are the
one-device run's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import config
from ..amr.cluster import clustered, coarse_only_state
from ..amr.dense import DenseAmrState, PlotfileRecords
from ..ops.dense_fill import fill_dense_multilevel
from ..ops.fill import FOEXTRAP, REFLECT_EVEN
from ..ops.grad_kernels import grad_mag
from ..ops.restrict import flux_matched_gradient
from ..ops.stencil import magnitude
from ..parallel.cluster_shard import cluster_mesh, run_clusters_sharded
from ..parallel.dense_shard import (GRAD_STAGES, ShardedDenseState,
                                    mesh_from_pp, run_windows, stencil_halo)
from ..parmparse import ParmParse
from ..session import dense_state, load_state, stage_write_plotfile


def grad_bc(is_per: Sequence[bool], sym_dir: Optional[Sequence[int]] = None):
    ndim = len(is_per)
    bc = []
    for d in range(ndim):
        mode = REFLECT_EVEN if (sym_dir and sym_dir[d]) else FOEXTRAP
        bc.append((mode, mode))
    return tuple(bc)


def refuse_unported(pp: ParmParse) -> None:
    """Options of the JAX tools that the port does not run: raise instead
    of quietly taking another path."""
    if pp.query_int("shape_bucket", 0):
        raise NotImplementedError(
            "shape_bucket= shares XLA compiles and has no PyTorch "
            "counterpart (ROADMAP.md Queue 1: Not to be ported)")
    if pp.query_bool("cluster_batch", False):
        raise NotImplementedError(
            "cluster_batch=1 batches canonical clusters into one XLA "
            "dispatch and has no PyTorch counterpart (ROADMAP.md Queue 1: "
            "Not to be ported); cluster_batch=0 runs the clusters one after "
            "another")


def compute_grad_dense(dstate: DenseAmrState, var: str,
                       aux: Sequence[str] = (),
                       sym_dir: Optional[Sequence[int]] = None,
                       interp: str = "linear",
                       flux_match: bool = False,
                       levels: Optional[Sequence[int]] = None
                       ) -> DenseAmrState:
    """Ghost fill + gradient kernel per level; with ``flux_match`` the
    flux-matched gradient of all levels (plain torch).  ``levels``: the
    levels whose output is computed (every level by default); the others'
    output tensors are None."""
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
        want = range(meta.n_levels) if levels is None else levels
        gcomps = [grad_mag(g.contiguous(), meta.geoms[lev].dx, with_mag=True)
                  if lev in want else None for lev, g in enumerate(grown)]
    out_levels = []
    for lev, gcomp in enumerate(gcomps):
        if gcomp is None:
            out_levels.append(None)
            continue
        passthrough = [dstate.data[lev][dstate.comp(n): dstate.comp(n) + 1]
                       for n in (var,) + tuple(aux)]
        out_levels.append(torch.cat(passthrough + [gcomp], dim=0))
    names = [var, *aux,
             f"{var}_gx", f"{var}_gy", f"{var}_gz", f"||grad{var}||"]
    return dstate.with_data(names, out_levels)


def main(args: dict) -> None:
    """CLI: grad infile=<plt> [gradVar=temp] [outfile=...]
    [Aux_Variables=...] [is_per=1 1 1] [sym_dir=0 0 0] [finestLevel=]
    [cf_interp=quadratic] [fluxMatch=0] [force_dense=0] [cluster_batch=0]
    [ndevices=1 [mesh_shape=a b [c]]  (dense: spatial windows; sparse:
    clusters dealt over the shards)] [device=cuda|cpu]."""
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
    ndev = pp.query_int("ndevices", 1)

    load = [var] + list(aux)
    src = load_state(args, infile, names=load,
                     max_level=finest, is_periodic=[bool(p) for p in is_per],
                     dtype=config.compute_dtype, device=device)
    meta = src.meta
    kw = dict(aux=tuple(aux), sym_dir=sym_dir, interp=interp)
    sparse = clustered(meta, pp, range(meta.n_levels))
    if sparse and flux_match:
        # the clustered path does not flux-match: fall back to the dense
        # path (more device memory) rather than drop the request
        print("grad: fluxMatch forces the dense path on this "
              "sparse-refinement plotfile (higher device memory footprint)")
        sparse = False
    if sparse:
        print("grad: sparse refinement detected -> clustered path")
        n = grad_clustered(meta, src.names, src.fabs, device, var, outfile,
                           mesh=cluster_mesh(ndev, device) if ndev > 1
                           else None, **kw)
        print(f"wrote {outfile} ({n} clusters)")
        return
    if ndev > 1:
        sd = ShardedDenseState(meta, src.names, src.window_source,
                               mesh_from_pp(pp, ndev, device),
                               stencil_halo(GRAD_STAGES, interp, flux_match),
                               config.compute_dtype)
        if write_sharded(args, sd, lambda w: compute_grad_dense(
                w, var, flux_match=flux_match, **kw), outfile):
            print(f"wrote {outfile} ({ndev} shards)")
        return
    dstate = dense_state(args, src, device, config.compute_dtype, load)
    out = compute_grad_dense(dstate, var, flux_match=flux_match, **kw)
    if stage_write_plotfile(args, out, outfile):
        print(f"wrote {outfile}")


def write_sharded(args: dict, sd: ShardedDenseState, fn,
                  outfile: str, windows=None) -> bool:
    """The plotfile of a stencil tool over shard windows: ``fn`` on each
    window (or on each entry of ``windows``, ``run_windows``), its owned
    cells kept on their shards' cards (``ShardGather``), registered in a
    session for later stages and written from there (``write=1``, or
    outside a session).  Returns whether a write was issued."""
    return stage_write_plotfile(
        args, run_windows(sd, fn, windows=windows), outfile)


def grad_clustered(meta, names, fabs, device, var: str, outfile: str,
                   mesh=None, **kw) -> int:
    """The clustered grad (JAX tools/grad.py:256-315): levels 0..fin-1 from
    one coarse pass (a fill never reads finer levels, so they equal the full
    run's), the finest level's boxes from their clusters' runs, which skip
    the coarse levels' gradients.  Only the finest level of a cluster is
    split, whichever level tripped the gate.  ``mesh``: the clusters dealt
    over its shards.  Returns the cluster count."""
    base = DenseAmrState.coarse_only(meta, names, fabs, device,
                                     config.compute_dtype)
    return write_clustered(
        base, fabs[-1], outfile,
        lambda ds: compute_grad_dense(ds, var, **kw),
        lambda sub: compute_grad_dense(sub, var, levels=(meta.n_levels - 1,),
                                       **kw), mesh)


def write_clustered(base: DenseAmrState, fin_fabs, outfile: str,
                    run_coarse, run_cluster, mesh=None) -> int:
    """The plotfile of a clustered stencil tool over a coarse-only ``base``:
    levels 0..fin-1 from ``run_coarse`` of the coarse-only state, then each
    cluster's finest boxes from ``run_cluster`` of its substate (on its
    shard's device with a ``mesh``, ``parallel/cluster_shard.py``), packed
    and copied before the next cluster is built.  Returns the cluster
    count."""
    meta = base.meta
    fin = meta.n_levels - 1
    coarse = run_coarse(coarse_only_state(base))
    out = PlotfileRecords(meta, coarse.names)
    for lev in range(fin):
        out.add(lev, coarse.data[lev], coarse.lmeta[lev].bbox,
                range(len(meta.bas[lev])))
    del coarse
    n = 0
    for g, res in run_clusters_sharded(base, fin_fabs, run_cluster, mesh):
        out.add(fin, res.data[fin], res.lmeta[fin].bbox, g)
        n += 1
        del res
    out.write(outfile)
    return n
