"""``curvature`` — mean/Gaussian curvature, flame normal, strain of a
progress-variable field.

Counterpart of ``peleanalysis_tpu/tools/curvature.py`` (dense path), itself
the replacement for the reference's Src/curvature.cpp.  Semantics:

  * progress var c = (s - progMin)/(progMax - progMin), min/max scanned from
    the file unless given (curvature.cpp:137-158, 308-321)
  * optional implicit smoothing (I - beta lap) c~ = c (curvature.cpp:328-406):
    a composite CG over all levels (the MLMG analog: covered coarse cells
    follow the fine solution by average_down, ghosts couple fine to coarse
    through the fill) or a per-level CG, coarse to fine, with the coarse-fine
    values pinned (ops/solve.py)
  * G = grad c~ (centered on filled ghosts); normgrad = -max(1e-14, |G|)
    (curvature.cpp:465-484)
  * flame normal N = G / normgrad = -G/|G| (curvature.cpp:487-501)
  * MeanCurvature = 0.5 * div(N) (curvature.cpp:508-546), each dN_i/dx_i
    taken after a fill of N_i from the coarser level's N_i
  * GaussianCurvature = (G . adj(H) . G)/normgrad^4, H_ij = d G_i/dx_j as a
    gradient of the gradient (curvature.cpp:578-673)
  * StrainRate = -NN:grad u + div u; replicate_strain_bug=1 reproduces the
    reference's overwrite at curvature.cpp:745 (div u only)
  * optional strain tensor ROST_dU[xyz]d[xyz] and VelFlameNormal = u.N
    (curvature.cpp:754-789)
  * thresholding: Km, N, Kg, VelFlameNormal zeroed where c < threshold or
    c > 1-threshold (curvature.cpp:560-567)

Every gradient is one ``grad_mag`` call per level (the CUDA kernel on the
card): G with its magnitude, then N_x, N_y, N_z and, with Gaussian
curvature, G_x, G_y, G_z without it — 7 launches per level, 3 more with
strain.  The smoothing solve launches no gradient kernel: its Laplacian is
plain torch.

Sparse refinement (the finest union bbox wasting >4x its cells) takes the
clustered path (JAX ``_main_clustered``, :494-589): the progress bounds are
scanned globally, then one coarse pass writes levels 0..fin-1 and each
cluster's run, over every level, its finest boxes.  ``do_smooth=1`` needs
the composite solve over the whole hierarchy and keeps the dense path.

``ndevices=N``: the dense path runs the chain on N deep-halo windows (two
fill-and-stencil stages deep: ``parallel/dense_shard.py``) after one global
progress min/max scan of the host FABs; the clustered path deals its
clusters over N shards.  ``do_smooth=1`` with ``ndevices>1`` is refused:
the composite solve is elliptic, so no finite halo makes a window exact
(ROADMAP.md Queue 1 item 9b).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import config
from ..amr.cluster import clustered
from ..amr.dense import DenseAmrState, _np_dtype, covered_mask_over
from ..ops.dense_fill import fill_dense_arrays, fill_dense_multilevel
from ..ops.grad_kernels import grad_mag
from ..ops.restrict import average_down_all
from ..ops.solve import cg_solve, cg_solve_composite
from ..ops.stencil import laplacian
from ..parallel.cluster_shard import cluster_mesh
from ..parallel.dense_shard import (CURVATURE_STAGES, ShardedDenseState,
                                    mesh_from_pp, refuse_unsharded,
                                    stencil_halo)
from ..parmparse import ParmParse
from ..session import (dense_state, get_session, load_state,
                       stage_write_plotfile, var_names)
from .grad import grad_bc, refuse_unported, write_clustered, write_sharded

D = 3


def _masked_minmax(vs, ms) -> torch.Tensor:
    """Global masked (min, max) over a list of (value, mask) level arrays,
    as one 2-element tensor (one host fetch)."""
    los = [torch.where(m, v, float("inf")).min() for v, m in zip(vs, ms)]
    his = [torch.where(m, v, float("-inf")).max() for v, m in zip(vs, ms)]
    return torch.stack([torch.stack(los).min(), torch.stack(his).max()])


def _file_minmax(pairs):
    lo_hi = _masked_minmax([p[0] for p in pairs],
                           [p[1] for p in pairs]).cpu()
    return float(lo_hi[0]), float(lo_hi[1])


def _grad_multilevel(meta, lmeta, field_list, mask_list, bc, interp,
                     with_mag: bool = False):
    """Per-level gradients of a multi-level scalar field, each level's ghosts
    filled from the coarser level of the SAME derived field (the reference's
    setCoarseFineBC pattern).  Returns per level [3, *bbox] (gx, gy, gz), or
    [4, *bbox] with the magnitude."""
    grown = fill_dense_multilevel(meta, lmeta, field_list, mask_list, 1,
                                  bc, interp)
    return [grad_mag(g.contiguous(), meta.geoms[lev].dx, with_mag)
            for lev, g in enumerate(grown)]


def _smooth(meta, lmeta, prog, mask_list, valid_masks, covered_masks, bc,
            interp, composite, smooth_time, smooth_iters, smooth_rtol):
    """The smoothing solve (I - smooth_time lap) c~ = c of the progress
    variable, composite or level by level (curvature.cpp:328-406)."""
    L = meta.n_levels
    if composite:
        # one solve over the valid cells of all levels: covered coarse cells
        # track the fine solution via average_down, ghosts couple fine to
        # coarse via the fill, both inside the operator
        vols = [meta.geoms[lev].cell_volume() for lev in range(L)]

        def apply_A(x_list):
            xd = average_down_all(meta, lmeta, x_list, covered_masks)
            grown = fill_dense_multilevel(meta, lmeta, xd, mask_list, 1, bc,
                                          interp)
            return [xd[lev] - smooth_time
                    * laplacian(grown[lev], meta.geoms[lev].dx, 1)
                    for lev in range(L)]

        smoothed = cg_solve_composite(apply_A, prog, prog, valid_masks, vols,
                                      smooth_iters, rtol=smooth_rtol)
        return average_down_all(meta, lmeta, smoothed, covered_masks)
    smoothed = list(prog)
    for lev in range(L):
        dx = meta.geoms[lev].dx

        def apply_A(x, lev=lev, dx=dx):
            flds = smoothed[:lev] + [x] + prog[lev + 1:]
            grown = fill_dense_arrays(meta, lmeta, flds, mask_list, lev, 1,
                                      bc, interp)
            return x - smooth_time * laplacian(grown, dx, 1)

        smoothed[lev] = cg_solve(apply_A, prog[lev], prog[lev],
                                 mask_list[lev][None], smooth_iters,
                                 rtol=smooth_rtol)
    return smoothed


def _make_pipeline(meta, lmeta, ic, iv, bc, interp, do_smooth,
                   smooth_composite, smooth_time, smooth_iters, smooth_rtol,
                   do_gauss, do_strain, get_strain_tensor, do_velnormal,
                   do_threshold, threshold, replicate_strain_bug):
    """The curvature derived-field chain as a function of per-level
    tensors (closes over metadata and flags only)."""
    need_vel = do_strain or do_velnormal
    L = meta.n_levels

    def pipeline(data_list, mask_list, pmin, pmax, valid_masks=None,
                 covered_masks=None):
        def grads(fields, with_mag=False):
            return _grad_multilevel(meta, lmeta, fields, mask_list, bc,
                                    interp, with_mag)

        scal = [d[ic: ic + 1] for d in data_list]
        inv = 1.0 / (pmax - pmin)
        prog = [(s - pmin) * inv for s in scal]
        smoothed = (_smooth(meta, lmeta, prog, mask_list, valid_masks,
                            covered_masks, bc, interp, smooth_composite,
                            smooth_time, smooth_iters, smooth_rtol)
                    if do_smooth else prog)

        # -- gradient of the progress variable, with its magnitude -----------
        gm = grads(smoothed, with_mag=True)
        G = [g[:3] for g in gm]
        normg = [-torch.clamp_min(g[3:4], 1e-14) for g in gm]
        N = [G[lev] / normg[lev] for lev in range(L)]

        # -- mean curvature: 0.5 * div(N) -------------------------------------
        gN = [grads([N[l][d: d + 1] for l in range(L)]) for d in range(D)]
        Km = [0.5 * sum(gN[d][lev][d: d + 1] for d in range(D))
              for lev in range(L)]

        # -- Gaussian curvature ------------------------------------------------
        Kg = []
        if do_gauss:
            gG = [grads([G[l][i: i + 1] for l in range(L)]) for i in range(D)]
            for lev in range(L):
                H = [[gG[i][lev][j] for j in range(D)] for i in range(D)]
                adj = [[H[(i + 1) % 3][(j + 1) % 3] * H[(i + 2) % 3][(j + 2) % 3]
                        - H[(i + 1) % 3][(j + 2) % 3] * H[(i + 2) % 3][(j + 1) % 3]
                        for j in range(D)] for i in range(D)]
                Gl = G[lev]
                num = 0.0
                for i in range(D):
                    for j in range(D):
                        num = num + Gl[i] * adj[i][j] * Gl[j]
                # normg**4 as (n*n)*(n*n), the JAX integer_pow order; it
                # underflows to 0 in float32 where |G| = 0 (0/0 there, as in
                # the JAX reference)
                n2 = normg[lev][0] * normg[lev][0]
                Kg.append((num / (n2 * n2))[None])

        # -- strain ------------------------------------------------------------
        SR, ROST, VN = [], [], []
        if need_vel:
            vel = [torch.stack([d[k] for k in iv], dim=0) for d in data_list]
            if len(iv) == 2:  # planar: zero z component
                vel = [torch.cat([v, torch.zeros_like(v[:1])], dim=0)
                       for v in vel]
        if do_strain:
            gU = [grads([vel[l][i: i + 1] for l in range(L)])
                  for i in range(D)]
            for lev in range(L):
                gradU = [[gU[i][lev][j] for j in range(D)] for i in range(D)]
                divu = gradU[0][0] + gradU[1][1] + gradU[2][2]
                if replicate_strain_bug:
                    sr = divu  # reference's overwrite at curvature.cpp:745
                else:
                    nn = 0.0
                    for i in range(D):
                        for j in range(D):
                            nn = nn + gradU[i][j] * N[lev][i] * N[lev][j]
                    sr = -nn + divu
                SR.append(sr[None])
                if get_strain_tensor:
                    ROST.append(torch.stack(
                        [gradU[i][j] for i in range(D) for j in range(D)]))
        if do_velnormal:
            VN = [torch.sum(vel[lev] * N[lev], dim=0, keepdim=True)
                  for lev in range(L)]

        # -- thresholding ------------------------------------------------------
        outs = []
        for lev in range(L):
            Nl = N[lev]
            if do_threshold:
                bad = ((prog[lev] < threshold)
                       | (prog[lev] > 1.0 - threshold))
                Km[lev] = Km[lev].masked_fill(bad, 0.0)
                Nl = Nl.masked_fill(bad, 0.0)
                if do_gauss:
                    Kg[lev] = Kg[lev].masked_fill(bad, 0.0)
                if do_velnormal:
                    VN[lev] = VN[lev].masked_fill(bad, 0.0)
            comps = [data_list[lev][ic: ic + 1]]
            if need_vel:
                comps.append(vel[lev])
            comps += [prog[lev], smoothed[lev], Km[lev], Nl]
            if do_gauss:
                comps.append(Kg[lev])
            if do_strain:
                comps.append(SR[lev])
            if get_strain_tensor:
                comps.append(ROST[lev])
            if do_velnormal:
                comps.append(VN[lev])
            outs.append(torch.cat(comps, dim=0))
        return outs

    return pipeline


def compute_curvature_dense(
    dstate: DenseAmrState,
    progress_name: str = "temp",
    prog_min: Optional[float] = None,
    prog_max: Optional[float] = None,
    do_smooth: bool = False,
    smooth_time: float = 1.0e-7,
    smooth_iters: int = 50,
    smooth_rtol: Optional[float] = 1.0e-10,
    smooth_composite: bool = True,
    do_gauss: bool = True,
    do_strain: bool = False,
    get_strain_tensor: bool = False,
    do_velnormal: bool = False,
    do_threshold: bool = False,
    threshold: float = 1.0e-4,
    use_file_minmax: bool = True,
    replicate_strain_bug: bool = False,
    sym_dir: Optional[Sequence[int]] = None,
    interp: str = "linear",
) -> DenseAmrState:
    meta = dstate.meta
    bc = grad_bc([False] * D, sym_dir)
    ic = dstate.comp(progress_name)
    need_vel = do_strain or do_velnormal
    # DIM=2 plotfiles carry no z_velocity: planar flow, zero-z promotion
    vel_names = [n for n in ("x_velocity", "y_velocity", "z_velocity")
                 if n in dstate.names]
    if need_vel and len(vel_names) < 2:
        raise ValueError("do_strain/do_velnormal need velocity components "
                         f"(x/y/z_velocity); plotfile has {dstate.names}")
    iv = [dstate.comp(n) for n in vel_names] if need_vel else None
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]

    # progress min/max scan over valid (uncovered, in-box) cells.  With
    # use_file_minmax (the reference default, curvature.cpp:139-148) the file
    # is ALWAYS scanned and user-supplied bounds only widen the range
    if not use_file_minmax and (prog_min is None or prog_max is None):
        raise ValueError("use_file_minmax=False requires prog_min/prog_max")
    if use_file_minmax or prog_min is None or prog_max is None:
        lo, hi = _file_minmax([(dstate.data[lev][ic], dstate.valid_mask(lev))
                               for lev in range(meta.n_levels)])
        prog_min = lo if prog_min is None else min(prog_min, lo)
        prog_max = hi if prog_max is None else max(prog_max, hi)
    if prog_min >= prog_max:
        raise ValueError("progMin must be less than progMax")

    pipeline = _make_pipeline(
        meta, dstate.lmeta, ic, iv, bc, interp, do_smooth, smooth_composite,
        smooth_time, smooth_iters, smooth_rtol, do_gauss, do_strain,
        get_strain_tensor, do_velnormal, do_threshold, threshold,
        replicate_strain_bug)
    dt, dev = dstate.dtype, dstate.device
    valid = covered = None
    if do_smooth:
        valid = [dstate.valid_mask(l)[None] for l in range(meta.n_levels)]
        covered = [dstate.covered_mask(l) for l in range(meta.n_levels)]
    out_levels = pipeline(list(dstate.data), masks,
                          torch.full((), prog_min, dtype=dt, device=dev),
                          torch.full((), prog_max, dtype=dt, device=dev),
                          valid, covered)
    names = _output_names(progress_name, vel_names, need_vel, do_gauss,
                          do_strain, get_strain_tensor, do_velnormal)
    return dstate.with_data(names, out_levels)


def _output_names(progress_name, vel_names, need_vel, do_gauss, do_strain,
                  get_strain_tensor, do_velnormal):
    """Output component order of the curvature chain (curvature.cpp:796-829)."""
    names = [progress_name]
    if need_vel:
        names += vel_names
    names += ["Progress", "SmoothedProgress",
              f"MeanCurvature_{progress_name}",
              f"FlameNormalX_{progress_name}",
              f"FlameNormalY_{progress_name}",
              f"FlameNormalZ_{progress_name}"]
    if do_gauss:
        names.append(f"GaussianCurvature_{progress_name}")
    if do_strain:
        names.append(f"StrainRate_{progress_name}")
    if get_strain_tensor:
        names += [f"ROST_dU{m}d{n}" for m in "xyz" for n in "xyz"]
    if do_velnormal:
        names.append("VelFlameNormal")
    return names


def main(args: dict) -> None:
    """CLI: curvature infile=<plt> [progressName=temp] [progMin= progMax=]
    [do_smooth=0] [smoothing_time=1e-7] [smooth_composite=1] [smooth_iters=50]
    [smooth_rtol=1e-10  (0 disables the residual stop: fixed smooth_iters)]
    [do_gaussCurv=1] [do_strain=0] [useFileMinMax=1] [getStrainTensor=0]
    [do_velnormal=0] [threshold_prog=0] [threshold=1e-4]
    [replicate_strain_bug=0] [is_per=0 0 0] [sym_dir=0 0 0]
    [cf_interp=quadratic] [finestLevel=] [force_dense=0] [cluster_batch=0]
    [ndevices=1 [mesh_shape=a b [c]]  (not with do_smooth=1)]
    [outfile=...] [device=cuda|cpu]"""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    progress_name = pp.query_str("progressName", "temp")
    do_strain = pp.query_bool("do_strain", False)
    do_velnormal = pp.query_bool("do_velnormal", False)
    is_per = pp.query_int_list("is_per", [0, 0, 0])
    names = [progress_name]
    if do_strain or do_velnormal:
        names += [n for n in ("x_velocity", "y_velocity", "z_velocity")
                  if n in var_names(args, infile)]
    # Aux_Variables: extra plotfile comps copied through to the output
    # (curvature.cpp:103-106,182-190)
    aux_names = [n for n in pp.query_str_list("Aux_Variables", [])
                 if n not in names]
    names += aux_names
    # floorIt only gates the reference's min/max printout (curvature.cpp:139)
    pp.query_int("floorIt", 0)
    use_file_minmax = pp.query_bool("useFileMinMax", True)
    if not use_file_minmax:
        if not (pp.contains("progMin") and pp.contains("progMax")):
            raise ValueError("useFileMinMax=0 requires progMin= and progMax=")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    do_smooth = pp.query_bool("do_smooth", False)
    ndev = pp.query_int("ndevices", 1)
    if do_smooth and ndev > 1:
        refuse_unsharded("do_smooth=1")
    kwargs = dict(
        prog_min=pp.query_float("progMin", None),
        prog_max=pp.query_float("progMax", None),
        do_smooth=do_smooth,
        smooth_time=pp.query_float("smoothing_time", 1.0e-7),
        smooth_composite=pp.query_bool("smooth_composite", True),
        smooth_iters=pp.query_int("smooth_iters", 50),
        smooth_rtol=(pp.query_float("smooth_rtol", 1.0e-10) or None),
        do_gauss=pp.query_bool("do_gaussCurv", True),
        get_strain_tensor=pp.query_bool("getStrainTensor", False),
        do_threshold=pp.query_bool("threshold_prog", False),
        threshold=pp.query_float(
            "threshold_value", pp.query_float("threshold", 1.0e-4)),
        use_file_minmax=use_file_minmax,
        replicate_strain_bug=pp.query_bool("replicate_strain_bug", False),
        sym_dir=pp.query_int_list("sym_dir", [0, 0, 0]),
        interp=pp.query_str("cf_interp", "quadratic"),
    )
    src = load_state(args, infile, names=names,
                     max_level=pp.query_int("finestLevel", None),
                     is_periodic=[bool(p) for p in is_per],
                     dtype=config.compute_dtype, device=device)
    meta = src.meta
    outfile = pp.query_str("outfile", infile + "_K")
    kw = dict(do_strain=do_strain, do_velnormal=do_velnormal, **kwargs)
    sparse = clustered(meta, pp, [meta.n_levels - 1])
    if sparse and do_smooth:
        # the composite solve needs the dense model (no clustered path)
        ba = meta.bas[-1]
        waste = ba.minimal_box().size / max(ba.total_cells(), 1)
        print(f"curvature: finest union bbox is {waste:.1f}x its valid "
              "cells — the composite smoothing solve requires the dense "
              "model (no clustered path); expect the corresponding device "
              "memory footprint or pass finestLevel= to cap levels")
    elif sparse:
        print("curvature: sparse refinement detected -> clustered path")
        n = curvature_clustered(meta, src.names, src.fabs, device,
                                progress_name, aux_names, outfile,
                                mesh=cluster_mesh(ndev, device) if ndev > 1
                                else None, **kw)
        print(f"wrote {outfile} ({n} clusters)")
        return
    if ndev > 1:
        if curvature_sharded(args, src, mesh_from_pp(pp, ndev, device),
                             progress_name, aux_names, outfile, **kw):
            print(f"wrote {outfile} ({ndev} shards)")
        return
    dstate = dense_state(args, src, device, config.compute_dtype)
    out = _with_aux(compute_curvature_dense(dstate, progress_name, **kw),
                    dstate, aux_names, range(meta.n_levels))
    sess = get_session(args)
    if sess is not None:
        sess.put_plotfile(outfile, out)
    if stage_write_plotfile(args, out, outfile):
        print(f"wrote {outfile}")


def _with_aux(out: DenseAmrState, src: DenseAmrState, aux_names, levels
              ) -> DenseAmrState:
    """``out`` with the aux components of ``src`` appended on ``levels``
    (Aux_Variables pass-through, curvature.cpp:182-190)."""
    if not aux_names:
        return out
    idx = [src.comp(n) for n in aux_names]
    data = [torch.cat([out.data[lev], src.data[lev][idx]], dim=0)
            if lev in levels else None for lev in range(out.meta.n_levels)]
    return out.with_data(out.names + list(aux_names), data)


def _global_bounds(kw: dict, meta, fabs, ic: int) -> None:
    """Set ``kw``'s progress bounds for a run in parts (windows or
    clusters), which must all normalise alike: with use_file_minmax or a
    bound missing, the min and max of component ic over the valid cells
    (not covered by the next finer level or its periodic images) of every
    level, from the host FABs, widening any bound given, as
    ``compute_curvature_dense`` scans a whole dense state of the compute
    dtype (rounding to it commutes with min and max); then
    ``use_file_minmax=False`` for every part."""
    if (kw["use_file_minmax"] or kw["prog_min"] is None
            or kw["prog_max"] is None):
        los, his = [], []
        for lev in range(meta.n_levels):
            for b, fab in zip(meta.bas[lev], fabs[lev]):
                v = fab[ic][~covered_mask_over(meta, lev, b)]
                if v.size:
                    los.append(v.min())
                    his.append(v.max())
        np_dt = _np_dtype(config.compute_dtype)
        lo, hi = (float(np_dt.type(f(x))) for f, x in ((np.min, los),
                                                        (np.max, his)))
        kw["prog_min"] = lo if kw["prog_min"] is None else min(
            kw["prog_min"], lo)
        kw["prog_max"] = hi if kw["prog_max"] is None else max(
            kw["prog_max"], hi)
    kw["use_file_minmax"] = False


def curvature_sharded(args, src, mesh, progress_name, aux_names, outfile,
                      **kw) -> bool:
    """The dense curvature on the windows of ``mesh``: the progress
    bounds from one global scan, then the chain window by window, its
    owned cells gathered (``grad.write_sharded``)."""
    meta = src.meta
    dt = config.compute_dtype
    _global_bounds(kw, meta, src.fabs, src.names.index(progress_name))
    sd = ShardedDenseState(meta, src.names, src.fabs, mesh,
                           stencil_halo(CURVATURE_STAGES, kw["interp"]), dt)
    return write_sharded(args, sd, lambda w: _with_aux(
        compute_curvature_dense(w, progress_name, **kw), w, aux_names,
        range(w.meta.n_levels)), outfile)


def curvature_clustered(meta, names, fabs, device, progress_name, aux_names,
                        outfile, mesh=None, **kw) -> int:
    """The clustered curvature (JAX ``_main_clustered``): the GLOBAL
    progress min/max over the coarse levels' valid cells and every finest
    box (a per-cluster scan would normalise each cluster differently), then
    ``use_file_minmax=False`` for every part; levels 0..fin-1 from one
    coarse pass, the finest boxes from their clusters' runs, aux components
    passed through from the part that computed them.  Returns the cluster
    count."""
    fin = meta.n_levels - 1
    dt = config.compute_dtype
    _global_bounds(kw, meta, fabs, names.index(progress_name))
    base = DenseAmrState.coarse_only(meta, names, fabs, device, dt)
    return write_clustered(
        base, fabs[fin], outfile,
        lambda ds: _with_aux(compute_curvature_dense(ds, progress_name, **kw),
                             ds, aux_names, range(fin)),
        lambda sub: _with_aux(compute_curvature_dense(sub, progress_name,
                                                      **kw),
                              sub, aux_names, (fin,)), mesh)
