"""The sharded smoothing solve of the port's curvature (``do_smooth=1
ndevices=N``) on the CPU, all N shards there.

The halo update between resident windows (``parallel/halo.py``
``WindowHalo``) gives every cell a window holds but its shard does not own
its owner's value, from exactly one owner, periodic images included.  A
fine patch straddling a cut needs the operator's exchange after its
average-down (a covered coarse cell in a halo has fine children outside
the window): the other order moves owned cells.

Against ``ndevices=1``: the dots are summed per shard and across shards,
so the files are not byte-equal.  float64 with ``smooth_rtol=0``: the
smoothed progress within 1e-13 of its largest value (measured: 9.5e-15 at
most), every component within 1e-11 of its largest (measured: 2.2e-12 at
most, on a flame normal: the normals divide by |G| where it is small);
float32 with ``smooth_rtol=0 smooth_iters=5`` (the JAX package's own
sharded check, ``__graft_entry__.py:379-402``) within 5e-5; NaN sets
equal.  With the
default ``smooth_rtol`` the solves take the same iteration counts
(``solve.ITERATIONS``), float64 within 1e-10 (``test_torch_smooth.py``'s
CG tolerance) and float32 at ``smoothing_time=1e-5`` within 5e-5.
Against the JAX CLI at ``ndevices=8``: float64 within the one-device
parity test's 1e-8 of the largest value, float32 (``smooth_iters=5``)
within JAX's own 5e-5."""
import os

import numpy as np
import pytest
import torch

from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.box import Box, BoxArray
from peleanalysis_tpu_torch.amr.dense import DenseAmrState, _box_slices
from peleanalysis_tpu_torch.amr.geometry import Geometry
from peleanalysis_tpu_torch.amr.hierarchy import AmrMeta
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.ops import solve
from peleanalysis_tpu_torch.ops.restrict import average_down_all
from peleanalysis_tpu_torch.parallel.dense_shard import (
    CURVATURE_STAGES, HostFabs, ShardedDenseState, make_spatial_mesh,
    run_windows, stencil_halo)
from peleanalysis_tpu_torch.parallel.halo import WindowHalo
from peleanalysis_tpu_torch.testing import (make_amr_hierarchy,
                                            make_level_data,
                                            write_synthetic_plotfile)
from peleanalysis_tpu_torch.tools import curvature as cv

F64 = torch.float64
D = "device=cpu"


def noisy(x, y, z):
    base = np.exp(-((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2) / 0.15 ** 2)
    return 1000.0 * base + 20.0 * np.sin(40 * x) * np.sin(37 * y)


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def plotfiles(tmp_path_factory):
    """``test_torch_smooth.py``'s 3-level 16^3 plotfile, and a periodic
    2-level one whose level 1 spans the domain."""
    d = tmp_path_factory.mktemp("pltsmsh")
    out = {"plain": str(d / "plt"), "periodic": str(d / "pltper")}
    fields = {"temp": noisy, "density": lambda x, y, z: 1 + x * y}
    write_synthetic_plotfile(out["plain"], n_cell=16, n_levels=3,
                             max_grid_size=8, fields=fields)
    write_synthetic_plotfile(out["periodic"], n_cell=16, n_levels=2,
                             max_grid_size=8, fields=fields,
                             is_periodic=(True,) * 3, refine_frac=1.0)
    return out


# -- the halo update ------------------------------------------------------------
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", [(3,), (2, 2)])
def test_halo_cells_have_one_owner(periodic, shape):
    """Each window cell in the level's boxes (or their periodic images)
    that the shard does not own is written by exactly one copy, with the
    value its owner holds for the cell it images; no owned cell is
    written."""
    geoms, bas, ratios = make_amr_hierarchy(16, 3, 2, 8,
                                            is_periodic=(periodic,) * 3)
    meta = AmrMeta(geoms, bas, ratios)
    n = int(np.prod(shape))
    sd = ShardedDenseState(meta, ["temp"], None,
                           make_spatial_mesh(n, shape, "cpu"),
                           stencil_halo(CURVATURE_STAGES, "quadratic"), F64)
    halo = WindowHalo(sd)
    ids, hits = [], []
    for plan in sd.plans:
        lv, hv = [], []
        for lev in range(plan.n_levels):
            w, own = plan.windows[lev], plan.owned[lev]
            g = meta.geoms[lev].domain
            idx = np.meshgrid(*[np.arange(w.lo[d], w.hi[d] + 1)
                                for d in range(3)], indexing="ij")
            wrapped = [(i - g.lo[d]) % g.shape[d] if meta.geoms[lev]
                       .is_periodic[d] else i for d, i in enumerate(idx)]
            gid = (wrapped[0] * 10000 + wrapped[1] * 100 + wrapped[2]) * 4 \
                + lev
            mine = np.zeros(w.shape, bool)
            if own is not None:
                mine[_box_slices(own, w)] = True
            lv.append(torch.from_numpy(np.where(mine, gid, -1)
                                       .astype(np.float64))[None])
            hv.append(torch.zeros((1,) + w.shape, dtype=F64))
        ids.append(lv)
        hits.append(hv)
    halo.update(ids)
    for lev, copies in halo.copies.items():
        for s, t, dst, src in copies:
            hits[s][lev][(slice(None),) + dst] += 1
    n_copied = 0
    for s, plan in enumerate(sd.plans):
        for lev in range(plan.n_levels):
            w, own = plan.windows[lev], plan.owned[lev]
            boxes = np.zeros(w.shape, bool)
            for _, _, part in sd._boxes(lev, w):
                boxes[_box_slices(part, w)] = True
            mine = np.zeros(w.shape, bool)
            if own is not None:
                mine[_box_slices(own, w)] = True
            hit = hits[s][lev][0].numpy()
            assert (hit[mine] == 0).all()
            assert (hit[boxes & ~mine] == 1).all()
            g = meta.geoms[lev].domain
            idx = np.meshgrid(*[np.arange(w.lo[d], w.hi[d] + 1)
                                for d in range(3)], indexing="ij")
            wrapped = [(i - g.lo[d]) % g.shape[d] if meta.geoms[lev]
                       .is_periodic[d] else i for d, i in enumerate(idx)]
            gid = (wrapped[0] * 10000 + wrapped[1] * 100 + wrapped[2]) * 4 \
                + lev
            got = ids[s][lev][0].numpy()
            np.testing.assert_array_equal(got[boxes], gid[boxes])
            n_copied += int((boxes & ~mine).sum())
    assert n_copied > 0
    assert halo.volume()[0] >= n_copied


def _straddling():
    """Level 0 of 16^3, one fine patch over coarse x 4..11, cut at x = 8
    by two X slabs: the coarse halo beyond the cut holds covered cells
    whose fine children lie outside the fine window."""
    dom0 = Box((0, 0, 0), (15, 15, 15))
    g0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [g0, g0.refine(2)]
    bas = [BoxArray([dom0]), BoxArray([Box((8, 6, 6), (23, 21, 21))])]
    names, fabs = make_level_data(geoms, bas, {
        "temp": lambda x, y, z: 300 + 1500 * np.exp(
            -((x - .45) ** 2 + (y - .5) ** 2 + (z - .55) ** 2) / 0.2 ** 2)
        + 50 * np.sin(9 * x + 3 * y)})
    return AmrMeta(geoms, bas, [2]), names, fabs


def _wrong_order(wins, halo, covered, xs):
    """The exchange before the average-down."""
    xs = [[x.clone() for x in xa] for xa in xs]
    halo.update(xs)
    return [average_down_all(w.meta, w.lmeta, xs[s], covered[s])
            for s, w in enumerate(wins)]


def test_exchange_after_average_down_is_needed(monkeypatch):
    meta, names, fabs = _straddling()
    kw = dict(prog_min=300.0, prog_max=1900.0, use_file_minmax=False,
              do_smooth=True, smooth_time=1e-3, smooth_rtol=None,
              smooth_iters=10, interp="quadratic")
    ref = cv.compute_curvature_dense(
        DenseAmrState.from_level_fabs(meta, names, fabs, "cpu", F64),
        "temp", **kw)

    def worst():
        sd = ShardedDenseState(meta, names, HostFabs(names, fabs),
                               make_spatial_mesh(2, None, "cpu"),
                               stencil_halo(CURVATURE_STAGES, "quadratic"),
                               F64)
        wins = [sd.window(s) for s in range(2)]
        sm = cv.smooth_windows(sd, wins, "temp", **kw)
        got = run_windows(sd, lambda a: cv.compute_curvature_dense(
            a[0], "temp", smoothed=a[1], **kw),
                          windows=list(zip(wins, sm))).state()
        err = 0.0
        for lev in range(2):
            m = torch.from_numpy(ref.in_level_mask_np(lev))
            a, b = ref.data[lev][:, m], got.data[lev][:, m]
            ok = ~a.isnan()
            err = max(err, float((a[ok] - b[ok]).abs().max()
                                 / a[ok].abs().max()))
        return err

    assert worst() < 1e-12
    monkeypatch.setattr(cv, "_averaged_down", _wrong_order)
    assert worst() > 1e-6


# -- against one device -----------------------------------------------------------
def fabs_of(path):
    r = PlotfileReader(path)
    return r.var_names, [f for lev in range(r.meta.n_levels)
                         for f in r.read_level(lev)]


def assert_close(got, ref, tol, smoothed_tol=None):
    """NaN sets equal, each component within ``tol`` of its largest value
    (SmoothedProgress within ``smoothed_tol``, if given)."""
    gn, gf = fabs_of(got)
    rn, rf = fabs_of(ref)
    assert gn == rn
    for c, name in enumerate(rn):
        tol_c = smoothed_tol if (name == "SmoothedProgress"
                                 and smoothed_tol) else tol
        scale = max((float(np.abs(f[c][~np.isnan(f[c])]).max(initial=0.0))
                     for f in rf), default=0.0)
        for a, b in zip(gf, rf):
            np.testing.assert_array_equal(np.isnan(a[c]), np.isnan(b[c]),
                                          err_msg=name)
            ok = ~np.isnan(b[c])
            err = float(np.abs(a[c][ok] - b[c][ok]).max(initial=0.0))
            assert err <= tol_c * max(scale, 1e-30), (name, err, scale)


def curvature(plt, layout, out, keys):
    solve.ITERATIONS.clear()
    assert cli.main(["curvature", f"infile={plt}", "progressName=temp",
                     "do_smooth=1", "do_gaussCurv=1", *keys, D,
                     f"outfile={out}", *layout.split()]) == 0
    return list(solve.ITERATIONS)


LAYOUTS = ["ndevices=2", "ndevices=3", "ndevices=4 mesh_shape=2 2",
           "ndevices=8 mesh_shape=4 2"]
FIXED = {"float64": (["dtype=float64", "smoothing_time=1e-3",
                      "smooth_rtol=0", "smooth_iters=20"], (1e-11, 1e-13)),
         "float32": (["smoothing_time=1e-3", "smooth_rtol=0",
                      "smooth_iters=5"], (5e-5, None))}


@pytest.mark.parametrize("dtype", list(FIXED))
@pytest.mark.parametrize("mode", ["composite", "level"])
def test_sharded_smooth_fixed_iterations(plotfiles, mode, dtype):
    keys, tol = FIXED[dtype]
    keys = keys + (["smooth_composite=0"] if mode == "level" else [])
    n_ref = curvature(plotfiles["plain"], "ndevices=1", "ref", keys)
    for i, layout in enumerate(LAYOUTS):
        assert curvature(plotfiles["plain"], layout, f"n{i}", keys) == n_ref
        assert_close(f"n{i}", "ref", *tol)


DEFAULT = {"float64": (["dtype=float64", "smoothing_time=1e-5"], 1e-10),
           "float32": (["smoothing_time=1e-5"], 5e-5)}


@pytest.mark.parametrize("dtype", list(DEFAULT))
@pytest.mark.parametrize("mode", ["composite", "level"])
def test_sharded_smooth_default_rtol(plotfiles, mode, dtype):
    """The default smooth_rtol: the same iteration counts as one device
    (some solves below the cap)."""
    keys, tol = DEFAULT[dtype]
    keys = keys + (["smooth_composite=0"] if mode == "level" else [])
    n_ref = curvature(plotfiles["plain"], "ndevices=1", "ref", keys)
    assert min(n_ref) < 50
    for i, layout in enumerate(LAYOUTS[1:3]):
        assert curvature(plotfiles["plain"], layout, f"n{i}", keys) == n_ref
        assert_close(f"n{i}", "ref", tol)


@pytest.mark.parametrize("mode", ["composite", "level"])
def test_sharded_smooth_periodic(plotfiles, mode):
    keys = ["is_per=1 1 1"] + FIXED["float64"][0] + (
        ["smooth_composite=0"] if mode == "level" else [])
    n_ref = curvature(plotfiles["periodic"], "ndevices=1", "ref", keys)
    for i, layout in enumerate(["ndevices=3", "ndevices=4 mesh_shape=2 2"]):
        assert curvature(plotfiles["periodic"], layout, f"n{i}",
                         keys) == n_ref
        assert_close(f"n{i}", "ref", *FIXED["float64"][1])


def test_sharded_smooth_in_a_pipeline(plotfiles):
    """A session stage gathers the smoothed curvature into one state."""
    keys = FIXED["float64"][0]
    curvature(plotfiles["plain"], "ndevices=1", "ref", keys)
    assert cli.main(["pipeline", "curvature", f"infile={plotfiles['plain']}",
                     "progressName=temp", "do_smooth=1", "do_gaussCurv=1",
                     *keys, D, "outfile=k", "ndevices=3"]) == 0
    assert_close("k", "ref", *FIXED["float64"][1])


# -- against the JAX CLI at ndevices=8 ------------------------------------------
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["composite", "level"])
def test_smooth_matches_jax_at_8(tmp_path_factory, mode, dtype):
    """float64 within 1e-8 of each component's largest value
    (``test_torch_smooth.py``); float32 with smooth_iters=5 within JAX's
    own 5e-5 relative; non-finite cells equal."""
    from peleanalysis_tpu import config as jax_config
    from peleanalysis_tpu.cli import main as jax_cli
    plt = str(tmp_path_factory.mktemp("pltsmj") / "plt")
    write_synthetic_plotfile(plt, n_cell=16, n_levels=2, max_grid_size=8)
    keys = ["progressName=temp", "do_smooth=1", "do_gaussCurv=1",
            "smoothing_time=1e-3", "ndevices=8"]
    keys += (["dtype=float64"] if dtype == "float64"
             else ["smooth_rtol=0", "smooth_iters=5"])
    keys += ["smooth_composite=0"] if mode == "level" else []
    jax_dtype = jax_config.compute_dtype
    try:
        assert cli.main(["curvature", f"infile={plt}", *keys, D,
                         "outfile=port"]) == 0
        assert jax_cli(["curvature", f"infile={plt}", *keys,
                        "outfile=jax"]) == 0
    finally:
        jax_config.compute_dtype = jax_dtype
    pn, pf = fabs_of("port")
    jn, jf = fabs_of(os.path.abspath("jax"))
    assert pn == jn
    tol = 1e-8 if dtype == "float64" else 5e-5
    for a, b in zip(pf, jf):
        for c in range(a.shape[0]):
            fin = np.isfinite(b[c])
            np.testing.assert_array_equal(np.isfinite(a[c]), fin)
            scale = max(float(np.abs(b[c][fin]).max(initial=0.0)), 1e-30)
            assert np.abs(a[c][fin] - b[c][fin]).max(initial=0.0) \
                <= tol * scale, pn[c]
