"""The port's ``parallel/`` package on the CPU: meshes, the ring halo
exchange and the sharded gradient (held to the JAX package's ``halo.py``
on its eight virtual host devices, 1e-12 in float64), the window
partition (no shard holds a whole level; the halo each tool derives is
needed and enough, bitwise), the cluster dealing, and the refusals of
what the slice leaves out (ROADMAP.md Queue 1 item 9b)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from peleanalysis_tpu.parallel.halo import halo_grad as jax_halo_grad
from peleanalysis_tpu.parallel.halo import halo_grad_x as jax_halo_grad_x
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.amr.hierarchy import AmrMeta
from peleanalysis_tpu_torch.geom.marching_cubes import (
    extract_isosurface_enum, extract_isosurface_windows)
from peleanalysis_tpu_torch.parallel.cluster_shard import (cluster_mesh,
                                                           cluster_shard)
from peleanalysis_tpu_torch.parallel.dense_shard import (
    CURVATURE_STAGES, GRAD_STAGES, ISO_HALO, ShardedDenseState,
    make_spatial_mesh, run_windows, stencil_halo)
from peleanalysis_tpu_torch.parallel.halo import (halo_exchange, halo_grad,
                                                  halo_grad_x, join_blocks,
                                                  split_blocks)
from peleanalysis_tpu_torch.parallel.mesh import make_mesh
from peleanalysis_tpu_torch.testing import (make_amr_hierarchy,
                                            make_level_data,
                                            write_synthetic_plotfile)
from peleanalysis_tpu_torch.tools.curvature import compute_curvature_dense
from peleanalysis_tpu_torch.tools.grad import compute_grad_dense

CPU = torch.device("cpu")
F64 = torch.float64


def test_meshes():
    m = make_spatial_mesh(8, (4, 2), "cpu")
    assert m.axis_names == ("x", "y") and m.devices == (CPU,) * 8
    assert m.index(5) == (2, 1) and m.shard((2, 1)) == 5
    with pytest.raises(ValueError, match=r"mesh shape \(3, 2\) != 8"):
        make_spatial_mesh(8, (3, 2), "cpu")
    assert make_mesh(3, "cpu", ("parts",)).axis_names == ("parts",)
    # the JAX batch rows: ceil(K/n) clusters a shard
    mesh = cluster_mesh(2, "cpu")
    assert [cluster_shard(j, 5, mesh) for j in range(5)] == [0, 0, 0, 1, 1]


def test_halo_exchange_ring():
    shards = [torch.full((1, 2, 3, 3), float(i)) for i in range(4)]
    out = halo_exchange(shards, 1, 0)
    for i, t in enumerate(out):
        assert t.shape == (1, 4, 3, 3)
        assert t[0, 0, 0, 0] == (i - 1) % 4 and t[0, -1, 0, 0] == (i + 1) % 4


def test_halo_grad_x_matches_jax():
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(1, 32, 12, 16))
    dx = (0.1, 0.2, 0.3)
    jmesh = JaxMesh(np.array(jax.devices()[:8]), ("x",))
    want = np.asarray(jax_halo_grad_x(
        jax.device_put(arr, NamedSharding(jmesh, P(None, "x"))), dx, jmesh))
    mesh = make_spatial_mesh(8, None, "cpu")
    specs = ("x", None, None)
    shards = split_blocks(torch.from_numpy(arr), mesh, specs)
    got = join_blocks(halo_grad_x(shards, dx, mesh), mesh, specs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_halo_grad_two_axis_matches_jax():
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(1, 16, 8, 12))
    dx = (0.07, 0.11, 0.13)
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    specs = ("x", "y", None)
    want = np.asarray(jax_halo_grad(
        jax.device_put(arr, NamedSharding(jmesh, P(None, "x", "y"))), dx,
        jmesh, specs))
    mesh = make_spatial_mesh(8, (4, 2), "cpu")
    got = join_blocks(halo_grad(split_blocks(torch.from_numpy(arr), mesh,
                                             specs), dx, mesh, specs),
                      mesh, specs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _hierarchy(n_cell=16, periodic=False, fields=None):
    per = (periodic,) * 3
    geoms, bas, ratios = make_amr_hierarchy(n_cell, 3, 2, 8, is_periodic=per)
    names, fabs = make_level_data(geoms, bas, fields or {
        # no symmetry about any cut: a cut that reads a wrong ghost shows
        "temp": lambda x, y, z: 1000 + 500 * np.sin(2 * np.pi * x + 0.3)
        * np.cos(2 * np.pi * y - 0.2) + 300 * np.sin(2 * np.pi * z + 0.1),
        "density": lambda x, y, z: x + 2 * y + 3 * z})
    return AmrMeta(geoms, bas, ratios), names, fabs


def narrower(halo):
    """The same halo one cell and one coarse cell narrower."""
    return dataclasses.replace(halo, cells=halo.cells - 1,
                               reach=max(halo.reach - 1, 0))


def _owned_changes(meta, names, fabs, mesh, halo, fn):
    """Owned cells (in some level's boxes) whose output differs from the
    unsharded run's."""
    ref = fn(DenseAmrState.from_level_fabs(meta, names, fabs, CPU, F64))
    sd = ShardedDenseState(meta, names, fabs, mesh, halo, F64)
    got = run_windows(sd, fn, device=CPU).state()
    n = 0
    for lev in range(meta.n_levels):
        m = torch.from_numpy(ref.in_level_mask_np(lev))
        a, b = ref.data[lev][:, m], got.data[lev][:, m]
        n += int((~((a == b) | (a.isnan() & b.isnan()))).sum())
    return n


@pytest.mark.parametrize("tool", ["grad", "fluxMatch", "curvature"])
@pytest.mark.parametrize("periodic", [False, True])
def test_halo_is_needed_and_tight(tool, periodic):
    """The derived halo gives every owned cell its unsharded value; one
    cell (and one coarse cell) narrower, some owned cell changes."""
    meta, names, fabs = _hierarchy(periodic=periodic)
    mesh = make_spatial_mesh(3, None, "cpu")
    kw = dict(interp="quadratic")
    if tool == "curvature":
        halo = stencil_halo(CURVATURE_STAGES, "quadratic")
        def fn(ds):
            return compute_curvature_dense(ds, "temp", prog_min=300.0,
                                           prog_max=1800.0,
                                           use_file_minmax=False, **kw)
    else:
        flux = tool == "fluxMatch"
        halo = stencil_halo(GRAD_STAGES, "quadratic", child=flux)
        def fn(ds):
            return compute_grad_dense(ds, "temp", flux_match=flux, **kw)
    assert _owned_changes(meta, names, fabs, mesh, halo, fn) == 0
    if tool != "fluxMatch":
        # (fluxMatch's fine windows also hold the children of the coarse
        # owned cells, which reach farther than one gradient's halo)
        assert _owned_changes(meta, names, fabs, mesh, narrower(halo),
                              fn) > 0


@pytest.mark.parametrize("periodic", [False, True])
def test_iso_halo_is_needed_and_tight(periodic):
    meta, names, fabs = _hierarchy(periodic=periodic)
    ds = DenseAmrState.from_level_fabs(meta, names, fabs, CPU, F64)
    ref = extract_isosurface_enum(ds, "temp", 1000.0, ["density"])
    mesh = make_spatial_mesh(3, None, "cpu")
    for halo, same in ((ISO_HALO, True), (narrower(ISO_HALO), False)):
        got = extract_isosurface_windows(
            ShardedDenseState(meta, names, fabs, mesh, halo, F64), "temp",
            1000.0, ["density"])
        equal = (got.nodes.shape == ref.nodes.shape
                 and np.array_equal(got.nodes, ref.nodes)
                 and np.array_equal(got.elements, ref.elements))
        assert equal == same


@pytest.mark.parametrize("halo", [
    stencil_halo(GRAD_STAGES, "quadratic"),
    stencil_halo(CURVATURE_STAGES, "quadratic"), ISO_HALO])
@pytest.mark.parametrize("frac, shape", [(0.9, None), (0.5, (2, 2))])
def test_no_shard_holds_a_whole_level(halo, frac, shape):
    """Level 0 of 64 cells a side and two levels refining ``frac`` of it
    about the centre: at N=4 the largest window is under 0.45 of the
    unsharded state, and no window spans a level's bbox.  (X slabs of a
    refinement of the centre half leave half of each fine level to each
    middle slab: 2 x 2 blocks split it four ways.)"""
    geoms, bas, ratios = make_amr_hierarchy(64, 3, 2, 32, refine_frac=frac)
    meta = AmrMeta(geoms, bas, ratios)
    sd = ShardedDenseState(meta, ["temp"], None,
                           make_spatial_mesh(4, shape, "cpu"), halo, F64)
    share = max(sd.window_bytes(s) for s in range(4)) / sd.state_bytes()
    assert share < 0.45, share
    for plan in sd.plans:
        for lev, w in enumerate(plan.windows):
            assert w.size < sd.lmeta[lev].bbox.size


@pytest.fixture(scope="module")
def small_plotfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pltpar") / "plt")
    write_synthetic_plotfile(path, n_cell=16, n_levels=2, max_grid_size=8)
    return path


@pytest.fixture(autouse=True)
def _keep_dtype(monkeypatch):
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)


@pytest.mark.parametrize("argv", [
    ["curvature", "do_smooth=1"],
    ["isosurface", "build_distance_function=1"]])
def test_refusals_name_item_9b(small_plotfile, tmp_path, argv):
    with pytest.raises(NotImplementedError, match="item 9b"):
        cli.main([argv[0], f"infile={small_plotfile}", *argv[1:],
                  "ndevices=2", "device=cpu",
                  f"outfile={tmp_path / 'o'}",
                  f"outfile_base={tmp_path / 'o'}"])


def test_dim2_refused(tmp_path):
    path = str(tmp_path / "plt2d")
    write_synthetic_plotfile(path, n_cell=16, n_levels=2, ndim=2)
    for tool in ("grad", "curvature", "isosurface"):
        with pytest.raises(NotImplementedError, match="item 9b"):
            cli.main([tool, f"infile={path}", "ndevices=2", "device=cpu",
                      f"outfile={tmp_path / 'o'}",
                      f"outfile_base={tmp_path / 'o'}"])


def test_windows_live_on_their_shards_devices():
    meta, names, fabs = _hierarchy()
    sd = ShardedDenseState(meta, names, fabs, make_spatial_mesh(2, None,
                                                                "cpu"),
                           stencil_halo(GRAD_STAGES, "linear"), F64)
    for s, win in sd:
        assert all(d.device == sd.mesh.devices[s] for d in win.data)
        # the window's masks are the global ones on its cells
        for lev, w in enumerate(sd.plans[s].windows):
            bbox = sd.lmeta[lev].bbox
            full = DenseAmrState.from_level_fabs(meta, names, fabs, CPU, F64)
            sl = tuple(slice(w.lo[d] - bbox.lo[d], w.hi[d] - bbox.lo[d] + 1)
                       for d in range(3))
            np.testing.assert_array_equal(win.covered_mask_np(lev),
                                          full.covered_mask_np(lev)[sl])
            np.testing.assert_array_equal(win.in_level_mask_np(lev),
                                          full.in_level_mask_np(lev)[sl])
