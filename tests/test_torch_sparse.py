"""Sparse refinement in the port: clusters, the clustered grad, curvature,
isosurface, stream, sampleStreamlines, conditionalMean and jpdf, against the
JAX package's sparse paths and the port's own dense path (``force_dense=1``)
on identical plotfiles.

Two hierarchies: the JAX sparse tests' three-level case (48^3, two far fine
regions, the finest bbox above the 2^21-cell gate; tests/test_sparse.py:33)
and a small ``make_scattered_state`` (48^3, ratio 4, four 16^3 patches on a
192^3 finest index space).

Tolerances:
  * plotfiles against the JAX CLI: those of the dense parity tests: grad as
    test_torch_grad.py (float64 1e-12 relative; float32 1e-5 relative plus
    1e-5 of the largest value), curvature as test_torch_curvature.py
    (float64 1e-10 relative plus 1e-10 of the largest value; float32 the
    same non-finite cells and the finite ones within 1e-3 of the largest);
  * plotfiles against the port's force_dense=1 run: rtol 1e-12 in float64
    (JAX's test_sparse.py:231); equal in float32 (each cell goes through the
    same torch ops on the same inputs, whatever the extent of the tensor);
  * the clustered plotfile writer: byte-identical to ``write_level_fabs`` of
    the same per-box arrays;
  * isosurface: JAX's elements exactly, nodes within 1e-12; the same
    surface as the port's dense engine under ``_canon``;
  * lines and samples: within 1e-12 of the domain extent and of each
    field's largest value (float64; test_torch_stream_io.py's);
  * stats files: rtol 1e-9 (atol 1e-12), hits exact.
"""
import os

import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.amr import cluster as jcl
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.geom.marching_cubes import \
    extract_isosurface_sparse as jax_iso_sparse
from peleanalysis_tpu.stream.trace import \
    trace_streamlines_sparse as jax_trace_sparse
from peleanalysis_tpu.tools.sample_streamlines import \
    sample_onto_lines_sparse as jax_sample_sparse
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr import cluster as pcl
from peleanalysis_tpu_torch.amr.box import Box, BoxArray
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.amr.geometry import Geometry
from peleanalysis_tpu_torch.amr.hierarchy import (load_plotfile_fabs,
                                                  write_level_fabs)
from peleanalysis_tpu_torch.geom.marching_cubes import (
    extract_isosurface, extract_isosurface_sparse)
from peleanalysis_tpu_torch.io.mef import read_mef
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader, write_plotfile
from peleanalysis_tpu_torch.stream.trace import (finest_cluster_of,
                                                 trace_streamlines,
                                                 trace_streamlines_sparse)
from peleanalysis_tpu_torch.testing import (make_level_data,
                                            write_scattered_plotfile,
                                            write_synthetic_plotfile)
from peleanalysis_tpu_torch.tools.curvature import compute_curvature_dense
from peleanalysis_tpu_torch.tools.grad import compute_grad_dense
from peleanalysis_tpu_torch.tools.sample_streamlines import (
    sample_onto_lines, sample_onto_lines_sparse)

TOL = {np.float64: dict(rtol=1e-12, atol_frac=0.0),
       np.float32: dict(rtol=1e-5, atol_frac=1e-5)}


def _blob(x, y, z):
    r1 = np.sqrt((x - .25) ** 2 + (y - .25) ** 2 + (z - .25) ** 2)
    r2 = np.sqrt((x - .75) ** 2 + (y - .75) ** 2 + (z - .75) ** 2)
    return np.exp(-(r1 / 0.06) ** 2) + np.exp(-(r2 / 0.06) ** 2)


def _velocities():
    return {"x_velocity": lambda x, y, z: -(y - .5) + .1 * np.sin(6 * x),
            "y_velocity": lambda x, y, z: (x - .5) + .1 * np.cos(6 * y),
            "z_velocity": lambda x, y, z: .25 + .1 * x * y}


def _box_at(n, c, half):
    return Box(tuple(int((ci - half) * n) for ci in c),
               tuple(int((ci + half) * n) - 1 for ci in c))


def write_three_level(path):
    """tests/test_sparse.py:33-50: 3 levels; the finest covers <3% of the
    domain in two far regions."""
    n0 = 48
    dom0 = Box((0, 0, 0), (n0 - 1,) * 3)
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2), geom0.refine(2).refine(2)]
    bas = [BoxArray([dom0]),
           BoxArray([_box_at(96, (.2,) * 3, .13),
                     _box_at(96, (.8,) * 3, .13)]),
           BoxArray([_box_at(192, (.2,) * 3, .09),
                     _box_at(192, (.8,) * 3, .09)])]
    names, data = make_level_data(geoms, bas, {"blob": _blob,
                                               "xc": lambda x, y, z: x,
                                               **_velocities()})
    write_plotfile(path, names, 0.0, geoms, [2, 2], bas, data)


def scattered_temp(x, y, z):
    """An isotherm at 1050 K through every scattered patch."""
    return 300 + 750 * (1 + np.cos(8 * np.pi * x) * np.cos(8 * np.pi * y)
                        * np.cos(8 * np.pi * z))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    base = tmp_path_factory.mktemp("sparse")
    three = str(base / "plt_three")
    write_three_level(three)
    scat = str(base / "plt_scat")
    write_scattered_plotfile(scat, n0=48, ratio=4, n_clusters=4, fine_box=16,
                             fields={"temp": scattered_temp,
                                     "density": lambda x, y, z: 1 + x * y,
                                     **_velocities()})
    return {"three": three, "scattered": scat}


@pytest.fixture
def cli_env(monkeypatch, tmp_path):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    # both CLIs set a process-wide compute dtype: restore it afterwards
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    monkeypatch.chdir(tmp_path)


def port_base(path, dtype=torch.float64, names=None, is_periodic=None):
    meta, names, fabs = load_plotfile_fabs(path, names,
                                           is_periodic=is_periodic)
    return DenseAmrState.coarse_only(meta, names, fabs, "cpu", dtype), fabs


def port_dense(path, dtype=torch.float64, names=None):
    return DenseAmrState.from_plotfile(path, "cpu", names=names, dtype=dtype)


def jax_state(path):
    return AmrState.from_plotfile(path, dtype=np.float64)


# -- clusters -----------------------------------------------------------------
@pytest.mark.parametrize("case", ["three", "scattered"])
@pytest.mark.parametrize("dist", [2, 9])
def test_groups_match_jax(cases, case, dist):
    jst = jax_state(cases[case])
    base, fabs = port_base(cases[case])
    fin = base.meta.n_levels - 1
    ba, jba = base.meta.bas[fin], jst.meta.bas[fin]
    assert pcl.needs_clustering(ba) == jcl.needs_clustering(jba) is True
    for lev in range(fin):
        assert (pcl.needs_clustering(base.meta.bas[lev])
                == jcl.needs_clustering(jst.meta.bas[lev]))
    assert (pcl.connected_components(ba, dist)
            == jcl.connected_components(jba, dist))
    assert pcl.cluster_boxes(ba, dist=dist) == jcl.cluster_boxes(jba,
                                                                 dist=dist)
    groups, subs = pcl.cluster_substates(base, fabs[fin], dist=dist)
    jgroups, jsubs, _ = jcl.cluster_substates(jst, dist=dist)
    assert groups == jgroups and len(subs) == len(jsubs) == len(groups)
    for sub, jsub in zip(subs, jsubs):
        bb, jbb = sub.lmeta[fin].bbox, jsub.lmeta[fin].bbox
        assert (bb.lo, bb.hi) == (jbb.lo, jbb.hi)
        np.testing.assert_array_equal(sub.data[fin].numpy(),
                                      np.asarray(jsub.data[fin]))
        for lev in range(fin):
            # coarse tensors shared, masks the global ones
            assert sub.data[lev] is base.data[lev]
            assert sub.in_level_mask(lev) is base.in_level_mask(lev)
            np.testing.assert_array_equal(sub.covered_mask_np(lev),
                                          np.asarray(jsub.covered_mask(lev)))
        np.testing.assert_array_equal(sub.in_level_mask_np(fin),
                                      np.asarray(jsub.in_level_mask(fin)))
    # the finest union bbox is never assembled
    assert base.data[fin] is None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dist, waste", [(2, 4.0), (6, 4.0), (2, 1.5)])
def test_cluster_boxes_random(seed, dist, waste):
    """Components and greedy merges of 60 random boxes equal JAX's."""
    from peleanalysis_tpu.amr.box import Box as JBox, BoxArray as JBoxArray
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 100, (60, 3))
    hi = lo + rng.integers(3, 16, (60, 3))
    ba = BoxArray([Box(tuple(l), tuple(h)) for l, h in zip(lo, hi)])
    jba = JBoxArray([JBox(tuple(l), tuple(h)) for l, h in zip(lo, hi)])
    comps = pcl.connected_components(ba, dist)
    assert comps == jcl.connected_components(jba, dist)
    assert 1 < len(comps) < 60
    assert (pcl.cluster_boxes(ba, waste, dist)
            == jcl.cluster_boxes(jba, waste, dist))
    assert pcl.needs_clustering(ba) == jcl.needs_clustering(jba)


# -- grad and curvature -------------------------------------------------------
def _assert_close(got, want, dt):
    tol = TOL[dt]
    atol = tol["atol_frac"] * float(np.nanmax(np.abs(want), initial=0.0))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol,
                               equal_nan=True)


def _assert_close_curvature(got, want, dt):
    if dt == np.float64:
        atol = 1e-10 * float(np.max(np.abs(want)))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=atol)
        return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isfinite(got), fin)
    if fin.any():
        assert (np.max(np.abs(got[fin] - want[fin]))
                <= 1e-3 * np.max(np.abs(want[fin])))


def _compare_plotfiles(a, b, check):
    ra, rb = PlotfileReader(a), PlotfileReader(b)
    assert ra.var_names == rb.var_names
    assert ra.meta.n_levels == rb.meta.n_levels
    for lev in range(ra.meta.n_levels):
        assert ([(x.lo, x.hi) for x in ra.box_array(lev)]
                == [(x.lo, x.hi) for x in rb.box_array(lev)])
        for fa, fb in zip(ra.read_level(lev), rb.read_level(lev)):
            check(fa, fb)


GRAD_CURV = {
    "three_grad_f32": ("three", "grad", ["gradVar=blob",
                                         "Aux_Variables=xc"]),
    "three_grad_f64": ("three", "grad", ["gradVar=blob", "dtype=float64"]),
    "three_curvature_f64": ("three", "curvature", [
        "progressName=blob", "Aux_Variables=xc", "do_strain=1",
        "dtype=float64"]),
    "scattered_grad_f32": ("scattered", "grad", ["gradVar=temp"]),
    "scattered_curvature_f32": ("scattered", "curvature", [
        "progressName=temp", "do_velnormal=1"]),
}


@pytest.mark.parametrize("name", sorted(GRAD_CURV))
def test_grad_curvature_cli(cases, cli_env, capsys, name):
    case, tool, keys = GRAD_CURV[name]
    dt = np.float64 if "dtype=float64" in keys else np.float32
    key = "infile=" + cases[case]
    assert cli.main([tool, key, *keys, "outfile=port", "device=cpu"]) == 0
    assert "clustered path" in capsys.readouterr().out
    assert cli.main([tool, key, *keys, "outfile=dense", "device=cpu",
                     "force_dense=1"]) == 0
    assert "clustered path" not in capsys.readouterr().out
    assert jax_cli.main([tool, key, *keys, "outfile=jax"]) == 0
    assert "clustered path" in capsys.readouterr().out
    close = _assert_close if tool == "grad" else _assert_close_curvature
    _compare_plotfiles("port", "jax", lambda a, b: close(a, b, dt))
    if dt == np.float64:
        _compare_plotfiles("port", "dense", lambda a, b: np.testing.
                           assert_allclose(a, b, rtol=1e-12, atol=0,
                                           equal_nan=True))
    else:
        _compare_plotfiles("port", "dense", np.testing.assert_array_equal)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("tool", ["grad", "curvature"])
def test_clustered_writer_bytes(cases, cli_env, tool):
    """The clustered CLI's plotfile (one pack and one copy a part) equals
    the host writer's of the same per-box arrays, byte for byte, min/max
    tables included (float32)."""
    path = cases["three"]
    keys = (["gradVar=blob"] if tool == "grad"
            else ["progressName=blob", "progMin=0", "progMax=1",
                  "useFileMinMax=0"])
    assert cli.main([tool, f"infile={path}", *keys, "outfile=dev",
                     "device=cpu"]) == 0
    # the tools' is_per defaults: periodic for grad, not for curvature
    base, fabs = port_base(path, torch.float32, ["blob"],
                           [tool == "grad"] * 3)
    fin = base.meta.n_levels - 1
    groups, subs = pcl.cluster_substates(base, fabs[fin])
    if tool == "grad":
        run = lambda ds: compute_grad_dense(ds, "blob", interp="quadratic")
    else:
        run = lambda ds: compute_curvature_dense(
            ds, "blob", prog_min=0.0, prog_max=1.0, use_file_minmax=False,
            interp="quadratic")
    coarse = run(pcl.coarse_only_state(base))
    level_fabs = coarse.level_fabs()
    fine = [None] * len(base.meta.bas[fin])
    for g, sub in zip(groups, subs):
        out = run(sub)
        host = out.data[fin].numpy()
        for i in g:
            b = base.meta.bas[fin][i]
            bbox = out.lmeta[fin].bbox
            fine[i] = np.ascontiguousarray(host[(slice(None),) + tuple(
                slice(b.lo[d] - bbox.lo[d], b.hi[d] - bbox.lo[d] + 1)
                for d in range(3))])
    write_level_fabs(base.meta, coarse.names, level_fabs + [fine], "host")
    assert _tree_bytes("dev") == _tree_bytes("host")


# -- isosurface ---------------------------------------------------------------
def _canon(m):
    n = np.round(m.nodes, 9)
    order = np.lexsort(n.T[::-1])
    rank = np.empty(len(n), np.int64)
    rank[order] = np.arange(len(n))
    tris = np.sort(rank[m.elements], axis=1)
    return n[order], tris[np.lexsort(tris.T[::-1])]


ISO = {"three_0.5": ("three", "blob", 0.5, ("xc",)),
       "three_0.05": ("three", "blob", 0.05, ()),
       "scattered_1050": ("scattered", "temp", 1050.0, ("density",))}


@pytest.mark.parametrize("name", sorted(ISO))
def test_isosurface_sparse(cases, name):
    case, var, iso, extras = ISO[name]
    path = cases[case]
    base, fabs = port_base(path)
    got = extract_isosurface_sparse(base, fabs[-1], var, iso, extras)
    want = jax_iso_sparse(jax_state(path), var, iso, extras)
    assert got.names == want.names and got.n_elts > 100
    np.testing.assert_array_equal(got.elements, want.elements)
    np.testing.assert_allclose(got.nodes, want.nodes, rtol=0, atol=1e-12)
    dense = extract_isosurface(port_dense(path), var, iso, extras)
    n1, t1 = _canon(dense)
    n2, t2 = _canon(got)
    np.testing.assert_allclose(n2, n1, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(t2, t1)


def test_isosurface_cli_and_surface_is_large(cases, tmp_path, cli_env,
                                            capsys):
    """The CLI routes the sparse plotfile to the clustered path, and
    surface_is_large=1 does so on a hierarchy dense enough not to need it;
    both equal the dense path's surface."""
    small = str(tmp_path / "plt_small")
    write_synthetic_plotfile(small, n_cell=16, n_levels=3, max_grid_size=8)
    for path, keys in ((cases["three"], ["isoCompName=blob", "isoVal=0.05"]),
                       (small, ["isoVal=1000", "comps=density",
                                "surface_is_large=1"])):
        assert cli.main(["isosurface", f"infile={path}", *keys,
                         "outfile_base=sp", "device=cpu"]) == 0
        assert "clustered path" in capsys.readouterr().out
        assert cli.main(["isosurface", f"infile={path}", *keys,
                         "outfile_base=dn", "device=cpu",
                         "force_dense=1"]) == 0
        assert "clustered path" not in capsys.readouterr().out
        (n1, t1), (n2, t2) = (_canon(read_mef(f + ".mef"))
                              for f in ("sp", "dn"))
        assert len(t1) > 100
        np.testing.assert_allclose(n1, n2, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(t1, t2)


# -- stream and sampleStreamlines ---------------------------------------------
def _seeds(meta, rng):
    """Three seeds inside each finest box, eight anywhere in the domain
    (most of them on the coarse levels)."""
    geom = meta.geoms[-1]
    dx = np.array(geom.dx)
    pts = [rng.random((8, 3))]
    for b in meta.bas[-1]:
        lo = np.array(b.lo) * dx + dx
        hi = (np.array(b.hi) + 1) * dx - dx
        pts.append(lo + (hi - lo) * rng.random((3, 3)))
    return np.concatenate(pts)


@pytest.mark.parametrize("case", ["three", "scattered"])
@pytest.mark.parametrize("along_v", [False, True])
def test_stream_and_sample_sparse(cases, case, along_v):
    path = cases[case]
    var, aux = (("blob", "xc") if case == "three" else ("temp", "density"))
    base, fabs = port_base(path)
    seeds = _seeds(base.meta, np.random.default_rng(5))
    kw = dict(n_rk_steps=11, h_rk=0.5,
              trace_field=None if along_v else var, sample_names=(aux,))
    jst = jax_state(path)
    got = trace_streamlines_sparse(base, fabs[-1], seeds, **kw)
    want = jax_trace_sparse(jst, seeds, **kw)
    dense = port_dense(path)
    ref = trace_streamlines(dense, seeds, **kw)
    # seeds on the clusters and on the coarse levels
    fin = base.meta.n_levels - 1
    owner = finest_cluster_of(base.meta, pcl.cluster_boxes(
        base.meta.bas[fin]), got[:, 5, :3])
    assert (owner < 0).any() and len(set(owner[owner >= 0])) >= 2
    _close_scaled(got, want)
    _close_scaled(got, ref)
    names = [aux, var]
    s_got = sample_onto_lines_sparse(base, fabs[-1], got, names)
    s_want = jax_sample_sparse(jst, got, names)
    s_ref = sample_onto_lines(dense, got, names)
    _close_scaled(s_got, s_want)
    _close_scaled(s_got, s_ref)


def _close_scaled(a, b):
    scale = np.maximum(np.abs(b).max(axis=(0, 1)), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-12)


# -- stats --------------------------------------------------------------------
STATS = {
    "cm": ["conditionalMean", "binComp=blob", "avgComps=blob xc", "nBins=8",
           "binMin=0", "binMax=1", "writeBinMinMax=1", "outfile=out.dat"],
    "cm_bounds": ["conditionalMean", "binComp=blob", "avgComps=xc",
                  "nBins=8", "binMin=0", "binMax=1",
                  "bounds=0.2137 0.0 0.0 0.7913 1.0 1.0", "outfile=out.dat"],
    "jpdf": ["jpdf", "vars=blob xc y_velocity", "nBins=8", "output_gnuplot=1",
             "output_plotfile=0"],
}


def _stats_files(tool, who, path):
    if tool == "conditionalMean":
        return {"out.dat": np.loadtxt(f"{who}/out.dat", skiprows=2)}
    return {f: np.loadtxt(os.path.join(path, f)) for f in sorted(
        os.listdir(path)) if f.endswith(".gpd")}


@pytest.mark.parametrize("name", sorted(STATS))
def test_stats_cli(cases, cli_env, capsys, tmp_path, name):
    import shutil
    tool, *keys = STATS[name]
    results = {}
    for who, main, extra in (("port", cli.main, ["device=cpu"]),
                             ("dense", cli.main, ["device=cpu",
                                                  "force_dense=1"]),
                             ("jax", jax_cli.main, [])):
        os.makedirs(who)
        plt = os.path.join(who, "plt")
        shutil.copytree(cases["three"], plt)
        os.chdir(who)
        assert main([tool, "infile=plt", *keys, "dtype=float64",
                     *extra]) == 0
        os.chdir("..")
        assert ("clustered path" in capsys.readouterr().out) == (
            who != "dense")
        results[who] = _stats_files(tool, who, plt)
    for who in ("jax", "dense"):
        assert sorted(results["port"]) == sorted(results[who])
        for f, a in results["port"].items():
            b = results[who][f]
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                       err_msg=f"{who} {f}")
            if tool == "conditionalMean":
                np.testing.assert_array_equal(a[:, -2], b[:, -2])  # N exact
    if name == "cm_bounds":
        # the sub-box bites: hits (finest-equivalent cells) of ~58% of the
        # 192^3 domain
        assert results["port"]["out.dat"][:, -2].sum() < 0.7 * 192 ** 3


# -- CLI keys -----------------------------------------------------------------
@pytest.mark.parametrize("tool, keys", [
    ("grad", ["gradVar=blob"]),
    ("isosurface", ["isoCompName=blob", "isoVal=0.5"]),
    ("conditionalMean", ["binComp=blob", "avgComps=xc", "binMin=0",
                         "binMax=1", "outfile=cm.dat"]),
])
def test_cluster_batch_keys(cases, cli_env, tool, keys):
    """cluster_batch=0 runs the clusters one after another; cluster_batch=1
    (canonical clusters in one XLA dispatch) raises; ndevices=2 deals the
    clusters over two shards and writes the same files."""
    common = [tool, f"infile={cases['three']}", *keys, "device=cpu"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        cli.main([*common, "cluster_batch=1"])
    out = {"grad": "outfile", "isosurface": "outfile_base",
           "conditionalMean": "outfile"}[tool]
    files = {}
    for name, key in (("one", "cluster_batch=0"), ("two", "ndevices=2")):
        assert cli.main([*common, key, f"{out}={name}"]) == 0
        path = name + (".mef" if tool == "isosurface" else "")
        files[name] = sorted(
            (os.path.relpath(os.path.join(r, f), path),
             open(os.path.join(r, f), "rb").read())
            for r, _, fs in os.walk(path) for f in fs) if os.path.isdir(
                path) else open(path, "rb").read()
    assert files["one"] == files["two"]
