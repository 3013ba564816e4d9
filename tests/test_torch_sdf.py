"""Parity of the port's signed-distance engine (``geom/sdf.py``),
``buildDistance`` and ``isosurface build_distance_function=1`` with the
JAX package's, on the CPU.

Tolerances: ``point_tri_distance`` within 1e-12 of the distance (float64)
and exactly equal on float32-rounded triangles with float64 points (the
JAX seeding's promotion).  Band seeding against the JAX device band:
float64 centres against JAX with x64 on (conftest) within 1e-12, float32
centres against a JAX process with x64 off within 4 float32 ulps; the
ids equal but at near ties, where XLA's fused jit rounds a distance an
ulp apart from the eager ops (under 1% of the cells, each held to a tie
within the same tolerance); the tie rule exact on duplicate triangles.
From equal seeds the sweeps, grids and plotfiles: ``|phi|`` within 1e-6
* dmax (1e-12 for the bare sweeps, the ids equal) and the sign equal
wherever ``|phi| > 1e-6 * dx``.  The whole pipelines, each seeding on its
own: a near tie can carry another id through the sweeps, so under 2% of
the cells may differ, within 0.02 dmax, the tolerance JAX's own tests
give its two seeding engines (tests/test_sdf.py).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.geom import sdf as jsdf
from peleanalysis_tpu.io.plotfile import PlotfileReader as JaxReader
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.geom import sdf
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from tests.test_mef_tools import make_sphere_mef

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """The sweeps launch ~170 small ops a plane: on the CPU, intra-op
    threads only contend (most with the suite's other workers)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_point_tri_distance_regions():
    a, b, c = (np.array(v) for v in ([0.0, 0, 0], [1.0, 0, 0], [0.0, 1, 0]))
    for p, want in (([0.2, 0.2, 0.5], 0.5), ([-1.0, -1.0, 0.0], np.sqrt(2)),
                    ([0.5, -2.0, 0.0], 2.0)):
        got = sdf.point_tri_distance(_t(np.array(p)), _t(a), _t(b), _t(c))
        assert abs(float(got) - want) < 1e-12


@pytest.mark.parametrize("tri_dtype", [np.float64, np.float32])
def test_point_tri_distance_matches_jax(tri_dtype):
    """Every region of random triangles against random points: float64
    within 1e-12; float32 triangles with float64 points (the seeding's
    mixed promotion) against jnp, equal."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    p = rng.normal(size=(4000, 3))
    tri = rng.normal(size=(4000, 3, 3)).astype(tri_dtype)
    got = sdf.point_tri_distance(_t(p), _t(tri[:, 0]), _t(tri[:, 1]),
                                 _t(tri[:, 2])).numpy()
    if tri_dtype == np.float64:
        want = jsdf.point_tri_distance(p, tri[:, 0], tri[:, 1], tri[:, 2])
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    else:
        want = np.asarray(jsdf.point_tri_distance(
            jnp.asarray(p), jnp.asarray(tri[:, 0]), jnp.asarray(tri[:, 1]),
            jnp.asarray(tri[:, 2]), xp=jnp))
        assert want.dtype == got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


def _sphere_grid(n=32):
    mef = make_sphere_mef(28, r=0.3)
    tri = mef.positions()[mef.elements]
    dx = np.array([2.0 / n] * 3)
    return tri, np.array([-1.0, -1.0, -1.0]), dx, (n, n, n)


def _near_ties(phi, cl, want_cl, tri, origin, dx, seed_dtype, atol,
               share=0.01):
    """Where the ids differ, JAX's triangle is as close as the port's
    (within atol): a near tie that an ulp of rounding decided.  The band
    measures to float32 triangles from ``seed_dtype`` centres, the sweeps
    (``seed_dtype`` None) to float64 triangles from float64 centres."""
    diff = np.nonzero(cl != want_cl)
    assert len(diff[0]) <= share * cl.size
    assert (cl[diff] >= 0).all() and (want_cl[diff] >= 0).all()
    centre = _t(origin + (np.stack(diff, -1) + 0.5) * dx)
    t = _t(tri[want_cl[diff]])
    if seed_dtype is not None:
        centre, t = centre.to(seed_dtype), t.to(torch.float32)
    d = sdf.point_tri_distance(centre, t[:, 0], t[:, 1],
                               t[:, 2]).double().numpy()
    np.testing.assert_allclose(d, phi[diff], rtol=0, atol=atol)


@pytest.mark.parametrize("shape_n, dmax_cells", [(40, 8), (24, 3)])
def test_band_seed_matches_jax(shape_n, dmax_cells):
    """float64 centres against the JAX device band under x64 (float32
    triangles, float64 centres): phi within 1e-12, ids equal but at near
    ties."""
    tri, origin, dx, shape = _sphere_grid(shape_n)
    dmax = dmax_cells * dx[0]
    want_phi, want_cl = jsdf.band_seed_device(tri, origin, dx, shape, dmax)
    phi, cl = sdf.band_seed(tri, _t(tri), origin, dx, shape, dmax,
                            seed_dtype=torch.float64)
    np.testing.assert_allclose(phi.numpy(), want_phi, rtol=0,
                               atol=1e-12 * dmax)
    _near_ties(phi.numpy(), cl.numpy(), want_cl, tri, origin, dx,
               torch.float64, 1e-12 * dmax)


_F32_BAND = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from peleanalysis_tpu.geom.sdf import band_seed_device
from tests.test_mef_tools import make_sphere_mef
mef = make_sphere_mef(28, r=0.3)
tri = mef.positions()[mef.elements]
n = 40
dx = np.array([2.0 / n] * 3)
phi, cl = band_seed_device(tri, np.array([-1.0] * 3), dx, (n, n, n), 8 * dx[0])
np.savez(sys.argv[1], phi=phi, cl=cl)
"""


def test_band_seed_float32_matches_a_jax_process(tmp_path):
    """float32 centres against the band of a JAX process with x64 off (the
    JAX CLI's default): phi within 4 float32 ulps of the coordinates, ids
    equal but at near ties."""
    out = str(tmp_path / "band.npz")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _F32_BAND, out], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    z = np.load(out)
    tri, origin, dx, shape = _sphere_grid(40)
    phi, cl = sdf.band_seed(tri, _t(tri), origin, dx, shape, 8 * dx[0])
    # 4 float32 ulps of the coordinates' magnitude (1)
    np.testing.assert_allclose(phi.numpy(), z["phi"], rtol=0,
                               atol=4 * 2.0 ** -24)
    _near_ties(phi.numpy(), cl.numpy(), z["cl"], tri, origin, dx,
               torch.float32, 4 * 2.0 ** -24)


def test_band_seed_tie_rule():
    """Two copies of one triangle: every tie goes to the first."""
    tri = np.array([[[0.31, 0.42, 0.5], [0.62, 0.45, 0.51],
                     [0.47, 0.7, 0.49]]] * 2)
    dx = (1.0 / 16,) * 3
    phi, cl = sdf.band_seed(tri, _t(tri), (0.0, 0.0, 0.0), dx, (16,) * 3,
                            0.5, seed_dtype=torch.float64)
    want_phi, want_cl = jsdf.band_seed_device(tri, (0.0,) * 3, dx,
                                              (16,) * 3, 0.5)
    assert ((cl.numpy() == 0) | (cl.numpy() == -1)).all()
    np.testing.assert_array_equal(cl.numpy(), want_cl)
    np.testing.assert_allclose(phi.numpy(), want_phi, rtol=1e-12, atol=0)


@pytest.fixture
def same_seeds(monkeypatch):
    """JAX's pipeline seeded by the port's float64 band (conftest's x64):
    what follows the seeding is then compared on equal inputs."""
    def seeds(tri, origin, dx, shape, dmax, exact_band=1, chunk=16384):
        phi, cl = sdf.band_seed(tri, _t(tri), origin, dx, shape, dmax,
                                exact_band, torch.float64)
        return phi.numpy().copy(), cl.numpy().copy()
    monkeypatch.setattr(jsdf, "band_seed_device", seeds)


@pytest.mark.parametrize("case", ["sphere", "one_triangle"])
def test_sweeps_match_jax(same_seeds, case):
    """The plane sweeps from equal seeds: phi within 1e-12 of dmax and the
    carried ids equal but at near ties."""
    if case == "sphere":
        tri, origin, dx, shape = _sphere_grid()
        dmax = 0.4
    else:
        tri = np.array([[[0.49, 0.49, 0.50], [0.51, 0.49, 0.50],
                         [0.50, 0.52, 0.50]]])
        origin, dx = np.zeros(3), np.full(3, 1 / 32)
        shape, dmax = (32,) * 3, 2.0
    phi, cl = sdf.unsigned_distance_grid(tri, origin, dx, shape, dmax,
                                         seed_dtype=torch.float64)
    want, want_cl = jsdf.unsigned_distance_grid(tri, origin, dx, shape, dmax)
    np.testing.assert_allclose(phi.numpy(), want, rtol=0, atol=1e-12 * dmax)
    # PyTorch's CPU sqrt is not correctly rounded: an ulp can decide a
    # near tie between two carried ids
    _near_ties(phi.numpy(), cl.numpy(), want_cl, tri, origin, dx, None,
               1e-12 * dmax, share=1e-3)


@pytest.mark.parametrize("seed_dtype", [torch.float64, torch.float32])
def test_sphere_sdf(seed_dtype):
    """Sphere of radius 0.3, the whole pipeline: against the analytic
    distance (1.2 dx, JAX's own bound) and against JAX's grid, which is
    equal to 1e-6 dmax but where a near tie in the band carried another
    id through the sweeps (JAX's own engines differ there, within 0.02
    dmax: tests/test_sdf.py); parity sign equal to JAX's, -1 inside."""
    tri, origin, dx, shape = _sphere_grid()
    dmax = 0.4
    phi, cl = sdf.unsigned_distance_grid(tri, origin, dx, shape, dmax,
                                         seed_dtype=seed_dtype)
    phi = phi.numpy()
    want, _ = jsdf.unsigned_distance_grid(tri, origin, dx, shape, dmax)
    off = np.abs(phi - want) > 1e-6 * dmax
    assert off.mean() < 0.02
    np.testing.assert_allclose(phi, want, rtol=0, atol=0.02 * dmax)
    sgn = sdf.parity_sign(tri, origin, dx, shape).numpy()
    np.testing.assert_array_equal(sgn, jsdf.parity_sign(tri, origin, dx,
                                                        shape))
    cs = origin[0] + (np.arange(shape[0]) + 0.5) * dx[0]
    X, Y, Z = np.meshgrid(cs, cs, cs, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    exact = np.clip(np.abs(r - 0.3), 0, dmax)
    sel = exact < dmax - 2 * dx[0]
    assert np.abs(phi - exact)[sel].max() < 1.2 * dx[0]
    assert (sgn[r < 0.3 - dx[0]] == -1).all()
    assert (sgn[(r > 0.3 + dx[0]) & sel] == 1).all()


def test_sweeps_propagate_across_whole_grid():
    """One small triangle, 32^3 cells, dmax beyond the domain: every cell
    carries its exact distance (the sweeps' float64 re-evaluation)."""
    tri = np.array([[[0.49, 0.49, 0.50], [0.51, 0.49, 0.50],
                     [0.50, 0.52, 0.50]]])
    n = 32
    phi, _ = sdf.unsigned_distance_grid(tri, (0.0, 0.0, 0.0), (1.0 / n,) * 3,
                                        (n, n, n), dmax=2.0,
                                        seed_dtype=torch.float64)
    cs = (np.arange(n) + 0.5) / n
    P = np.stack(np.meshgrid(cs, cs, cs, indexing="ij"), -1).reshape(-1, 3)
    want = jsdf.point_tri_distance(P, *(np.broadcast_to(tri[0, i], P.shape)
                                        for i in range(3)))
    assert (phi.numpy() < 2.0).all()
    np.testing.assert_allclose(phi.numpy().reshape(-1), want, atol=1e-9)


def test_parity_sign_diagonal_edges_not_double_counted():
    """A cube of diagonal-split quads sampled on rows through the
    diagonals: inside -1, outside +1, as JAX."""
    lo, hi = 0.25, 0.75
    tris = []
    for axis in range(3):
        for side in (lo, hi):
            pts = []
            for u, v in [[lo, lo], [hi, lo], [hi, hi], [lo, hi]]:
                p = [0.0, 0.0, 0.0]
                p[axis], p[(axis + 1) % 3], p[(axis + 2) % 3] = side, u, v
                pts.append(p)
            tris += [[pts[0], pts[1], pts[2]], [pts[0], pts[2], pts[3]]]
    tris = np.asarray(tris)
    n = 8
    sgn = sdf.parity_sign(tris, (0.0,) * 3, (1.0 / n,) * 3, (n,) * 3).numpy()
    cs = (np.arange(n) + 0.5) / n
    ins = (cs > lo) & (cs < hi)
    inside = ins[:, None, None] & ins[None, :, None] & ins[None, None, :]
    assert (sgn[inside] == -1).all() and (sgn[~inside] == 1).all()
    np.testing.assert_array_equal(sgn, jsdf.parity_sign(
        tris, (0.0,) * 3, (1.0 / n,) * 3, (n,) * 3))


# -- the CLIs ----------------------------------------------------------------
@pytest.fixture(scope="module")
def surf(tmp_path_factory):
    d = tmp_path_factory.mktemp("sdf")
    plt = str(d / "plt")
    write_synthetic_plotfile(plt, n_cell=16, n_levels=2)
    base = str(d / "surf")
    assert jax_cli.main(["isosurface", f"infile={plt}", "isoCompName=progress",
                         "isoVal=0.5", f"outfile_base={base}"]) == 0
    return {"dir": d, "plt": plt, "mef": base + ".mef"}


@pytest.fixture
def clean_dtypes(monkeypatch):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)


def close_distance(a: str, b: str, dmax: float, near: float = 0.0) -> None:
    """|phi| within 1e-6 dmax (all but a ``near`` share of the cells, held
    within 0.02 dmax: near ties of an independent seeding); the sign equal
    where |phi| > 1e-6 dx."""
    ra, rb = PlotfileReader(a), JaxReader(b)
    assert ra.var_names == rb.var_names == ["distance"]
    assert ra.meta.n_levels == rb.meta.n_levels
    for lev in range(ra.meta.n_levels):
        assert [repr(x) for x in ra.box_array(lev)] == \
            [repr(x) for x in rb.box_array(lev)]
        x = np.concatenate([f.ravel() for f in ra.read_level(lev)])
        y = np.concatenate([f.ravel() for f in rb.read_level(lev)])
        off = np.abs(np.abs(x) - np.abs(y)) > 1e-6 * dmax
        assert off.mean() <= near
        np.testing.assert_allclose(np.abs(x), np.abs(y), rtol=0,
                                   atol=0.02 * dmax if near else 1e-6 * dmax)
        dx = rb.meta.geometry(lev).dx[0]
        far = np.abs(y) > 1e-6 * dx
        np.testing.assert_array_equal(np.sign(x[far]), np.sign(y[far]))
        assert (np.abs(x) <= dmax).all()


@pytest.mark.parametrize("args", [
    ["signComp=progress", "isoVal=0.5"],
    ["dmax=0.1"],
    ["signComp=progress", "isoVal=0.5", "finestLevel=0"]])
def test_build_distance_cli(surf, clean_dtypes, same_seeds, args):
    """From equal seeds (float64), the plotfiles within 1e-6 dmax."""
    d = surf["dir"]
    outs = []
    for who, main, extra in (("port", cli.main, ["device=cpu"]),
                             ("jax", jax_cli.main, [])):
        out = str(d / f"{who}_dist_{len(args)}_{args[-1]}")
        assert main(["buildDistance", f"infile={surf['plt']}",
                     f"isoFile={surf['mef']}", *args, f"outfile={out}",
                     "dtype=float64", *extra]) == 0
        outs.append(out)
    dmax = 0.1 if "dmax=0.1" in args else (
        4.0 / 16 if "finestLevel=0" in args else 4.0 / 32)
    close_distance(*outs, dmax)
    v = np.concatenate([f.ravel() for f in
                        PlotfileReader(outs[0]).read_level(0)])
    assert v.min() < 0 < v.max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_build_distance_cli_end_to_end(surf, clean_dtypes, dtype):
    """Each CLI seeding on its own, in a JAX CLI process (x64 off by
    default, on with dtype=float64): within 1e-6 dmax but at the near
    ties of the band (under 2% of the cells, within 0.02 dmax), the sign
    equal."""
    d = surf["dir"]
    port, jax_out = str(d / f"port_e2e_{dtype}"), str(d / f"jax_e2e_{dtype}")
    assert cli.main(["buildDistance", f"infile={surf['plt']}",
                     f"isoFile={surf['mef']}", f"outfile={port}",
                     f"dtype={dtype}", "device=cpu"]) == 0
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               PELE_JAX_CACHE="0")
    res = subprocess.run(
        [sys.executable, "-m", "peleanalysis_tpu", "buildDistance",
         f"infile={surf['plt']}", f"isoFile={surf['mef']}",
         f"outfile={jax_out}", f"dtype={dtype}"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    close_distance(port, jax_out, 4.0 / 32, near=0.02)


@pytest.mark.parametrize("args", [["dmax=0.1"], ["dist_outfile"]])
def test_isosurface_inrun_distance(surf, clean_dtypes, same_seeds, args):
    """isosurface build_distance_function=1 from equal seeds: the distance
    plotfiles within 1e-6 dmax, negative where progress < 0.5."""
    d = surf["dir"]
    outs = []
    for who, main, extra in (("port", cli.main, ["device=cpu"]),
                             ("jax", jax_cli.main, [])):
        dist = str(d / f"{who}_iso_dist_{args[0]}")
        keys = [f"dist_outfile={dist}"] if args[0] == "dist_outfile" \
            else [*args, f"outfile={dist}"]
        assert main(["isosurface", f"infile={surf['plt']}",
                     "isoCompName=progress", "isoVal=0.5",
                     f"outfile_base={d / (who + '_iso')}",
                     "build_distance_function=1", "dtype=float64", *keys,
                     *extra]) == 0
        outs.append(dist)
    close_distance(*outs, 0.1 if args[0] == "dmax=0.1" else 4.0 / 32)


def test_isosurface_distance_refusals(tmp_path):
    p2 = str(tmp_path / "plt2d")
    write_synthetic_plotfile(p2, n_cell=16, n_levels=1, ndim=2)
    with pytest.raises(ValueError, match="DIM=3"):
        cli.main(["isosurface", f"infile={p2}", "isoCompName=progress",
                  "isoVal=0.5", "build_distance_function=1", "device=cpu",
                  f"outfile_base={tmp_path / 's2'}"])
    p3 = str(tmp_path / "plt3d")
    write_synthetic_plotfile(p3, n_cell=16, n_levels=2)
    with pytest.raises(ValueError, match="force_dense=1"):
        cli.main(["isosurface", f"infile={p3}", "isoCompName=progress",
                  "isoVal=0.5", "surface_is_large=1",
                  "build_distance_function=1", "device=cpu",
                  f"outfile_base={tmp_path / 's3'}"])
