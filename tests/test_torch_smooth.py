"""Parity of the port's smoothing solve and flux matching with the JAX
package's: restriction, flux-matched gradients, the CG solvers, curvature
with do_smooth=1 (composite and per level) and ``grad fluxMatch=1``, on
the same seeded inputs through both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.ops import restrict as jax_restrict
from peleanalysis_tpu.ops import solve as jax_solve
from peleanalysis_tpu.ops.dense_fill import \
    fill_dense_multilevel as jax_fill
from peleanalysis_tpu.ops.stencil import laplacian as jax_laplacian
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools.curvature import (
    compute_curvature_dense as jax_curvature)
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.ops import restrict, solve
from peleanalysis_tpu_torch.ops.dense_fill import fill_dense_multilevel
from peleanalysis_tpu_torch.ops.stencil import laplacian
from peleanalysis_tpu_torch.tools.curvature import compute_curvature_dense
from peleanalysis_tpu_torch.tools.grad import compute_grad_dense, grad_bc

# CG fields: f64 1e-10 of the largest value (the same iterations, sums
# taken in another order); f32 1e-4 (a float32 CG that cannot reach its
# tolerance runs all its iterations, and rounding steers each one)
CG_TOL = {np.float64: 1e-10, np.float32: 1e-4}


def port_state(jds: JaxDense, device="cpu") -> DenseAmrState:
    """The port's state built from the JAX state's own arrays and boxes."""
    meta = jds.meta
    dt = np.asarray(jds.data[0]).dtype
    return DenseAmrState.from_numpy(
        [(g.domain.lo, g.domain.hi) for g in meta.geoms],
        meta.geoms[0].prob_lo, meta.geoms[0].prob_hi,
        meta.geoms[0].is_periodic, meta.ref_ratio,
        [[(b.lo, b.hi) for b in ba] for ba in meta.bas], jds.names,
        [np.asarray(d) for d in jds.data], device,
        torch.float64 if dt == np.float64 else torch.float32)


def noisy(x, y, z):
    base = np.exp(-((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2) / 0.15 ** 2)
    return 1000.0 * base + 20.0 * np.sin(40 * x) * np.sin(37 * y)


@pytest.fixture(scope="module")
def plotfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pltsmooth") / "plt00000")
    write_synthetic_plotfile(path, n_cell=16, n_levels=3, max_grid_size=8,
                             fields={"temp": noisy,
                                     "density": lambda x, y, z: 1 + x * y})
    return path


def jax_state(path, dt):
    return JaxDense.from_batched(AmrState.from_plotfile(path, dtype=dt))


def dyadic(rng, shape):
    """Random multiples of 2^-10 below 2^10: block means and face
    differences over power-of-two spacings of such values are exact in
    float64 whatever order the terms are summed in, so the comparison is
    bitwise although XLA's CPU reduction and PyTorch's order them apart."""
    return rng.integers(-2 ** 20, 2 ** 20, size=shape) / 1024.0


def test_average_down_all_bitwise(plotfile):
    jds = jax_state(plotfile, np.float64)
    ds = port_state(jds)
    rng = np.random.default_rng(0)
    x = [dyadic(rng, (2,) + tuple(d.shape[1:])) for d in jds.data]
    L = jds.meta.n_levels
    want = jax_restrict.average_down_all(
        jds.meta, jds.lmeta, [jnp.asarray(a) for a in x],
        [jds.covered_mask(l) for l in range(L)])
    got = restrict.average_down_all(
        ds.meta, ds.lmeta, [torch.from_numpy(a) for a in x],
        [ds.covered_mask(l) for l in range(L)])
    for lev in range(L):
        np.testing.assert_array_equal(got[lev].numpy(), np.asarray(want[lev]))
        if ds.covered_mask_np(lev).any():
            assert not np.array_equal(got[lev].numpy(), x[lev])


def test_flux_matched_gradient_bitwise(plotfile):
    jds = jax_state(plotfile, np.float64)
    ds = port_state(jds)
    rng = np.random.default_rng(1)
    grown = [dyadic(rng, (1,) + tuple(s + 2 for s in d.shape[1:]))
             for d in jds.data]
    L = jds.meta.n_levels
    want = jax_restrict.flux_matched_gradient(
        jds.meta, jds.lmeta, [jnp.asarray(g) for g in grown],
        [np.asarray(jds.covered_mask(l)) for l in range(L)])
    cache = {}
    for _ in range(2):          # the second call reads the cached faces
        got = restrict.flux_matched_gradient(
            ds.meta, ds.lmeta, [torch.from_numpy(g) for g in grown],
            [ds.covered_mask_np(l) for l in range(L)], cache)
        for lev in range(L):
            for d in range(3):
                np.testing.assert_array_equal(got[lev][d].numpy(),
                                              np.asarray(want[lev][d]))
    assert len(cache) == 3 * (L - 1)


def _helmholtz(beta, h, roll):
    def apply_A(x):
        lap = 0.0
        for ax in range(3):
            lap = lap + (roll(x, 1, ax) + roll(x, -1, ax) - 2 * x)
        return x - beta * lap / h ** 2
    return apply_A


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("rtol", [1e-8, None])
def test_cg_solve_helmholtz(dt, rtol):
    n, beta = 12, 1e-2
    h = 1.0 / n
    rng = np.random.default_rng(2)
    b = rng.standard_normal((n, n, n)).astype(dt)
    mask = rng.random((n, n, n)) > 0.1
    x0 = np.where(mask, 0.0, b).astype(dt)
    A_j = _helmholtz(beta, h, lambda x, s, ax: jnp.roll(x, s, ax))
    A_t = _helmholtz(beta, h, lambda x, s, ax: torch.roll(x, s, ax))
    want = np.asarray(jax_solve.cg_solve(A_j, jnp.asarray(b), jnp.asarray(x0),
                                         jnp.asarray(mask), 60, rtol=rtol))
    got = solve.cg_solve(A_t, torch.from_numpy(b), torch.from_numpy(x0),
                         torch.from_numpy(mask), 60, rtol=rtol).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=CG_TOL[dt] * np.abs(want).max())
    if rtol is None:
        assert solve.ITERATIONS[-1] == 60
    elif dt == np.float64:
        n_jax = jax_solve.cg_iterations_to_tol(
            lambda xs: [A_j(xs[0])], [jnp.asarray(b)], [jnp.asarray(x0)],
            [jnp.asarray(mask)], [1.0], rtol, max_iter=60)
        assert 0 < solve.ITERATIONS[-1] == n_jax < 60


def _smoothing_ops(jds, ds, smooth_time):
    """The composite smoothing operator of curvature in both packages."""
    L = jds.meta.n_levels
    bc = grad_bc([False] * 3, None)
    jm = [jds.in_level_mask(l) for l in range(L)]
    jc = [jds.covered_mask(l) for l in range(L)]
    pm = [ds.in_level_mask(l) for l in range(L)]
    pc = [ds.covered_mask(l) for l in range(L)]

    def A_j(xs):
        xd = jax_restrict.average_down_all(jds.meta, jds.lmeta, xs, jc)
        g = jax_fill(jds.meta, jds.lmeta, xd, jm, 1, bc, "linear")
        return [xd[l] - smooth_time * jax_laplacian(g[l], jds.meta.geoms[l].dx,
                                                    1) for l in range(L)]

    def A_t(xs):
        xd = restrict.average_down_all(ds.meta, ds.lmeta, xs, pc)
        g = fill_dense_multilevel(ds.meta, ds.lmeta, xd, pm, 1, bc, "linear")
        return [xd[l] - smooth_time * laplacian(g[l], ds.meta.geoms[l].dx, 1)
                for l in range(L)]
    return A_j, A_t


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_cg_solve_composite(plotfile, dt):
    jds = jax_state(plotfile, dt)
    ds = port_state(jds)
    L = jds.meta.n_levels
    A_j, A_t = _smoothing_ops(jds, ds, 1e-3)
    ic = jds.comp("temp")
    bj = [d[ic:ic + 1] / 1000.0 for d in jds.data]
    bt = [torch.from_numpy(np.array(b)) for b in bj]
    vj = [jnp.asarray(jds.valid_mask(l))[None] for l in range(L)]
    vt = [ds.valid_mask(l)[None] for l in range(L)]
    vols = [jds.meta.geoms[l].cell_volume() for l in range(L)]
    want = jax_solve.cg_solve_composite(A_j, bj, bj, vj, vols, 200,
                                        rtol=1e-10)
    got = solve.cg_solve_composite(A_t, bt, bt, vt, vols, 200, rtol=1e-10)
    n_port = solve.ITERATIONS[-1]
    for lev in range(L):
        w = np.asarray(want[lev])
        np.testing.assert_allclose(got[lev].numpy(), w, rtol=0,
                                   atol=CG_TOL[dt] * np.abs(w).max())
    if dt == np.float64:
        n_jax = jax_solve.cg_iterations_to_tol(A_j, bj, bj, vj, vols, 1e-10,
                                               max_iter=200)
        assert 0 < n_port == n_jax < 200
        assert solve.cg_iterations_to_tol(A_t, bt, bt, vt, vols, 1e-10,
                                          max_iter=200) == n_jax
    else:
        assert 0 < n_port <= 200


def assert_curvature_close(got, want, dt, what):
    """f64: 1e-8 of each component's largest value (the CG's 1e-10 relative
    residual, magnified by the differences of differences downstream).
    f32: same non-finite cells and 5e-2 of the largest value: a float32 CG
    that stalls short of its tolerance runs to its cap, its last iterations
    follow the rounding of sums taken in another order, and the curvatures
    are second differences of the result (measured on this case: the
    per-level smoothed progress of the finest level 1.5e-4 apart, its
    Gaussian curvature 1.1e-2)."""
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    if not fin.any():
        return
    scale = float(np.abs(want[fin]).max())
    tol = 1e-8 if dt == np.float64 else 5e-2
    err = float(np.abs(got[fin] - want[fin]).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("composite", [True, False])
def test_curvature_do_smooth_parity(plotfile, composite, dt):
    jds = jax_state(plotfile, dt)
    kw = dict(do_smooth=True, smooth_time=1e-3, smooth_composite=composite)
    want = jax_curvature(jds, "temp", **kw)
    got = compute_curvature_dense(port_state(jds), "temp", **kw)
    assert got.names == want.names
    for lev in range(jds.meta.n_levels):
        g, w = got.data[lev].numpy(), np.asarray(want.data[lev])
        assert g.shape == w.shape and g.dtype == w.dtype
        for c, name in enumerate(want.names):
            assert_curvature_close(g[c], w[c], dt, f"lev {lev} {name}")
    ism = want.names.index("SmoothedProgress")
    ipr = want.names.index("Progress")
    assert not np.array_equal(np.asarray(want.data[-1][ism]),
                              np.asarray(want.data[-1][ipr]))


def _cli_compare(ours, ref, dt, close):
    ra, rb = PlotfileReader(ours), PlotfileReader(ref)
    assert ra.var_names == rb.var_names
    for lev in range(ra.meta.n_levels):
        for fa, fb in zip(ra.read_level(lev), rb.read_level(lev)):
            for c, name in enumerate(ra.var_names):
                close(fa[c], fb[c], dt, f"lev {lev} {name}")


@pytest.fixture
def cli_env(monkeypatch):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    # both CLIs set a process-wide compute dtype: restore it afterwards
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)


@pytest.mark.parametrize("keys", [[], ["smooth_composite=0"]])
def test_curvature_do_smooth_cli_parity(plotfile, tmp_path, cli_env, keys):
    ours, ref = str(tmp_path / "port_K"), str(tmp_path / "jax_K")
    common = [f"infile={plotfile}", "do_smooth=1", "smoothing_time=1e-3",
              "dtype=float64", *keys]
    assert cli.main(["curvature", *common, f"outfile={ours}",
                     "device=cpu"]) == 0
    assert jax_cli.main(["curvature", *common, f"outfile={ref}"]) == 0
    _cli_compare(ours, ref, np.float64, assert_curvature_close)


def assert_grad_close(got, want, dt, what):
    """f64 1e-12, f32 1e-5 relative plus 1e-5 of the largest value (the
    same formulas in the same order; the CPU sqrt may be 1 ulp off)."""
    tol = 1e-12 if dt == np.float64 else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("dtype_key", [[], ["dtype=float64"]])
def test_grad_flux_match_cli_parity(plotfile, tmp_path, cli_env, dtype_key):
    ours, ref = str(tmp_path / "port_gt"), str(tmp_path / "jax_gt")
    common = [f"infile={plotfile}", "fluxMatch=1", *dtype_key]
    assert cli.main(["grad", *common, f"outfile={ours}", "device=cpu"]) == 0
    assert jax_cli.main(["grad", *common, f"outfile={ref}"]) == 0
    _cli_compare(ours, ref, np.float64 if dtype_key else np.float32,
                 assert_grad_close)


def test_flux_match_changes_only_interface_cells(plotfile):
    """fluxMatch differs from the centered gradient only next to coarse
    faces that bound a covered region."""
    ds = port_state(jax_state(plotfile, np.float64))
    plain = compute_grad_dense(ds, "temp")
    fm = compute_grad_dense(ds, "temp", flux_match=True)
    finest = ds.meta.n_levels - 1
    np.testing.assert_allclose(fm.data[finest].numpy(),
                               plain.data[finest].numpy(), rtol=1e-12,
                               atol=1e-12 * float(plain.data[finest].abs().max()))
    diff = (fm.data[0][2:5] - plain.data[0][2:5]).abs().amax(0).numpy()
    changed = diff > 1e-9 * float(plain.data[0][2:5].abs().max())
    assert changed.any()
    cov = ds.covered_mask_np(0)
    near = np.zeros_like(cov)
    for d in range(3):
        faces = restrict.covered_boundary_faces(cov, d)
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[d] = slice(0, -1)
        sl_hi[d] = slice(1, None)
        near |= faces[tuple(sl_lo)] | faces[tuple(sl_hi)]
    assert not (changed & ~near).any()
