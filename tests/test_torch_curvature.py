"""Parity of the port's ``curvature`` tool with the JAX package's: the
dense derived-field chain on identical states, and both CLIs on one
plotfile, FAB by FAB."""
import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools.curvature import (
    compute_curvature_dense as jax_curvature)
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.tools.curvature import compute_curvature_dense

CONFIGS = {
    "defaults": {},
    "gauss_strain_velnormal": dict(do_gauss=True, do_strain=True,
                                   do_velnormal=True, get_strain_tensor=True),
    "strain_bug": dict(do_strain=True, replicate_strain_bug=True,
                       do_threshold=True),
}
CLI_KEYS = {
    "defaults": [],
    "gauss_strain_velnormal": ["do_gaussCurv=1", "do_strain=1",
                               "do_velnormal=1"],
    "strain_bug": ["do_strain=1", "replicate_strain_bug=1"],
}


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


def assert_close(got, want, np_dtype, what=""):
    if np_dtype == np.float64:
        # 1e-10: second and third differences of the same data, same order;
        # the magnitude's sqrt may differ by 1 ulp
        atol = 1e-10 * float(np.max(np.abs(want)))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=atol,
                                   err_msg=what)
        return
    # f32: the JAX chain itself is not finite everywhere (0/0 in Kg where
    # |G| = 0 and normg**4 underflows): the non-finite sets must agree, and
    # the finite values within 1e-3 of the largest, since second
    # differences of float32 data cancel
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    if fin.any():
        scale = float(np.max(np.abs(want[fin])))
        assert float(np.max(np.abs(got[fin] - want[fin]))) <= 1e-3 * scale, what


@pytest.fixture(scope="module")
def small_plotfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pltcurv") / "plt00000")
    write_synthetic_plotfile(path, n_cell=16, n_levels=3, max_grid_size=8)
    return path


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_compute_curvature_dense_parity(small_plotfile, config, dt):
    jds = JaxDense.from_batched(AmrState.from_plotfile(small_plotfile,
                                                       dtype=dt))
    kw = CONFIGS[config]
    want = jax_curvature(jds, "temp", **kw)
    got = compute_curvature_dense(port_state(jds), "temp", **kw)
    assert got.names == want.names
    for lev in range(jds.meta.n_levels):
        g, w = got.data[lev].numpy(), np.asarray(want.data[lev])
        assert g.shape == w.shape and g.dtype == w.dtype
        for c, name in enumerate(want.names):
            assert_close(g[c], w[c], dt, f"lev {lev} {name}")


@pytest.mark.parametrize("dtype_key", [[], ["dtype=float64"]])
@pytest.mark.parametrize("config", sorted(CLI_KEYS))
def test_curvature_cli_parity(small_plotfile, tmp_path, monkeypatch, config,
                              dtype_key):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    # both CLIs set a process-wide compute dtype: restore it afterwards
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    ours, ref = str(tmp_path / "port_K"), str(tmp_path / "jax_K")
    common = [f"infile={small_plotfile}", *CLI_KEYS[config], *dtype_key]
    assert cli.main(["curvature", *common, f"outfile={ours}",
                     "device=cpu"]) == 0
    assert jax_cli.main(["curvature", *common, f"outfile={ref}"]) == 0
    ra, rb = PlotfileReader(ours), PlotfileReader(ref)
    assert ra.var_names == rb.var_names
    dt = np.float64 if dtype_key else np.float32
    for lev in range(ra.meta.n_levels):
        fas, fbs = ra.read_level(lev), rb.read_level(lev)
        for fa, fb in zip(fas, fbs):
            for c, name in enumerate(ra.var_names):
                assert_close(fa[c], fb[c], dt, f"lev {lev} {name}")


def test_float32_gaussian_curvature_nonfinite_where_reference_is(
        small_plotfile):
    """The f32 Kg 0/0 of the JAX reference is reproduced, not fixed."""
    jds = JaxDense.from_batched(AmrState.from_plotfile(small_plotfile,
                                                       dtype=np.float32))
    want = jax_curvature(jds, "temp")
    got = compute_curvature_dense(port_state(jds), "temp")
    ik = want.names.index("GaussianCurvature_temp")
    n_bad = sum(int((~np.isfinite(np.asarray(d[ik]))).sum())
                for d in want.data)
    assert n_bad > 0
    assert n_bad == sum(int((~torch.isfinite(d[ik])).sum()) for d in got.data)
    # every other component is finite
    for d in got.data:
        keep = [c for c in range(d.shape[0]) if c != ik]
        assert torch.isfinite(d[keep]).all()
