"""Parity of the port's ``filterPlt`` and ``flattenAMRFile`` with the JAX
package's: ``filter_weights`` bitwise, ``filter_state`` and
``flatten_to_level`` in float64 within 1e-12 of the largest value of each
component (the same slice-multiply-adds and upsample weights in the same
order), float32 filters within 1e-6; both CLIs' plotfiles FAB for FAB."""
import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.ops.filter import filter_weights as jax_weights
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools.filter_plt import filter_state as jax_filter
from peleanalysis_tpu.tools.flatten_amr import flatten_to_level as jax_flatten
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.ops.filter import filter_weights, separable_filter
from peleanalysis_tpu_torch.tools.filter_plt import filter_state
from peleanalysis_tpu_torch.tools.flatten_amr import flatten_to_level

RTOL = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.fixture(scope="module")
def plts(tmp_path_factory):
    d = tmp_path_factory.mktemp("filter")
    three = str(d / "plt3")
    write_synthetic_plotfile(three, n_cell=16, n_levels=3, max_grid_size=8)
    two = str(d / "plt2d")
    write_synthetic_plotfile(
        two, n_cell=16, n_levels=3, ndim=2, max_grid_size=8,
        fields={"temp": lambda x, y: 300 + 1500 * np.exp(
            -((x - .5) ** 2 + (y - .5) ** 2) / .02),
            "density": lambda x, y: 1 + x * y},
        is_periodic=(False, False))
    return {"three": three, "two": two, "dir": d}


def _states(path, dt):
    jds = JaxDense.from_batched(AmrState.from_plotfile(path, dtype=dt))
    ds = DenseAmrState.from_plotfile(
        path, "cpu", dtype=torch.float64 if dt == np.float64
        else torch.float32)
    return jds, ds


def _close(got, want, dt):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    for c in range(want.shape[0]):
        scale = float(np.abs(want[c]).max())
        np.testing.assert_allclose(got[c], want[c], rtol=0,
                                   atol=RTOL[dt] * scale)


@pytest.mark.parametrize("kind", ["box", "gaussian"])
@pytest.mark.parametrize("fgr", [0, 1, 2, 3, 4, 9, 16])
def test_filter_weights_bitwise(kind, fgr):
    got, want = filter_weights(kind, fgr), jax_weights(kind, fgr)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_filter_weights_unknown_kind():
    with pytest.raises(ValueError, match="unknown filter"):
        filter_weights("tophat", 2)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["box", "gaussian"])
@pytest.mark.parametrize("same", [False, True])
def test_filter_state_parity(plts, dt, kind, same):
    jds, ds = _states(plts["three"], dt)
    names = ["temp", "density"]
    want = jax_filter(jds, kind=kind, fgr=2, same_fgr_all_levels=same,
                      names=names)
    got = filter_state(ds, kind=kind, fgr=2, same_fgr_all_levels=same,
                       names=names)
    assert got.names == want.names == names
    for lev in range(ds.meta.n_levels):
        assert got.data[lev].dtype == ds.dtype
        _close(got.data[lev].numpy(), want.data[lev], dt)


def test_separable_filter_keeps_constants():
    g = torch.full((2, 12, 12, 12), 3.25, dtype=torch.float64)
    w = filter_weights("gaussian", 4)           # half width ceil(3 sigma) = 4
    out = separable_filter(g, w)
    assert len(w) == 9 and out.shape == (2, 4, 4, 4)
    np.testing.assert_allclose(out.numpy(), 3.25, rtol=1e-15)


@pytest.mark.parametrize("case", ["three", "two"])
@pytest.mark.parametrize("interp", ["linear", "pc"])
def test_flatten_to_level_parity(plts, case, interp):
    st = AmrState.from_plotfile(plts[case], dtype=np.float64)
    _, ds = _states(plts[case], np.float64)
    for lev in range(ds.meta.n_levels):
        want = np.asarray(jax_flatten(st, lev, interp))
        got = flatten_to_level(ds, lev, interp)
        # a DIM=2 state's nz = 1 is upsampled along z too, as in JAX
        assert tuple(got.shape[1:3]) == ds.meta.geoms[lev].domain.shape[:2]
        _close(got.numpy(), want, np.float64)


@pytest.fixture
def run_both(monkeypatch, plts):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    d = plts["dir"]
    monkeypatch.chdir(d)

    def run(tool, args, out):
        for who, main, extra in (("port", cli.main, ["device=cpu"]),
                                 ("jax", jax_cli.main, [])):
            assert main([tool, *args, f"outfile={d / (who + out)}",
                         *extra]) == 0
        return str(d / ("port" + out)), str(d / ("jax" + out))
    return run


def _same_plotfile(a, b, rtol):
    ra, rb = PlotfileReader(a), PlotfileReader(b)
    assert ra.var_names == rb.var_names
    assert ra.meta.n_levels == rb.meta.n_levels
    assert ra.meta.ndim == rb.meta.ndim
    for lev in range(ra.meta.n_levels):
        assert ra.box_array(lev) == rb.box_array(lev)
        fa, fb = ra.read_level(lev), rb.read_level(lev)
        for x, y in zip(fa, fb):
            for c in range(x.shape[0]):
                scale = float(np.abs(y[c]).max())
                np.testing.assert_allclose(x[c], y[c], rtol=0,
                                           atol=rtol * scale)


@pytest.mark.parametrize("args", [
    ["vars=temp density", "filter_type=1", "dtype=float64"],
    ["variables=temp", "filter_type=gaussian", "fgr=3",
     "same_fgr_all_levels=1", "dtype=float64"],
    ["base_fgr=2", "max_filter_level=1", "dtype=float64"],
    ["filter_type=2"]])
def test_filter_plt_cli(run_both, plts, args):
    a, b = run_both("filterPlt", [f"infile={plts['three']}", *args],
                    "_filt")
    _same_plotfile(a, b, 1e-12 if "dtype=float64" in args else 1e-6)


@pytest.mark.parametrize("case, args", [
    ("three", []), ("three", ["output_level=1", "output_max_grid_size=16",
                              "interp=pc"]),
    ("two", ["output_max_grid_size=8"])])
def test_flatten_cli(run_both, plts, case, args):
    a, b = run_both("flattenAMRFile", [f"infile={plts[case]}", *args],
                    "_flat_" + case)
    _same_plotfile(a, b, 1e-12)
    assert PlotfileReader(a).meta.n_levels == 1


def test_shape_bucket_refused(plts):
    with pytest.raises(NotImplementedError, match="shape_bucket"):
        cli.main(["filterPlt", f"infile={plts['three']}", "shape_bucket=32",
                  "device=cpu"])
