"""Parity of the port's ``integral`` and ``rmsVel`` with the JAX package's.

``integrate_along``: float64 within 1e-12 relative of the largest value of
each output; float32 within 1e-5 of it (each level's sums run in float32 on
both sides, in another order: a sum of n terms may round differently by
about n * 2**-24 of its largest partial, n <= 32 here).  The port builds
the measure in the state's dtype, as a JAX CLI process does; the tests run
JAX with x64 on, where a float32 state's measure is float64, so a float32
measure is held within 1e-5 of it.  ``rms_velocity`` and the CLIs' files:
float64 within 1e-12, text files byte for byte."""
import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools.integral import integrate_along as jax_integrate
from peleanalysis_tpu.tools.rms_vel import rms_velocity as jax_rms
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.ops.stats import directional_sum, masked_sum
from peleanalysis_tpu_torch.tools.integral import integrate_along
from peleanalysis_tpu_torch.tools.rms_vel import rms_velocity

RTOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture(scope="module")
def plts(tmp_path_factory):
    d = tmp_path_factory.mktemp("integral")
    three = str(d / "plt3")
    write_synthetic_plotfile(three, n_cell=16, n_levels=3, max_grid_size=8)
    two = str(d / "plt2d")
    write_synthetic_plotfile(
        two, n_cell=16, n_levels=2, ndim=2, max_grid_size=8,
        fields={"progress": lambda x, y: np.exp(-((x - .5) ** 2
                                                  + (y - .5) ** 2) / .05),
                "temp": lambda x, y: 300 + 1500 * x * y,
                "x_velocity": lambda x, y: -(y - .5) + .1 * x,
                "y_velocity": lambda x, y: (x - .5) * (1 + y)},
        is_periodic=(False, False))
    return {"three": three, "two": two, "dir": d}


def _states(path, dt):
    jds = JaxDense.from_batched(AmrState.from_plotfile(path, dtype=dt))
    ds = DenseAmrState.from_plotfile(
        path, "cpu", dtype=torch.float64 if dt == np.float64
        else torch.float32)
    return jds, ds


def _close(got, want, dt):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), np.finfo(np.float64).tiny)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL[dt] * scale)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("int_dirs", [[0, 1, 2], [2], [0, 1]])
@pytest.mark.parametrize("cond, avg", [(None, False), ("progress", True),
                                       ("progress", False)])
def test_integrate_along_parity(plts, dt, int_dirs, cond, avg):
    jds, ds = _states(plts["three"], dt)
    names = ["temp", "density"]
    kw = dict(c_name=cond, c_min=0.05, c_max=0.7, avg=avg)
    wc, ww, wf = jax_integrate(jds, names, int_dirs, **kw)
    gc, gw, gf = integrate_along(ds, names, int_dirs, **kw)
    for a, b in zip(gc, wc):
        np.testing.assert_array_equal(a, b)
    # the measure: in the state's dtype here, float64 in JAX with x64 on
    _close(gw, ww, dt)
    for a, b in zip(gf, wf):
        _close(a, b, dt)


def test_measure_in_state_dtype(plts):
    """A float32 state sums its measure in float32: the cells' widths are
    powers of two, so its sums are exact and equal a float64 state's; the
    fields' float32 sums stay within 1e-5 of the float64 ones."""
    _, ds32 = _states(plts["three"], np.float32)
    _, ds64 = _states(plts["three"], np.float64)
    kw = dict(c_name="progress", c_min=0.05, c_max=0.7)
    _, w32, f32 = integrate_along(ds32, ["temp"], [2], **kw)
    _, w64, f64 = integrate_along(ds64, ["temp"], [2], **kw)
    np.testing.assert_array_equal(w32, w64)
    _close(f32[0], f64[0], np.float32)


@pytest.mark.parametrize("int_dirs", [[0, 1, 2], [1], [0]])
def test_integrate_along_2d(plts, int_dirs):
    jds, ds = _states(plts["two"], np.float64)
    wc, ww, wf = jax_integrate(jds, ["progress"], int_dirs, avg=True)
    gc, gw, gf = integrate_along(ds, ["progress"], int_dirs, avg=True)
    _close(gw, ww, np.float64)
    _close(gf[0], wf[0], np.float64)
    if int_dirs == [0, 1, 2]:
        assert abs(float(gw) - 1.0) < 1e-12   # dz = 1: the domain's area


def test_stats_sums():
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.random((4, 5, 6)))
    m = torch.from_numpy(rng.random((4, 5, 6)) > 0.3)
    want = np.where(m.numpy(), v.numpy(), 0.0) * 0.25
    np.testing.assert_allclose(float(masked_sum(v, m, 0.25)), want.sum(),
                               rtol=1e-14)
    np.testing.assert_allclose(directional_sum(v, m, 0.25, (0, 2)).numpy(),
                               want.sum(axis=(0, 2)), rtol=1e-14)


@pytest.fixture
def run_both(monkeypatch, plts):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    d = plts["dir"]
    monkeypatch.chdir(d)

    def run(tool, args, base_key, base):
        for who, main, extra in (("port", cli.main, ["device=cpu"]),
                                 ("jax", jax_cli.main, [])):
            assert main([tool, *args, f"{base_key}={d / (who + base)}",
                         "dtype=float64", *extra]) == 0
        return str(d / ("port" + base)), str(d / ("jax" + base))
    return run


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


@pytest.mark.parametrize("args, files", [
    (["integralDimension=3", "cVar=progress", "cMin=0.1", "cMax=0.9"],
     [".dat"]),
    (["integralDimension=2", "dir1=0", "dir2=2", "avg=1"],
     ["_x.dat", "_temp.dat", "_density.dat"]),
    (["integralDimension=1", "dir=1"],
     ["_x.dat", "_y.dat", "_temp.dat", "_density.dat"]),
    (["integralDimension=1", "dir=2", "format=ppm", "useminmax2=0.3 0.9"],
     ["_x.dat", "_y.dat", "_temp.ppm", "_density.ppm"])])
def test_integral_cli_files(run_both, plts, args, files):
    a, b = run_both("integral", [f"infile={plts['three']}",
                                 "vars=temp density", *args],
                    "outfile_base", "_int")
    for f in files:
        _same_bytes(a + f, b + f)


def test_integral_cli_2d(run_both, plts):
    a, b = run_both("integral", [f"infile={plts['two']}", "vars=temp",
                                 "integralDimension=1", "dir=0"],
                    "outfile_base", "_int2")
    for f in ("_x.dat", "_y.dat", "_temp.dat"):
        _same_bytes(a + f, b + f)


@pytest.mark.parametrize("case", ["three", "two"])
def test_rms_velocity_parity(plts, case):
    jds, ds = _states(plts[case], np.float64)
    want = jax_rms(jds)
    np.testing.assert_allclose(rms_velocity(ds), want, rtol=1e-12)
    assert want > 0


def test_rms_vel_cli(run_both, plts):
    files = f"{plts['three']} {plts['two']} {plts['three']}"
    a, b = run_both("rmsVel", [f"infile={files}", "prefetch=2"], "outfile",
                    "_rms.dat")
    _same_bytes(a, b)
    assert len(open(a).read().splitlines()) == 3
