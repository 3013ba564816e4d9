"""Parity of the port's statistics with the JAX package's: the binning
primitives (plain versions of the stats kernel), bin edges under both
dtypes and both JAX x64 modes, the conditionalMean and jpdf accumulators,
and both CLIs against the JAX CLIs' files, on the same seeded inputs."""
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.ops import stats as jax_stats
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools import conditional_mean as jax_cm
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.io.fab import read_fab
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.ops import stats
from peleanalysis_tpu_torch.ops import stats_kernels as sk
from peleanalysis_tpu_torch.tools import conditional_mean as cm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Sums: f64 1e-10 of the largest |value| (float64 terms summed in another
# order); f32 1e-4 (the JAX package sums float32 terms in float32 chunks,
# the port in float64, and a bin holds up to a few thousand terms).  Hits
# are counts times the weight: equal.
TOL = {np.float64: 1e-10, np.float32: 1e-4}


def close(got, want, dt, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    if fin.any():
        scale = float(np.abs(want[fin]).max())
        np.testing.assert_allclose(got[fin], want[fin], rtol=TOL[dt],
                                   atol=TOL[dt] * scale, err_msg=what)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)


def port_state(jds: JaxDense, device="cpu") -> DenseAmrState:
    """The port's state built from the JAX state's own arrays and boxes."""
    meta = jds.meta
    dt = np.asarray(jds.data[0]).dtype
    ds = DenseAmrState.from_numpy(
        [(g.domain.lo, g.domain.hi) for g in meta.geoms],
        meta.geoms[0].prob_lo, meta.geoms[0].prob_hi,
        meta.geoms[0].is_periodic, meta.ref_ratio,
        [[(b.lo, b.hi) for b in ba] for ba in meta.bas], jds.names,
        [np.asarray(d) for d in jds.data], device,
        torch.float64 if dt == np.float64 else torch.float32)
    ds.meta.ndim2 = bool(getattr(meta, "ndim2", False))
    return ds


def edge_values(rng, lo, hi, nbins, n, dt):
    """n values of dtype dt: a third on the float64 bin edges rounded to
    dt and up to two ulps either side, the rest spread over [lo, hi]
    widened by a tenth on each side."""
    edges = (lo + (hi - lo) * np.arange(nbins + 1) / nbins).astype(dt)
    near = [edges]
    for direction in (np.inf, -np.inf):
        e = edges
        for _ in range(2):
            e = np.nextafter(e, dt(direction))
            near.append(e)
    near = np.concatenate(near)
    span = hi - lo
    out = (rng.random(n) * 1.2 * span + lo - 0.1 * span).astype(dt)
    k = n // 3
    out[:k] = rng.choice(near, size=k)
    rng.shuffle(out)
    return out


def same_edges_both_modes(*bounds, nbins):
    """The tests run JAX with x64 on (conftest.py) and the port's tools run
    as a JAX CLI process does, with it off: compare the tools only on
    bounds whose float32 bin transforms agree in both modes."""
    for lo, hi in zip(bounds[::2], bounds[1::2]):
        for folded in (False, True):
            assert (sk.bin_transform(lo, hi, nbins, torch.float32, folded,
                                     x64=True)
                    == sk.bin_transform(lo, hi, nbins, torch.float32, folded,
                                        x64=False)), (lo, hi)


SHAPE = (10, 12, 16)


def _inputs(dt, seed, lo=0.1, hi=0.7, nbins=37, ncomp=2):
    rng = np.random.default_rng(seed)
    n = int(np.prod(SHAPE))
    bv = edge_values(rng, lo, hi, nbins, n, dt).reshape(SHAPE)
    av = (rng.standard_normal((ncomp,) + SHAPE) * 3 + 1000).astype(dt)
    w = (rng.integers(1, 9, SHAPE) * 0.5).astype(dt)
    mask = rng.random(SHAPE) > 0.2
    shift = np.asarray([1000.5, 999.0][:ncomp], dt)
    return bv, av, w, mask, shift


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("cell_weight", [False, True])
def test_binned_stats_parity(dt, clamp, minmax, cell_weight):
    bv, av, w, mask, shift = _inputs(dt, 0)
    weight = w if cell_weight else 8.0
    want = jax_stats.binned_stats(
        jnp.asarray(bv), jnp.asarray(av),
        jnp.asarray(w) if cell_weight else 8.0, jnp.asarray(mask), 0.1, 0.7,
        37, clamp=clamp, with_minmax=minmax, shift=jnp.asarray(shift))
    got = stats.binned_stats(
        torch.from_numpy(bv), torch.from_numpy(av),
        torch.from_numpy(w) if cell_weight else weight,
        torch.from_numpy(mask), 0.1, 0.7, 37, clamp=clamp,
        with_minmax=minmax, shift=torch.from_numpy(shift), x64=True)
    assert got[0].dtype == getattr(torch, np.dtype(dt).name)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for k, name in ((1, "sums"), (2, "sumsq")):
        close(got[k].numpy(), want[k], dt, name)
    if minmax:
        for k in (3, 4):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    else:
        assert got[3] is None and got[4] is None


@partial(jax.jit, static_argnames=("lo", "hi", "nbins"))
def _jax_tool_hits(v, mask, lo, hi, nbins):
    """binned_stats as the JAX tools call it: static (constant) edges."""
    return jax_stats.binned_stats(v, v[None], 1.0, mask, lo, hi, nbins)[0]


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("folded", [False, True])
def test_bin_edges_match_jax(dt, folded):
    """Cells on bin edges and 1-2 ulps either side land in the JAX bins,
    with traced edges (true division) and with the tools' constant edges
    (XLA's folded reciprocal); the other form would move some of them."""
    lo, hi, nb = 0.1, 0.7, 37
    rng = np.random.default_rng(5)
    v = edge_values(rng, lo, hi, nb, 30000, dt)
    mask = np.ones(v.shape, bool)
    if folded:
        want = np.asarray(_jax_tool_hits(jnp.asarray(v), jnp.asarray(mask),
                                         lo, hi, nb))
    else:
        want = np.asarray(jax_stats.binned_stats(
            jnp.asarray(v), jnp.asarray(v)[None], 1.0, jnp.asarray(mask), lo,
            hi, nb)[0])
    tv, tm = torch.from_numpy(v), torch.from_numpy(mask)
    got = stats.binned_stats(tv, tv[None], 1.0, tm, lo, hi, nb,
                             folded=folded, x64=True)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    other = stats.binned_stats(tv, tv[None], 1.0, tm, lo, hi, nb,
                               folded=not folded, x64=True)[0]
    if dt == np.float32:
        assert not np.array_equal(other.numpy(), want)


def test_bin_transform_rounding():
    """The span is float64-then-rounded with x64 (or a float64 state) and
    a float32 difference of rounded edges without it."""
    f32 = np.float32
    lo, span, div = sk.bin_transform(0.1, 0.7, 37, torch.float32, False,
                                     x64=True)
    assert div and lo == float(f32(0.1)) and span == float(f32(0.7 - 0.1))
    lo, span, div = sk.bin_transform(0.1, 0.7, 37, torch.float32, False,
                                     x64=False)
    assert span == float(f32(f32(0.7) - f32(0.1))) != float(f32(0.7 - 0.1))
    lo, k, div = sk.bin_transform(0.1, 0.7, 37, torch.float64, True)
    assert not div and k == (1.0 / (0.7 - 0.1)) * 37


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("cell_weight", [False, True])
def test_joint_pdf_parity(dt, cell_weight):
    rng = np.random.default_rng(1)
    n = int(np.prod(SHAPE))
    v1 = edge_values(rng, 300.0, 1801.0, 24, n, dt).reshape(SHAPE)
    v2 = edge_values(rng, -0.1, 1.1, 24, n, dt).reshape(SHAPE)
    vol = (rng.integers(1, 5, SHAPE) / 64.0).astype(dt)
    mask = rng.random(SHAPE) > 0.3
    c1, c2 = dt(1000.0), dt(0.5)
    want = jax_stats.joint_pdf(
        jnp.asarray(v1), jnp.asarray(v2),
        jnp.asarray(vol) if cell_weight else 1 / 64, jnp.asarray(mask),
        300.0, 1801.0, -0.1, 1.1, 24, shift1=c1, shift2=c2)
    got = stats.joint_pdf(
        torch.from_numpy(v1), torch.from_numpy(v2),
        torch.from_numpy(vol) if cell_weight else 1 / 64,
        torch.from_numpy(mask), 300.0, 1801.0, -0.1, 1.1, 24,
        shift1=float(c1), shift2=float(c2), x64=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[1].numpy(), want[1], dt, "bx1")
    close(got[2].numpy(), want[2], dt, "bx2")


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_joint_pdf_multi_parity(dt):
    rng = np.random.default_rng(2)
    n = int(np.prod(SHAPE))
    lo, hi = [300.0, -0.1, 0.05], [1801.0, 1.1, 1.3]
    vals = np.stack([edge_values(rng, lo[k], hi[k], 20, n, dt)
                     for k in range(3)]).reshape((3,) + SHAPE)
    mask = rng.random(SHAPE) > 0.3
    sh = np.asarray([1000.0, 0.5, 0.7], dt)
    pairs = ((0, 1), (0, 2), (1, 2))
    want = jax_stats.joint_pdf_multi(
        jnp.asarray(vals), 0.125, jnp.asarray(mask), np.asarray(lo, dt),
        np.asarray(hi, dt), 20, pairs, shifts=jnp.asarray(sh))
    got = stats.joint_pdf_multi(
        torch.from_numpy(vals), 0.125, torch.from_numpy(mask), lo, hi, 20,
        pairs, shifts=torch.from_numpy(sh))
    assert got[0].shape == (3, 20, 20)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[1].numpy(), want[1], dt, "bx1")
    close(got[2].numpy(), want[2], dt, "bx2")
    empty = stats.joint_pdf_multi(torch.from_numpy(vals), 0.125,
                                  torch.from_numpy(mask), lo, hi, 20, ())
    assert all(e.shape == (0, 20, 20) for e in empty)


def test_masked_mean_and_reconstruct_moments():
    rng = np.random.default_rng(3)
    v = rng.standard_normal(SHAPE).astype(np.float32) + 2000
    m = rng.random(SHAPE) > 0.5
    want = float(jax_stats.masked_mean(jnp.asarray(v), jnp.asarray(m), 0.25))
    got = float(stats.masked_mean(torch.from_numpy(v), torch.from_numpy(m),
                                  0.25))
    assert abs(got - want) <= 1e-6 * abs(want)
    none = stats.masked_mean(torch.from_numpy(v), torch.zeros(SHAPE,
                                                              dtype=bool), 1.0)
    assert float(none) == 0.0
    h, s, q, c = (rng.random(5), rng.random((5, 2)), rng.random((5, 2)),
                  rng.random(2))
    for a, b in zip(stats.reconstruct_moments(h, s, q, c),
                    jax_stats.reconstruct_moments(h, s, q, c)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def plotfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pltstats") / "plt00000")
    write_synthetic_plotfile(path, n_cell=16, n_levels=3, max_grid_size=8)
    return path


def jax_state(path, dt):
    return JaxDense.from_batched(AmrState.from_plotfile(path, dtype=dt))


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("bounds", [None, ((0.2, 0.3, 0.1), (0.8, 0.7, 0.6))])
@pytest.mark.parametrize("minmax", [False, True])
def test_accumulate_conditional_mean_parity(plotfile, dt, bounds, minmax):
    same_edges_both_modes(300.0, 1801.0, nbins=16)
    jds = jax_state(plotfile, dt)
    args = ("temp", ["density", "progress"], 16, 300.0, 1801.0, minmax)
    want = jax_cm.accumulate_conditional_mean(jds, *args, bounds=bounds)
    got = cm.accumulate_conditional_mean(port_state(jds), *args,
                                         bounds=bounds)
    np.testing.assert_array_equal(got[0], want[0])
    for k in (1, 2):
        close(got[k], want[k], dt)
    for k in (3, 4):
        np.testing.assert_array_equal(got[k], want[k])
    if bounds is not None:
        full = cm.accumulate_conditional_mean(port_state(jds), *args)
        assert 0 < got[0].sum() < full[0].sum()


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_accumulate_stats_fused_parity(plotfile, dt):
    same_edges_both_modes(300.0, 1801.0, nbins=64)
    same_edges_both_modes(300.0, 1801.0, -0.1, 1.1, nbins=32)
    jds = jax_state(plotfile, dt)
    args = ("temp", ["density"], 64, 300.0, 1801.0, ("temp", "progress"),
            (300.0, 1801.0, -0.1, 1.1), 32)
    (wh, ws, wq), (wb, w1, w2) = jax_cm.accumulate_stats_fused(jds, *args)
    (gh, gs, gq), (gb, g1, g2) = cm.accumulate_stats_fused(port_state(jds),
                                                           *args)
    np.testing.assert_array_equal(gh, wh)
    close(gs, ws, dt)
    close(gq, wq, dt)
    close(gb, wb, dt)      # b: f32 volumes summed in f32 by the JAX package
    close(g1, w1, dt)
    close(g2, w2, dt)
    # the domain's volume, every cell counted once
    np.testing.assert_allclose(gb.sum(), 1.0, rtol=1e-6)


def test_conditional_mean_empty_selection_is_zero_not_nan(tmp_path):
    """float32, a bounds box outside the domain: every column is zero."""
    path = str(tmp_path / "plt32")
    write_synthetic_plotfile(path, n_cell=16, n_levels=1)
    ds = DenseAmrState.from_plotfile(path, "cpu", dtype=torch.float32)
    hits, sums, sumsq, _, _ = cm.accumulate_conditional_mean(
        ds, "temp", ["density"], nbins=4, bin_min=300.0, bin_max=1800.0,
        bounds=((2.0, 2.0, 2.0), (3.0, 3.0, 3.0)))
    for a in (hits, sums, sumsq):
        assert np.isfinite(a).all() and not a.any()


def test_binned_stats_rejects_mismatched_inputs():
    v = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="mask"):
        stats.binned_stats(v, v[None], 1.0, torch.ones(4, 5, dtype=bool),
                           0.0, 1.0, 4)
    with pytest.raises(TypeError, match="float32 or float64"):
        stats.binned_stats(v.half(), v.half()[None], 1.0,
                           torch.ones(4, 4, dtype=bool), 0.0, 1.0, 4)


# -- CLIs ----------------------------------------------------------------------
def _numbers_and_text(path):
    nums, text = [], []
    with open(path) as f:
        for line in f:
            for tok in line.split():
                try:
                    nums.append(float(tok))
                except ValueError:
                    text.append(tok)
    return np.asarray(nums), text


def compare_text(ours, ref, dt):
    a, ta = _numbers_and_text(ours)
    b, tb = _numbers_and_text(ref)
    assert ta == tb, ours
    close(a, b, dt, ours)


@pytest.fixture
def cli_env(monkeypatch):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    # both CLIs set a process-wide compute dtype: restore it afterwards
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    """Two plotfiles of one series (the second ball shifted)."""
    base = tmp_path_factory.mktemp("series")
    paths = []
    for k, c in enumerate((0.5, 0.45)):
        fields = {
            "temp": lambda x, y, z, c=c: 300 + 1500 * np.exp(
                -((x - c) ** 2 + (y - .5) ** 2 + (z - .5) ** 2) / .15 ** 2),
            "density": lambda x, y, z: 1.0 / (1.0 + 3 * x * y + z),
            "Y_O2": lambda x, y, z: 0.2 * x + 0.01,
            "Y_H2": lambda x, y, z: 0.1 * (1 - y) + 0.01,
            "Y_H2O": lambda x, y, z: 0.05 + 0.1 * z}
        p = str(base / f"plt{k:05d}")
        write_synthetic_plotfile(p, n_cell=16, n_levels=3, max_grid_size=8,
                                 fields=fields)
        paths.append(p)
    return paths


CM_CASES = {
    "default": [],
    "minmax_bounds_series": ["writeBinMinMax=1", "bounds=0.2 0.3 0.1 0.8 0.7 "
                             "0.6", "avgComps=density Y_O2", "two_files"],
    "indices_float64": ["binComp=0", "avgComps=1", "dtype=float64"],
}


@pytest.mark.parametrize("case", sorted(CM_CASES))
def test_conditional_mean_cli_parity(series, tmp_path, cli_env, case):
    keys = [k for k in CM_CASES[case] if k != "two_files"]
    files = series if "two_files" in CM_CASES[case] else series[:1]
    common = [f"infile={' '.join(files)}", "nBins=24", "binMin=300",
              "binMax=1801"]
    if not any(k.startswith("binComp") for k in keys):
        common.append("binComp=temp")
    if not any(k.startswith("avgComps") for k in keys):
        common.append("avgComps=density")
    same_edges_both_modes(300.0, 1801.0, nbins=24)
    ours, ref = str(tmp_path / "ours.dat"), str(tmp_path / "ref.dat")
    argv = common + keys
    assert cli.main(["conditionalMean", *argv, f"outfile={ours}",
                     "device=cpu"]) == 0
    assert jax_cli.main(["conditionalMean", *argv, f"outfile={ref}"]) == 0
    compare_text(ours, ref,
                 np.float64 if "dtype=float64" in keys else np.float32)


def test_conditional_mean_cli_dim2_bounds(tmp_path, cli_env):
    """A DIM=2 plotfile with the 4-value bounds form."""
    same_edges_both_modes(300.0, 1801.0, nbins=16)
    path = str(tmp_path / "plt2d")
    write_synthetic_plotfile(path, n_cell=16, n_levels=2, max_grid_size=8,
                             ndim=2)
    ours, ref = str(tmp_path / "ours.dat"), str(tmp_path / "ref.dat")
    common = [f"infile={path}", "binComp=temp", "avgComps=density",
              "nBins=16", "binMin=300", "binMax=1801",
              "bounds=0.1 0.2 0.7 0.9"]
    assert cli.main(["conditionalMean", *common, f"outfile={ours}",
                     "device=cpu"]) == 0
    assert jax_cli.main(["conditionalMean", *common, f"outfile={ref}"]) == 0
    compare_text(ours, ref, np.float32)


def test_conditional_mean_bins_match_fresh_jax_process(tmp_path, monkeypatch):
    """Without dtype= a fresh JAX process runs with x64 off, and its bin
    edges round differently: the port's CLI bins cells on the edges as
    that process does (hits of every bin equal), and x64's rounding would
    move some of them."""
    lo, hi, nb = 0.1, 0.7, 37
    near = edge_values(np.random.default_rng(9), lo, hi, nb, 4096,
                       np.float32).astype(np.float64)

    def field(x, y, z):
        k = (np.floor(x * 64) * 4096 + np.floor(y * 64) * 64
             + np.floor(z * 64)).astype(np.int64)
        return near[(k * 2654435761) % len(near)]

    path = str(tmp_path / "pltedge")
    write_synthetic_plotfile(path, n_cell=16, n_levels=3, max_grid_size=8,
                             fields={"c": field, "density": lambda x, y, z:
                                     1.0 + x})
    common = [f"infile={path}", "binComp=c", "avgComps=density",
              f"nBins={nb}", f"binMin={lo}", f"binMax={hi}"]
    ref = str(tmp_path / "ref.dat")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               PELE_JAX_CACHE="0")
    res = subprocess.run([sys.executable, "-m", "peleanalysis_tpu",
                          "conditionalMean", *common, f"outfile={ref}"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_col = -2
    want = np.loadtxt(ref, skiprows=2)[:, n_col]
    monkeypatch.setattr(port_config, "compute_dtype", torch.float32)
    for x64, equal in ((False, True), (True, False)):
        if x64:
            monkeypatch.setattr(cm, "binned_stats",
                                partial(stats.binned_stats, x64=True))
        ours = str(tmp_path / f"ours{int(x64)}.dat")
        assert cli.main(["conditionalMean", *common, f"outfile={ours}",
                         "device=cpu"]) == 0
        got = np.loadtxt(ours, skiprows=2)[:, n_col]
        assert np.array_equal(got, want) == equal, x64


JPDF_CASES = {
    "all_writers": ["vars=temp density Y_O2", "output_gnuplot=1",
                    "output_matlab=1", "output_tecplot=1", "output_fab=1",
                    "output_scatter=1", "output_plotfile=1"],
    "cond1_norm_float64": ["vars=temp density", "do_conditioning=1",
                           "cVar=0", "norm_cVal=1", "cNormMin=300",
                           "cNormMax=1800", "cMin=0.2", "cMax=0.9",
                           "output_gnuplot=1", "dtype=float64"],
    "cond2_minmax": ["vars=temp density", "do_conditioning=2", "cVar=0",
                     "cNormMin=300", "cNormMax=1800", "cMin=0.1",
                     "cMax=0.25", "useminmax1=300 1801", "output_matlab=1"],
    "stoich_average": ["vars=Y_O2 Y_H2 Y_H2O", "do_stoichiometry=1",
                       "Hlist=0 2 2", "Olist=2 0 1", "do_average=1",
                       "output_gnuplot=1", "output_plotfile=0",
                       "outSuffix=_j", "two_files"],
    "single_variable": ["vars=temp", "output_gnuplot=1"],
}


def _tree(base):
    """The jpdf outputs under base (the input plotfiles left out)."""
    out = {}
    for root, _, files in os.walk(base):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), base)
            if "Pdf" in rel or "Scatter_" in rel:
                out[rel] = os.path.join(root, f)
    return out


def _compare_jpdf_outputs(ours, ref, dt):
    a, b = _tree(ours), _tree(ref)
    assert sorted(a) == sorted(b)
    plotfiles = set()
    for rel in a:
        if "_plt" + os.sep in rel:
            plotfiles.add(rel.split("_plt" + os.sep)[0] + "_plt")
        elif rel.endswith(".fab"):
            with open(a[rel], "rb") as fa, open(b[rel], "rb") as fb:
                (ba, da), (bb, db) = read_fab(fa), read_fab(fb)
            assert ba == bb
            close(da, db, dt, rel)
        else:
            compare_text(a[rel], b[rel], dt)
    for rel in plotfiles:
        ra = PlotfileReader(os.path.join(ours, rel))
        rb = PlotfileReader(os.path.join(ref, rel))
        assert ra.var_names == rb.var_names == ["logpdf", "pdf"]
        for fa, fb in zip(ra.read_level(0), rb.read_level(0)):
            close(fa, fb, dt, rel)


@pytest.mark.parametrize("case", sorted(JPDF_CASES))
def test_jpdf_cli_parity(series, tmp_path, cli_env, case):
    import shutil
    keys = [k for k in JPDF_CASES[case] if k != "two_files"]
    files = series if "two_files" in JPDF_CASES[case] else series[:1]
    dirs = {}
    for who in ("ours", "ref"):
        d = tmp_path / who
        d.mkdir()
        names = []
        for p in files:
            dst = str(d / os.path.basename(p))
            shutil.copytree(p, dst)
            names.append(dst)
        dirs[who] = (str(d), names)
    common = ["nBins=12", *keys]
    assert cli.main(["jpdf", f"infile={' '.join(dirs['ours'][1])}", *common,
                     "device=cpu"]) == 0
    assert jax_cli.main(["jpdf", f"infile={' '.join(dirs['ref'][1])}",
                         *common]) == 0
    dt = np.float64 if "dtype=float64" in keys else np.float32
    _compare_jpdf_outputs(dirs["ours"][0], dirs["ref"][0], dt)
    written = [r for r in _tree(dirs["ours"][0]) if "Pdf_" in r
               or "Scatter_" in r]
    if case == "single_variable":
        assert not written
    else:
        assert written
    if case == "all_writers":
        # the written pdf sums to 1: every valid cell counted once
        g = np.loadtxt(os.path.join(dirs["ours"][1][0],
                                    "Pdf_temp_density.gpd"))
        np.testing.assert_allclose(g[:, 2].sum(), 1.0, rtol=1e-5)
