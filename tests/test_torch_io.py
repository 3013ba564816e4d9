"""Plotfile I/O of the port against the JAX package: each reads what the
other writes, with identical boxes and values, and both build the same
dense level arrays from one plotfile."""
import os

import numpy as np
import pytest
import torch

from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.io.plotfile import PlotfileReader as JaxReader
from peleanalysis_tpu.testing import write_synthetic_plotfile as jax_synth
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.amr.hierarchy import load_plotfile_fabs
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.io.plotfile import write_plotfile
from peleanalysis_tpu_torch.testing import write_synthetic_plotfile


def _boxes(ba):
    """Box lists compared as index tuples (the two packages' Box classes
    are distinct types)."""
    return [(b.lo, b.hi) for b in ba]


def _geom(g):
    return (g.domain.lo, g.domain.hi, g.prob_lo, g.prob_hi, g.is_periodic,
            g.coord_sys)


def _same_plotfile(reader_a, reader_b):
    ma, mb = reader_a.meta, reader_b.meta
    assert ma.var_names == mb.var_names
    assert (ma.ndim, ma.time, ma.finest_level) == (mb.ndim, mb.time,
                                                   mb.finest_level)
    assert ma.prob_lo == mb.prob_lo and ma.prob_hi == mb.prob_hi
    assert ma.ref_ratio == mb.ref_ratio and ma.dx == mb.dx
    for lev in range(ma.n_levels):
        assert _boxes([ma.prob_domain[lev]]) == _boxes([mb.prob_domain[lev]])
        assert _boxes(reader_a.box_array(lev)) == _boxes(reader_b.box_array(lev))
        for fa, fb in zip(reader_a.read_level(lev), reader_b.read_level(lev)):
            np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("ndim", [3, 2])
def test_port_writer_read_by_jax(tmp_path, ndim):
    path = str(tmp_path / "plt_port")
    write_synthetic_plotfile(path, n_cell=16, n_levels=3, max_grid_size=8,
                             ndim=ndim)
    _same_plotfile(PlotfileReader(path), JaxReader(path))
    ref = str(tmp_path / "plt_jax")
    jax_synth(ref, n_cell=16, n_levels=3, max_grid_size=8, ndim=ndim)
    _same_plotfile(PlotfileReader(path), JaxReader(ref))


def test_jax_writer_read_by_port(tmp_path):
    path = str(tmp_path / "plt_jax")
    geoms, bas, ratios, names, data = jax_synth(path, n_cell=16, n_levels=3,
                                                max_grid_size=8)
    r = PlotfileReader(path)
    assert r.var_names == names
    for lev in range(len(bas)):
        assert _boxes(r.box_array(lev)) == _boxes(bas[lev])
        for got, want in zip(r.read_level(lev), data[lev]):
            np.testing.assert_array_equal(got, want)
    # a component subset, in a chosen order
    sel = [names.index("density"), names.index("temp")]
    for got, want in zip(r.read_level(2, sel), JaxReader(path).read_level(2, sel)):
        np.testing.assert_array_equal(got, want)


def test_float32_fabs_round_trip(tmp_path):
    path = str(tmp_path / "plt32")
    geoms, bas, ratios, names, data = jax_synth(str(tmp_path / "src"),
                                                n_cell=16, n_levels=2,
                                                max_grid_size=8)
    write_plotfile(path, names, 0.5, geoms, ratios, bas, data,
                   dtype=np.float32)
    for lev in range(len(bas)):
        for got, want in zip(JaxReader(path).read_level(lev), data[lev]):
            np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("dt", [(np.float64, torch.float64),
                                (np.float32, torch.float32)])
def test_dense_state_from_plotfile_matches_jax(tmp_path, dt):
    np_dtype, t_dtype = dt
    path = str(tmp_path / "plt")
    jax_synth(path, n_cell=16, n_levels=3, max_grid_size=8)
    jds = JaxDense.from_batched(AmrState.from_plotfile(path, dtype=np_dtype))
    tds = DenseAmrState.from_plotfile(path, "cpu", dtype=t_dtype)
    assert tds.names == jds.names
    for lev in range(jds.meta.n_levels):
        assert _boxes([tds.lmeta[lev].bbox]) == _boxes([jds.lmeta[lev].bbox])
        assert _geom(tds.meta.geoms[lev]) == _geom(jds.meta.geoms[lev])
        assert tds.data[lev].dtype == t_dtype
        np.testing.assert_array_equal(tds.data[lev].numpy(),
                                      np.asarray(jds.data[lev]))


def test_dense_to_plotfile_bytes_match_jax(tmp_path):
    """The port's dense writer and the JAX package's write the same files."""
    src = str(tmp_path / "plt")
    jax_synth(src, n_cell=16, n_levels=3, max_grid_size=8)
    a, b = str(tmp_path / "out_port"), str(tmp_path / "out_jax")
    DenseAmrState.from_plotfile(src, "cpu", dtype=torch.float64).to_plotfile(a)
    JaxDense.from_batched(AmrState.from_plotfile(
        src, dtype=np.float64)).to_plotfile(b)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for f in files:
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_2d_plotfile_promoted_and_demoted(tmp_path):
    src = str(tmp_path / "plt2d")
    jax_synth(src, n_cell=16, n_levels=2, max_grid_size=8, ndim=2)
    meta, names, fabs = load_plotfile_fabs(src)
    assert meta.ndim2 and meta.ndim == 3
    assert all(f.shape[-1] == 1 for f in fabs[0])
    out = str(tmp_path / "plt2d_out")
    DenseAmrState.from_level_fabs(meta, names, fabs, "cpu",
                                  torch.float64).to_plotfile(out)
    _same_plotfile(PlotfileReader(out), JaxReader(src))


# -- the device writer's code path, run on CPU tensors ---------------------------
def _tree(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _inject_hazards(ds):
    """Box windows whose min or max is a zero of one or both signs, NaNs
    of both signs, a box of -0.0 only, in the state's own dtype."""
    from peleanalysis_tpu_torch.amr.dense import _box_slices
    rng = np.random.default_rng(11)
    nan = torch.tensor(float("nan"), dtype=ds.dtype)
    windows = [(lev, (slice(None),) + _box_slices(b, ds.lmeta[lev].bbox))
               for lev in range(ds.meta.n_levels) for b in ds.meta.bas[lev]]
    assert len(windows) >= 7

    def signed_zeros(shape, p_neg):
        neg = torch.from_numpy(rng.random(shape) < p_neg)
        return torch.where(neg, -0.0, 0.0).to(ds.dtype)

    def fill(k, comp, values):
        lev, w = windows[k]
        ds.data[lev][w][comp] = values(ds.data[lev][w][comp].shape)
    mag = lambda s: torch.from_numpy(rng.uniform(0.5, 2.0, s)).to(ds.dtype)
    # zeros of both signs only: min and max both settled by numpy
    fill(0, 0, lambda s: signed_zeros(s, 0.5))
    # values >= 0 with zeros of both signs: the min settled by numpy
    fill(1, 1, lambda s: torch.where(signed_zeros(s, 0.0) == 0, mag(s), 0)
         * (torch.from_numpy(rng.random(s)) < 0.5) + signed_zeros(s, 0.5))
    # values <= 0 with +0.0 only, then with -0.0 only, then both
    fill(2, 2, lambda s: -mag(s) * (torch.from_numpy(rng.random(s)) < 0.5))
    fill(3, 0, lambda s: torch.minimum(-mag(s) * (torch.from_numpy(
        rng.random(s)) < 0.5), signed_zeros(s, 1.0)))
    fill(4, 1, lambda s: -mag(s) * (torch.from_numpy(rng.random(s)) < 0.5)
         + signed_zeros(s, 0.5))
    # -0.0 everywhere
    fill(5, 2, lambda s: signed_zeros(s, 1.0))
    # NaN of both signs among finite values
    def with_nans(s):
        v = mag(s)
        v.view(-1)[:3] = torch.stack([nan, -nan, nan])
        return v
    fill(6, 0, with_nans)


@pytest.mark.parametrize("ndim, state_dtype, out_dtype", [
    (3, torch.float64, np.float64), (3, torch.float32, np.float64),
    (3, torch.float64, np.float32), (3, torch.float32, np.float32),
    (2, torch.float32, np.float64)],
    ids=["f64-f64", "f32-f64", "f64-f32", "f32-f32", "2d-f32-f64"])
def test_device_writer_matches_jax(tmp_path, monkeypatch, ndim, state_dtype,
                                   out_dtype):
    """to_plotfile packs, casts and reduces each level in torch (here on
    CPU tensors, on the card in the tools) and writes the bytes the JAX
    package's write_plotfile writes from the same boxes, given as the
    C-contiguous arrays of its packed dense writer: ±0 ties, NaN cells
    and float32 output included."""
    from peleanalysis_tpu.io.plotfile import write_plotfile as jax_write
    from peleanalysis_tpu_torch.amr.hierarchy import (output_layout,
                                                      write_level_fabs)
    from peleanalysis_tpu_torch.io import fab_pack
    src = str(tmp_path / "plt")
    write_synthetic_plotfile(src, n_cell=16, n_levels=2, max_grid_size=8,
                             ndim=ndim)
    ds = DenseAmrState.from_plotfile(src, "cpu", dtype=state_dtype)
    _inject_hazards(ds)
    settled = []
    real = fab_pack._c_order
    monkeypatch.setattr(fab_pack, "_c_order",
                        lambda *a: settled.append(a[2]) or real(*a))
    ds.to_plotfile(str(tmp_path / "dev"), dtype=out_dtype)
    assert settled          # the mixed-sign ties went through numpy
    fabs = ds.level_fabs()
    write_level_fabs(ds.meta, ds.names, fabs, str(tmp_path / "host"),
                     dtype=out_dtype)
    geoms, bas = output_layout(ds.meta)
    if ndim == 2:
        fabs = [[f[..., 0] for f in lev] for lev in fabs]
    jax_write(str(tmp_path / "jax"), ds.names, ds.meta.time, geoms,
              ds.meta.ref_ratio, bas, fabs, level_steps=ds.meta.level_steps,
              dtype=out_dtype)
    dev, host, jax = (_tree(tmp_path / n) for n in ("dev", "host", "jax"))
    assert sorted(dev) == sorted(jax) and len(dev) > 4
    for name in dev:
        assert dev[name] == host[name] == jax[name], name
    tables = "".join(v.decode() for k, v in dev.items()
                     if k.endswith("Cell_H"))
    assert "-0," in tables and "nan" in tables
