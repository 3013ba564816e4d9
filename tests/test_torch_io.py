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
