"""Parity of the port's dense multilevel ghost fill with the JAX package's
``ops/dense_fill.py`` on identical inputs (every interp, every physical BC,
a periodic hierarchy, 1 and 2 ghosts, float32 and float64)."""
import numpy as np
import pytest
import torch

from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.ops import dense_fill as jfill
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.ops import dense_fill as tfill
from peleanalysis_tpu_torch.ops.fill import FOEXTRAP, REFLECT_EVEN, REFLECT_ODD

# f64: 1e-13 (same formulas, same order); f32: 1e-6 (weighted sums of
# 3 terms may round differently if a backend reorders them)
RTOL = {np.float64: 1e-13, np.float32: 1e-6}


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


@pytest.fixture(scope="module")
def small_plotfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pltfill") / "plt00000")
    write_synthetic_plotfile(path, n_cell=16, n_levels=3, max_grid_size=8)
    return path


@pytest.fixture(scope="module")
def small_periodic_plotfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pltfillper") / "plt00000")
    write_synthetic_plotfile(path, n_cell=16, n_levels=3, max_grid_size=8,
                             is_periodic=(True, True, True))
    return path


def _states(path, np_dtype, is_periodic=None):
    jds = JaxDense.from_batched(AmrState.from_plotfile(
        path, dtype=np_dtype, is_periodic=is_periodic))
    return jds, port_state(jds)


def _check_fill(jds, tds, ngrow, bc, interp, np_dtype):
    L = jds.meta.n_levels
    jm = [jds.in_level_mask(l) for l in range(L)]
    tm = [tds.in_level_mask(l) for l in range(L)]
    want = jfill.fill_dense_multilevel(jds.meta, jds.lmeta, list(jds.data),
                                       jm, ngrow, bc, interp)
    got = tfill.fill_dense_multilevel(tds.meta, tds.lmeta, list(tds.data),
                                      tm, ngrow, bc, interp)
    for lev in range(L):
        w = np.asarray(want[lev])
        g = got[lev].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=RTOL[np_dtype], atol=0)
    # single-level recursive form, finest level
    w = np.asarray(jfill.fill_dense_arrays(jds.meta, jds.lmeta,
                                           list(jds.data), jm, L - 1, ngrow,
                                           bc, interp))
    g = tfill.fill_dense_arrays(tds.meta, tds.lmeta, list(tds.data), tm,
                                L - 1, ngrow, bc, interp).numpy()
    np.testing.assert_allclose(g, w, rtol=RTOL[np_dtype], atol=0)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("ngrow", [1, 2])
@pytest.mark.parametrize("mode", [FOEXTRAP, REFLECT_EVEN, REFLECT_ODD])
@pytest.mark.parametrize("interp", ["pc", "linear", "quadratic"])
def test_fill_dense_multilevel_parity(small_plotfile, interp, mode, ngrow,
                                      dt):
    jds, tds = _states(small_plotfile, dt)
    _check_fill(jds, tds, ngrow, ((mode, mode),) * 3, interp, dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("ngrow", [1, 2])
@pytest.mark.parametrize("interp", ["pc", "linear", "quadratic"])
def test_fill_dense_multilevel_periodic_parity(small_periodic_plotfile,
                                               interp, ngrow, dt):
    jds, tds = _states(small_periodic_plotfile, dt,
                       is_periodic=(True, True, True))
    assert all(tds.meta.geoms[0].is_periodic)
    _check_fill(jds, tds, ngrow, ((FOEXTRAP, FOEXTRAP),) * 3, interp, dt)


def test_fill_mixed_bc_per_side(small_plotfile):
    # a different mode on each side of each dimension
    jds, tds = _states(small_plotfile, np.float64)
    bc = ((FOEXTRAP, REFLECT_ODD), (REFLECT_EVEN, FOEXTRAP),
          (REFLECT_ODD, REFLECT_EVEN))
    _check_fill(jds, tds, 2, bc, "quadratic", np.float64)


def test_masks_match_jax(small_plotfile):
    jds, tds = _states(small_plotfile, np.float64)
    for lev in range(jds.meta.n_levels):
        np.testing.assert_array_equal(tds.in_level_mask(lev).numpy(),
                                      np.asarray(jds.in_level_mask(lev)))
        np.testing.assert_array_equal(tds.covered_mask(lev).numpy(),
                                      np.asarray(jds.covered_mask(lev)))
        np.testing.assert_array_equal(tds.valid_mask(lev).numpy(),
                                      np.asarray(jds.valid_mask(lev)))
        assert tds.valid_mask(lev).dtype == torch.bool
