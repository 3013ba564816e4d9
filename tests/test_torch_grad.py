"""Parity of the port's ``grad`` tool with the JAX package's: the dense
compute on identical states, and both CLIs on one plotfile, FAB by FAB."""
import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools.grad import compute_grad_dense as jax_grad
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.box import Box, BoxArray
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.amr.geometry import Geometry
from peleanalysis_tpu_torch.amr.hierarchy import AmrMeta
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.tools.grad import compute_grad_dense

# f64: 1e-12 (same formulas in the same order; sqrt may differ by 1 ulp);
# f32: 1e-5 relative plus 1e-5 of the largest value, for cells near zero
TOL = {np.float64: dict(rtol=1e-12, atol_frac=0.0),
       np.float32: dict(rtol=1e-5, atol_frac=1e-5)}


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


def assert_close(got, want, np_dtype):
    tol = TOL[np_dtype]
    atol = tol["atol_frac"] * float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol)


@pytest.fixture(scope="module")
def small_plotfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pltgrad") / "plt00000")
    write_synthetic_plotfile(path, n_cell=16, n_levels=3, max_grid_size=8)
    return path


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("interp, sym_dir", [("linear", None),
                                             ("quadratic", [1, 0, 1])])
def test_compute_grad_dense_parity(small_plotfile, interp, sym_dir, dt):
    jds = JaxDense.from_batched(AmrState.from_plotfile(small_plotfile,
                                                       dtype=dt))
    want = jax_grad(jds, "temp", aux=("density",), sym_dir=sym_dir,
                    interp=interp)
    got = compute_grad_dense(port_state(jds), "temp", aux=("density",),
                             sym_dir=sym_dir, interp=interp)
    assert got.names == want.names
    for lev in range(jds.meta.n_levels):
        g, w = got.data[lev].numpy(), np.asarray(want.data[lev])
        assert g.shape == w.shape and g.dtype == w.dtype
        assert_close(g, w, dt)


def _compare_plotfiles(a, b, np_dtype):
    ra, rb = PlotfileReader(a), PlotfileReader(b)
    assert ra.var_names == rb.var_names
    assert ra.meta.n_levels == rb.meta.n_levels
    for lev in range(ra.meta.n_levels):
        assert ([(x.lo, x.hi) for x in ra.box_array(lev)]
                == [(x.lo, x.hi) for x in rb.box_array(lev)])
        for fa, fb in zip(ra.read_level(lev), rb.read_level(lev)):
            assert_close(fa, fb, np_dtype)


@pytest.mark.parametrize("dtype_key", [[], ["dtype=float64"]])
def test_grad_cli_parity(small_plotfile, tmp_path, monkeypatch, dtype_key):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    # both CLIs set a process-wide compute dtype: restore it afterwards
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    ours, ref = str(tmp_path / "port_gt"), str(tmp_path / "jax_gt")
    common = [f"infile={small_plotfile}", "Aux_Variables=density"]
    assert cli.main(["grad", *common, f"outfile={ours}", "device=cpu",
                     *dtype_key]) == 0
    assert jax_cli.main(["grad", *common, f"outfile={ref}", *dtype_key]) == 0
    names = PlotfileReader(ours).var_names
    assert names == ["temp", "density", "temp_gx", "temp_gy", "temp_gz",
                     "||gradtemp||"]
    _compare_plotfiles(ours, ref, np.float64 if dtype_key else np.float32)


def _same_tree(a, b):
    import filecmp
    import os
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert files and files == sorted(
        os.path.relpath(os.path.join(r, f), b)
        for r, _, fs in os.walk(b) for f in fs)
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


@pytest.mark.parametrize("key", ["ndevices=2", "shape_bucket=8"])
def test_unported_options_raise(small_plotfile, tmp_path, key):
    """shape_bucket= raises; ndevices=2 (ported) writes the ndevices=1
    run's plotfile byte for byte."""
    argv = ["grad", f"infile={small_plotfile}", "device=cpu"]
    if key == "ndevices=2":
        assert cli.main([*argv, key, f"outfile={tmp_path / 'out'}"]) == 0
        assert cli.main([*argv, f"outfile={tmp_path / 'ref'}"]) == 0
        _same_tree(str(tmp_path / "out"), str(tmp_path / "ref"))
        return
    with pytest.raises(NotImplementedError, match="not ported yet|no PyTorch"):
        cli.main([*argv, key, f"outfile={tmp_path / 'out'}"])
    assert not (tmp_path / "out").exists()


def test_sparse_refinement_raises(tmp_path, capsys):
    """Sparse refinement no longer raises: the clustered path runs and its
    plotfile equals the force_dense=1 run's (float32, every cell through
    the same ops on the same inputs)."""
    from peleanalysis_tpu_torch.io.plotfile import write_plotfile
    from peleanalysis_tpu_torch.testing import default_fields, make_level_data
    dom0 = Box((0, 0, 0), (47, 47, 47))
    geoms = [Geometry(dom0, (0.0,) * 3, (1.0,) * 3, (False,) * 3)]
    geoms.append(geoms[0].refine(4))
    # two small patches far apart: a huge, mostly empty union bbox
    fine = BoxArray([Box((8, 8, 8), (23, 23, 23)),
                     Box((168, 168, 168), (183, 183, 183))])
    bas = [BoxArray([dom0]), fine]
    names, data = make_level_data(geoms, bas, {"temp": default_fields()[
        "temp"]})
    plt = str(tmp_path / "plt")
    write_plotfile(plt, names, 0.0, geoms, [4], bas, data)
    outs = {}
    for mode, extra in (("clustered", []), ("dense", ["force_dense=1"])):
        outs[mode] = str(tmp_path / mode)
        assert cli.main(["grad", f"infile={plt}", f"outfile={outs[mode]}",
                         "device=cpu", *extra]) == 0
        assert ("clustered path" in capsys.readouterr().out) == (
            mode == "clustered")
    ra, rb = PlotfileReader(outs["clustered"]), PlotfileReader(outs["dense"])
    for lev in range(2):
        for fa, fb in zip(ra.read_level(lev), rb.read_level(lev)):
            np.testing.assert_array_equal(fa, fb)


def test_unknown_and_unported_tools_exit_2(capsys):
    # every verb of the JAX CLI is ported: a pipeline with an empty stage
    # and an unknown tool exit 2, and --help lists the three driver verbs
    assert cli.main(["pipeline", "--", "grad", "infile=x"]) == 2
    assert "empty stage" in capsys.readouterr().out
    assert cli.main(["noSuchTool"]) == 2
    assert "pipeline serve send" in capsys.readouterr().out
    assert cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "grad" in out and "pipeline serve send" in out


def test_cuda_device_without_card_raises(small_plotfile, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=cuda is valid here")
    with pytest.raises(RuntimeError, match="not available"):
        cli.main(["grad", f"infile={small_plotfile}",
                  f"outfile={tmp_path / 'out'}"])
