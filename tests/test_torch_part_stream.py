"""Parity of the port's ``partStream`` with the JAX package's, on identical
plotfiles: the dense lines within 1e-12 of JAX's ``trace_streamlines``
(float64, the tool's dtype), the CLI's Tecplot text byte for byte, the
particle plotfile read back equal and the StreamData within 1e-12; the
sparse path's decision and lines against JAX's sparse ``partStream`` and
the port's ``force_dense=1``; and the lines equal to the port's ``stream
traceAlongV=1`` on the same seeds."""
import os

import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.io.particles import read_particles as jax_read_particles
from peleanalysis_tpu.stream.trace import \
    trace_streamlines as jax_trace_streamlines
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools.part_stream import \
    seeds_one_per_cell as jax_seeds_one_per_cell
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.io.mef import MEF, write_mef
from peleanalysis_tpu_torch.io.particles import read_particles
from peleanalysis_tpu_torch.io.stream_data import read_stream_data
from peleanalysis_tpu_torch.testing import write_scattered_plotfile
from peleanalysis_tpu_torch.tools.part_stream import seeds_one_per_cell

TOL = 1e-12
VEL = ["x_velocity", "y_velocity", "z_velocity"]


def _velocities():
    return {"x_velocity": lambda x, y, z: -(y - .5) + .1 * np.sin(6 * x),
            "y_velocity": lambda x, y, z: (x - .5) + .1 * np.cos(6 * y),
            "z_velocity": lambda x, y, z: .25 + .1 * x * y,
            "temp": lambda x, y, z: 300 + 1500 * x * y}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("partstream")
    plt = str(d / "plt")
    write_synthetic_plotfile(plt, n_cell=16, n_levels=3, max_grid_size=8)
    rng = np.random.default_rng(3)
    seeds = 0.3 + 0.4 * rng.random((40, 3))
    tris = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    write_mef(str(d / "seeds.mef"), MEF("0", ["X", "Y", "Z"], seeds, tris))
    scat = str(d / "plt_scat")
    meta = write_scattered_plotfile(scat, n0=48, ratio=4, n_clusters=4,
                                    fine_box=16, fields=_velocities())[0]
    # three seeds inside each finest box, eight anywhere
    dx = np.array(meta.geoms[-1].dx)
    pts = [rng.random((8, 3))]
    for b in meta.bas[-1]:
        lo, hi = np.array(b.lo) * dx + dx, (np.array(b.hi) + 1) * dx - dx
        pts.append(lo + (hi - lo) * rng.random((3, 3)))
    write_mef(str(d / "scat.mef"), MEF("0", ["X", "Y", "Z"],
                                       np.concatenate(pts),
                                       np.zeros((0, 3), np.int32)))
    return d, plt, scat, seeds


@pytest.fixture
def run_both(monkeypatch, case):
    d = case[0]
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    # both CLIs set a process-wide compute dtype: restore it afterwards
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    monkeypatch.chdir(d)

    def run(args, outs, port_extra=()):
        """partStream through both CLIs; ``outs`` maps each output key to a
        file name, written with a ``port_`` or ``jax_`` prefix."""
        for who, main, extra in (("port", cli.main,
                                  ["device=cpu", *port_extra]),
                                 ("jax", jax_cli.main, [])):
            keys = [f"{k}={d / (who + '_' + v)}" for k, v in outs.items()]
            assert main(["partStream", *args, *keys, *extra]) == 0
        return {k: (str(d / ("port_" + v)), str(d / ("jax_" + v)))
                for k, v in outs.items()}
    return run


def _same_stream_data(a, b):
    sa, sb = read_stream_data(a), read_stream_data(b)
    assert sa.names == sb.names == ["X", "Y", "Z"]
    np.testing.assert_array_equal(sa.elements, sb.elements)
    for la, lb in zip(sa.inside_nodes, sb.inside_nodes):
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(sa.lines, sb.lines, rtol=0, atol=TOL)
    return sa.lines


def _same_particles(a, b):
    pa, ra, ia = read_particles(a)
    pb, rb, ib = jax_read_particles(b)
    assert list(ra) == list(rb) and ia == {} and ib == {}
    np.testing.assert_allclose(pa, pb, rtol=0, atol=TOL)
    for k in ra:
        np.testing.assert_allclose(ra[k], rb[k], rtol=0, atol=TOL)
    with open(os.path.join(a, "particles", "Header")) as fa, \
            open(os.path.join(b, "particles", "Header")) as fb:
        assert fa.read() == fb.read()
    return pa, ra


def test_trace_matches_jax_dense_lines(case):
    """The tool's dense march (trace_field=None, no samples) on one
    float64 state within 1e-12 of JAX's."""
    _, plt, _, seeds = case
    jds = JaxDense.from_batched(AmrState.from_plotfile(plt, names=VEL,
                                                       dtype=np.float64))
    want = jax_trace_streamlines(jds, seeds, 21, 0.5, trace_field=None,
                                 sample_names=())
    from peleanalysis_tpu_torch.stream.trace import trace_streamlines
    ds = DenseAmrState.from_plotfile(plt, "cpu", names=VEL,
                                     dtype=torch.float64)
    got = trace_streamlines(ds, seeds, 21, 0.5, trace_field=None,
                            sample_names=())
    assert got.shape == want.shape == (len(seeds), 21, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def test_cli_mef_seeds_all_outputs(run_both):
    out = run_both(["infile=plt", "isoFile=seeds.mef", "Nsteps=21",
                    "hRK=0.5"], {"outFile": "lines.dat",
                                 "partFile": "parts", "streamFile": "sd"})
    a, b = out["outFile"]
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    lines = _same_stream_data(*out["streamFile"])
    assert lines.shape == (40, 21, 3)
    pos, reals = _same_particles(*out["partFile"])
    # the particle sits at the last station; every station rides along
    np.testing.assert_array_equal(pos, lines[:, -1])
    assert len(reals) == 21 * 3
    np.testing.assert_array_equal(reals["path_007_y"], lines[:, 7, 1])


@pytest.mark.parametrize("source", [
    ["oneSeedPerCell=1", "seedStride=5"],
    ["seedLoc=0.45 0.5 0.55"],
    ["seedRakeL=0.2 0.3 0.4", "seedRakeR=0.8 0.7 0.6", "seedRakeNum=7"]])
def test_cli_seed_sources(run_both, source):
    out = run_both(["infile=plt", "hRK=0.25", *source],
                   {"outFile": "src.dat", "streamFile": "src_sd"})
    a, b = out["outFile"]
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    lines = _same_stream_data(*out["streamFile"])
    assert lines.shape[1] == 51                       # Nsteps=51 default


def test_seeds_one_per_cell_stride(case):
    _, plt, _, _ = case
    jds = JaxDense.from_batched(AmrState.from_plotfile(plt, names=VEL,
                                                       dtype=np.float64))
    ds = DenseAmrState.from_plotfile(plt, "cpu", names=VEL,
                                     dtype=torch.float64)
    for stride in (1, 3, 64):
        got = seeds_one_per_cell(ds, stride)
        np.testing.assert_array_equal(got, jax_seeds_one_per_cell(jds,
                                                                  stride))
    assert len(seeds_one_per_cell(ds, 1)) == ds.in_level_mask_np(2).sum()


def test_sparse_path_matches_jax_and_dense(run_both, case, capsys):
    d = case[0]
    out = run_both(["infile=plt_scat", "isoFile=scat.mef", "Nsteps=11",
                    "hRK=0.5"], {"outFile": "sp.dat", "streamFile": "sp_sd",
                                 "partFile": "sp_parts"})
    said = capsys.readouterr().out
    assert said.count("partStream: sparse refinement detected -> "
                      "clustered path") == 2
    lines = _same_stream_data(*out["streamFile"])
    _same_particles(*out["partFile"])
    dense = str(d / "dense_sd")
    assert cli.main(["partStream", "infile=plt_scat", "isoFile=scat.mef",
                     "Nsteps=11", "hRK=0.5", "force_dense=1", "device=cpu",
                     f"streamFile={dense}", "outFile=dense.dat"]) == 0
    assert "clustered path" not in capsys.readouterr().out
    np.testing.assert_allclose(read_stream_data(dense).lines, lines, rtol=0,
                               atol=TOL)


def test_lines_equal_stream_trace_along_v(case, monkeypatch):
    """partStream's XYZ equal the port's ``stream traceAlongV=1`` on the
    same seeds: both load non-periodic geometry by default."""
    d, plt, _, _ = case
    monkeypatch.chdir(d)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    common = ["isoFile=seeds.mef", "hRK=0.5", "device=cpu"]
    assert cli.main(["partStream", f"infile={plt}", "Nsteps=21",
                     "streamFile=ps_sd", *common]) == 0
    assert cli.main(["stream", f"plotfile={plt}", "traceAlongV=1",
                     "nRKsteps=21", "streamFile=st_sd", *common]) == 0
    a, b = read_stream_data("ps_sd"), read_stream_data("st_sd")
    np.testing.assert_array_equal(a.lines, b.lines[..., :3])


def test_refusals(case, monkeypatch):
    d, plt, _, _ = case
    monkeypatch.chdir(d)
    # ndevices=2 (ported: the migrating march) writes the ndevices=1 lines
    for nd in ("1", "2"):
        assert cli.main(["partStream", f"infile={plt}", "seedLoc=0.5 0.5 0.5",
                         f"ndevices={nd}", f"outFile=nd{nd}.dat",
                         "device=cpu"]) == 0
    assert open("nd2.dat", "rb").read() == open("nd1.dat", "rb").read()
    with pytest.raises(ValueError, match="must specify"):
        cli.main(["partStream", f"infile={plt}", "device=cpu"])
