"""A sharded stage's output kept on its shards' devices
(``parallel/dense_shard.ShardGather``) and handed to the next stage on
the CPU: every window cut from it equals the window assembled on the host
from its FABs, byte for byte, masks included, for the grad, curvature and
isosurface halos, X slabs and blocks, periodic or not, DIM=2 too; its
gather, its host FABs and its plotfile are those of the stage run on one
device, and a part missing is never written as zeros; and in a pipeline
a sharded curvature feeds a sharded isosurface without a host copy of
the output (``DenseAmrState.level_fabs`` never called), feeds an
``ndevices=1`` consumer and ``conditionalMean`` through the gather, and
writes the plotfile of ``write=1``, each giving the bytes of the
unsharded run's."""
import os

import numpy as np
import pytest
import torch

from peleanalysis_tpu_torch import cli, telemetry
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.box import Box, BoxArray
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.amr.geometry import Geometry
from peleanalysis_tpu_torch.amr.hierarchy import load_plotfile_fabs
from peleanalysis_tpu_torch.io.plotfile import write_plotfile
from peleanalysis_tpu_torch.parallel.dense_shard import (
    CURVATURE_STAGES, GRAD_STAGES, ISO_HALO, HostFabs, ShardedDenseState,
    ShardGather, make_spatial_mesh, run_windows, stencil_halo)
from peleanalysis_tpu_torch.session import Session
from peleanalysis_tpu_torch.testing import (make_level_data,
                                            write_synthetic_plotfile)

D = "device=cpu"
CPU = torch.device("cpu")
F64 = torch.float64


def flame(x, y, z):
    """A wrinkled front across z, 300 K below and 2200 K above it."""
    zf = 0.5 + 0.06 * np.sin(2 * np.pi * x + 0.3) * np.cos(2 * np.pi * y)
    return 1250.0 + 950.0 * np.tanh((z - zf) / 0.08)


FIELDS = {"temp": flame,
          "density": lambda x, y, z: 1.12 * 300.0 / flame(x, y, z),
          "x_velocity": lambda x, y, z: 1.0 + 0.3 * np.sin(2 * np.pi * y)}
FIELDS_2D = {"temp": lambda x, y: 1000 + 500 * np.sin(2 * np.pi * x + 0.3)
             * np.cos(2 * np.pi * y - 0.2),
             "density": lambda x, y: x + 2 * y}


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    # the CLI sets a process-wide compute dtype
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def plotfiles(tmp_path_factory):
    d = tmp_path_factory.mktemp("plthandoff")
    out = {"plain": str(d / "plt"), "periodic": str(d / "pltper"),
           "dim2": str(d / "plt2d")}
    write_synthetic_plotfile(out["plain"], n_cell=16, n_levels=3,
                             max_grid_size=8, fields=FIELDS)
    # level 1 spans the domain: the periodic seams fold on both levels
    write_synthetic_plotfile(out["periodic"], n_cell=16, n_levels=2,
                             max_grid_size=8, fields=FIELDS,
                             is_periodic=(True,) * 3, refine_frac=1.0)
    write_synthetic_plotfile(out["dim2"], n_cell=16, n_levels=3,
                             max_grid_size=8, fields=FIELDS_2D, ndim=2)
    # two fine boxes far apart: their bbox is mostly holes
    dom0 = Box((0, 0, 0), (15, 15, 15))
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2)]
    bas = [BoxArray([dom0]), BoxArray([Box((2, 4, 2), (9, 11, 9)),
                                       Box((20, 18, 16), (29, 27, 25))])]
    names, data = make_level_data(geoms, bas, FIELDS)
    out["holes"] = str(d / "pltholes")
    write_plotfile(out["holes"], names, 0.0, geoms, [2], bas, data)
    return out


def _bytes(t) -> bytes:
    return np.ascontiguousarray(
        t.numpy() if isinstance(t, torch.Tensor) else t).tobytes()


def _holes_nan(w: DenseAmrState) -> DenseAmrState:
    """A stage that keeps its window's values where the level has boxes
    and puts NaN elsewhere, as a real stage leaves something there: a cut
    that forgot to zero the holes shows."""
    return w.with_data(w.names, [
        torch.where(torch.from_numpy(w.in_level_mask_np(lev)), d,
                    torch.full_like(d, float("nan")))
        for lev, d in enumerate(w.data)])


def _produced(path, dtype=F64, layout="ndevices=3"):
    """(meta, the stage's output kept sharded, the stage on one device:
    its function on the whole state)."""
    per = (True,) * 3 if "per" in os.path.basename(path) else None
    meta, names, fabs = load_plotfile_fabs(path, is_periodic=per)
    mesh = _mesh(layout)
    sd = ShardedDenseState(meta, names, HostFabs(names, fabs), mesh,
                           stencil_halo(GRAD_STAGES, "quadratic"), dtype)
    kept = run_windows(sd, _holes_nan)
    one = _holes_nan(DenseAmrState.from_level_fabs(meta, names, fabs, CPU,
                                                   dtype))
    return meta, kept, one


def _mesh(layout):
    """The mesh of ``ndevices=N [mesh_shape=a b [c]]``."""
    n, _, shape = layout.partition(" mesh_shape=")
    return make_spatial_mesh(int(n.split("=")[1]),
                             [int(v) for v in shape.split()] or None, "cpu")


def _same_window(a: DenseAmrState, b: DenseAmrState) -> None:
    assert a.names == b.names and len(a.data) == len(b.data)
    for lev in range(len(a.data)):
        assert a.data[lev].dtype == b.data[lev].dtype
        assert a.data[lev].shape == b.data[lev].shape
        assert _bytes(a.data[lev]) == _bytes(b.data[lev]), lev
        assert a.lmeta[lev].bbox == b.lmeta[lev].bbox
        assert a.meta.bas[lev] == b.meta.bas[lev]
        assert a.meta.geoms[lev] == b.meta.geoms[lev]
        for m in ("in_level_mask_np", "covered_mask_np"):
            assert np.array_equal(getattr(a, m)(lev), getattr(b, m)(lev))


HALOS = {"grad": stencil_halo(GRAD_STAGES, "quadratic"),
         "curvature": stencil_halo(CURVATURE_STAGES, "quadratic"),
         "iso": ISO_HALO}
LAYOUTS = ["ndevices=2", "ndevices=3", "ndevices=8",
           "ndevices=8 mesh_shape=4 2", "ndevices=8 mesh_shape=2 2 2"]


def _check_windows(path, halo, layout, names, dtype=F64, src_dtype=F64):
    meta, kept, _ = _produced(path, src_dtype)
    mesh = _mesh(layout)
    # the host assembly of the same output, as a consumer of its host
    # FABs builds its windows
    host = ShardedDenseState(meta, names,
                             HostFabs(kept.names, kept.level_fabs()), mesh,
                             halo, dtype)
    cut = ShardedDenseState(meta, names, kept, mesh, halo, dtype)
    before = telemetry.counter("shard.device_windows")
    for s in range(mesh.size):
        _same_window(host.window(s), cut.window(s))
        if halo.duals:
            a, b = host.window_info(s), cut.window_info(s)
            for x, y in zip(a.in_domain + a.covered_ring,
                            b.in_domain + b.covered_ring):
                assert np.array_equal(x, y)
    assert telemetry.counter("shard.device_windows") == before + mesh.size


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("halo", list(HALOS))
@pytest.mark.parametrize("case", ["plain", "periodic", "holes"])
def test_cut_window_is_the_host_window(plotfiles, case, halo, layout):
    _check_windows(plotfiles[case], HALOS[halo], layout,
                   ["temp", "density", "x_velocity"])


@pytest.mark.parametrize("layout", ["ndevices=2", "ndevices=3",
                                    "ndevices=4 mesh_shape=2 2",
                                    "ndevices=8 mesh_shape=4 2"])
@pytest.mark.parametrize("halo", list(HALOS))
def test_cut_window_is_the_host_window_dim2(plotfiles, halo, layout):
    _check_windows(plotfiles["dim2"], HALOS[halo], layout,
                   ["temp", "density"])


@pytest.mark.parametrize("case", ["plain", "periodic"])
def test_cut_window_takes_some_comps_and_widens(plotfiles, case):
    """A consumer of two comps, out of order, in float64 from a float32
    output: the host path casts the same values."""
    _check_windows(plotfiles[case], HALOS["iso"], "ndevices=3",
                   ["density", "temp"], F64, torch.float32)


@pytest.mark.parametrize("case", ["plain", "periodic", "holes", "dim2"])
def test_kept_output_gathers_to_the_gathered_state(plotfiles, case):
    """The kept output gathered into one state and copied to the host as
    FABs: the bytes of the stage run on one device."""
    meta, kept, one = _produced(plotfiles[case])
    assert isinstance(kept, ShardGather)
    assert kept.device == CPU and kept.dtype == F64
    assert kept.names == one.names and kept.meta is meta
    st = kept.state()
    assert kept.state() is st
    for lev in range(meta.n_levels):
        assert _bytes(st.data[lev]) == _bytes(one.data[lev])
    for a, b in zip(kept.level_fabs(), one.level_fabs()):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.flags.c_contiguous and x.shape == y.shape
            assert _bytes(x) == _bytes(y)


@pytest.mark.parametrize("case", ["plain", "periodic", "holes"])
def test_kept_output_writes_the_gathered_plotfile(plotfiles, case):
    """The plotfile packed from the kept parts, on the write-back thread or
    not: the bytes of ``DenseAmrState.to_plotfile`` of the stage run on
    one device."""
    meta, kept, one = _produced(plotfiles[case], layout="ndevices=3")
    one.to_plotfile("ref")
    kept.to_plotfile("sync")
    s = Session(async_writes=True)
    kept.to_plotfile_async("async", lambda th: s.submit_write("async", th))
    s.flush_writes()
    assert tree_bytes("sync") == tree_bytes("ref")
    assert tree_bytes("async") == tree_bytes("ref")


def test_kept_output_missing_a_part_is_not_written(plotfiles):
    """A shard whose output never reached ``add`` leaves its boxes, and the
    boxes that straddle its block, without a record: the write raises
    rather than writing zeros there."""
    meta, names, fabs = load_plotfile_fabs(plotfiles["plain"])
    sd = ShardedDenseState(meta, names, HostFabs(names, fabs),
                           _mesh("ndevices=3"), HALOS["grad"], F64)
    kept = ShardGather(sd)
    for s, win in sd:
        if s != 1:
            kept.add(s, _holes_nan(win))
    with pytest.raises(ValueError, match="no record"):
        kept.to_plotfile("partial")
    assert not os.path.exists("partial")


# -- in a pipeline -------------------------------------------------------------
def tree_bytes(root):
    if os.path.isfile(root):
        return {"": open(root, "rb").read()}
    out = {}
    for dp, _, fns in os.walk(root):
        for fn in fns:
            p = os.path.join(dp, fn)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    assert out, root
    return out


def curvature(plt, shards, *extra):
    return ["curvature", f"infile={plt}", "progressName=temp",
            "dtype=float64", "Aux_Variables=density", *shards.split(),
            "outfile=K", D, *extra]


def isosurface(shards, base="iso"):
    return ["isosurface", "infile=K", "isoCompName=temp", "isoVal=1000",
            "comps=MeanCurvature_temp GaussianCurvature_temp density",
            *shards.split(), f"outfile_base={base}", D]


def pipeline(*stages):
    argv = ["pipeline"]
    for st in stages:
        argv += st + ["--"]
    return argv[:-1]


def _reference_mef(plt):
    """The ``ndevices=1`` pipeline's MEF bytes."""
    assert cli.main(pipeline(curvature(plt, "", "write=0"),
                             isosurface("", "one"))) == 0
    return open("one.mef", "rb").read()


@pytest.mark.parametrize("producer, consumer", [
    ("ndevices=4", "ndevices=4"), ("ndevices=3", "ndevices=2"),
    ("ndevices=2", "ndevices=8 mesh_shape=2 2 2"),
    ("ndevices=4 mesh_shape=2 2", "ndevices=3")])
def test_sharded_curvature_feeds_sharded_isosurface(plotfiles, monkeypatch,
                                                    producer, consumer):
    ref = _reference_mef(plotfiles["plain"])

    def refuse(self):
        raise AssertionError("the output was copied to the host")
    monkeypatch.setattr(DenseAmrState, "level_fabs", refuse)
    before = telemetry.counter("shard.device_windows")
    assert cli.main(pipeline(curvature(plotfiles["plain"], producer,
                                       "write=0"),
                             isosurface(consumer))) == 0
    assert open("iso.mef", "rb").read() == ref
    m = int(consumer.split()[0].split("=")[1])
    assert telemetry.counter("shard.device_windows") == before + m


def test_sharded_curvature_feeds_one_device_isosurface(plotfiles):
    ref = _reference_mef(plotfiles["plain"])
    assert cli.main(pipeline(curvature(plotfiles["plain"], "ndevices=3",
                                       "write=0"),
                             isosurface(""))) == 0
    assert open("iso.mef", "rb").read() == ref


def test_sharded_curvature_feeds_conditional_mean(plotfiles):
    def cm(shards, out):
        assert cli.main(pipeline(
            curvature(plotfiles["plain"], shards, "write=0"),
            ["conditionalMean", "infile=K", "binComp=temp",
             "avgComps=MeanCurvature_temp density", "nBins=16",
             "binMin=300", "binMax=2200", "dtype=float64",
             f"outfile={out}", D])) == 0
        return open(out, "rb").read()
    assert cm("ndevices=3", "cm3.dat") == cm("", "cm1.dat")


@pytest.mark.parametrize("case", ["plain", "periodic"])
@pytest.mark.parametrize("async_writes", [False, True])
def test_sharded_stage_writes_the_one_device_plotfile(plotfiles, case,
                                                      async_writes):
    """``write=1`` in a session, on its write-back thread or not: the
    plotfile packed from the kept parts, the ``ndevices=1`` run's bytes;
    the registered output then feeds a sharded isosurface."""
    plt = plotfiles[case]
    assert cli.main(curvature(plt, "")) == 0
    os.rename("K", "K_ref")
    s = Session(async_writes=async_writes)
    assert cli.main(curvature(plt, "ndevices=3"), session=s) == 0
    assert cli.main(isosurface("ndevices=2"), session=s) == 0
    s.flush_writes()
    assert isinstance(s.plotfiles["K"].output, ShardGather)
    assert tree_bytes("K") == tree_bytes("K_ref")
