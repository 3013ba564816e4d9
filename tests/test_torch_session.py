"""The port's session layer (``peleanalysis_tpu_torch/session.py``), the
``pipeline`` verb and the deferred fetches: chained stages share one
Session, and every output equals the port's file-chained runs byte for
byte.  Mirrors ``tests/test_pipeline.py``; the last test holds the port's
pipeline against the JAX package's on one plotfile."""
import gc
import os
import weakref

import numpy as np
import pytest
import torch

from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.geom.marching_cubes import (DeferredSurface,
                                                        extract_isosurface)
from peleanalysis_tpu_torch.io.mef import read_mef
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.session import Session
from peleanalysis_tpu_torch.stream.trace import (DeferredLines,
                                                 trace_streamlines)
from peleanalysis_tpu_torch.testing import write_synthetic_plotfile

D = "device=cpu"


@pytest.fixture(scope="module")
def plt(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("pltsess") / "plt")
    write_synthetic_plotfile(p, n_cell=32, n_levels=2)
    return p


@pytest.fixture(autouse=True)
def _keep_dtype(monkeypatch):
    # the CLI sets a process-wide compute dtype: restore it afterwards
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)


def tree_bytes(root):
    if os.path.isfile(root):
        return {"": open(root, "rb").read()}
    out = {}
    for dp, _, fns in os.walk(root):
        for fn in fns:
            p = os.path.join(dp, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def assert_same(a, b):
    ta, tb = tree_bytes(a), tree_bytes(b)
    assert ta and set(ta) == set(tb), (a, b)
    for k in ta:
        assert ta[k] == tb[k], f"{a} and {b} differ in {k}"


def chain(plt, out, iso_keys=()):
    """The production chain's four stages, writing under ``out``."""
    return [["grad", f"infile={plt}", "gradVar=temp", f"outfile={out}/g", D],
            ["curvature", f"infile={plt}", "progressName=temp",
             f"outfile={out}/K", D],
            ["isosurface", f"infile={plt}", "isoCompName=temp", "isoVal=800",
             f"outfile_base={out}/iso", D, *iso_keys],
            ["stream", f"plotfile={plt}", f"isoFile={out}/iso.mef",
             "nRKsteps=11", "traceAlongV=0", f"outFile={out}/lines.dat",
             f"streamFile={out}/sd", D]]


def pipeline(stages):
    argv = ["pipeline"]
    for st in stages:
        argv += st + ["--"]
    return argv[:-1]


@pytest.fixture(scope="module")
def file_chain(plt, tmp_path_factory):
    """The chain as four separate CLI runs (the reference's chaining)."""
    out = str(tmp_path_factory.mktemp("sep"))
    for st in chain(plt, out):
        assert cli.main(st) == 0
    return out


def test_pipeline_matches_file_chain(plt, file_chain, tmp_path):
    """Each stage twice in one session (a shared state written in place
    would change the second run's bytes): every output equals the
    file-chained run's."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(a)
    os.makedirs(b)
    stages = [s for pair in zip(chain(plt, a), chain(plt, b)) for s in pair]
    assert cli.main(pipeline(stages)) == 0
    for name in ("g", "K", "iso.mef", "lines.dat", "sd"):
        assert_same(os.path.join(file_chain, name), os.path.join(a, name))
        assert_same(os.path.join(file_chain, name), os.path.join(b, name))


def test_pipeline_shares_one_read_per_plotfile(plt, tmp_path, monkeypatch):
    """grad and curvature (float32) and isosurface and stream (float64) of
    one plotfile read it once and build each dtype's state once."""
    from peleanalysis_tpu_torch import session as sess_mod
    reads, builds = [], []
    real_read = sess_mod.load_plotfile_fabs
    real_build = DenseAmrState.from_level_fabs.__func__
    monkeypatch.setattr(sess_mod, "load_plotfile_fabs",
                        lambda *a, **k: reads.append(a[1]) or real_read(
                            *a, **k))
    monkeypatch.setattr(DenseAmrState, "from_level_fabs", classmethod(
        lambda cls, *a, **k: builds.append(a[4]) or real_build(cls, *a,
                                                               **k)))
    os.makedirs(tmp_path / "p")
    s = Session(async_writes=True)
    assert cli.main(pipeline(chain(plt, str(tmp_path / "p"))),
                    session=s) == 0
    # grad's periodic entry and the others share the one read; float32
    # and float64 are each assembled once
    assert len(reads) == 1 and len(s._states) == 2
    assert builds == [torch.float32, torch.float64]


def test_write0_surface_handed_to_stream(plt, file_chain, tmp_path,
                                         monkeypatch):
    """write=0 on the isosurface stage: no MEF on disk, the session holds
    a DeferredSurface, and stream's lines equal the file chain's."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("m")
    s = Session(async_writes=True)
    stages = chain(plt, "m", iso_keys=["write=0"])[2:]
    assert cli.main(pipeline(stages), session=s) == 0
    assert not os.path.exists("m/iso.mef")
    assert isinstance(s.surfaces["m/iso.mef"], DeferredSurface)
    assert_same(os.path.join(file_chain, "lines.dat"), "m/lines.dat")
    assert_same(os.path.join(file_chain, "sd"), "m/sd")


def test_deferred_surface_equals_eager(plt):
    """positions() copies only the xyz columns; to_mef() equals the eager
    engine's MEF bitwise and drops the device tensors."""
    ds = DenseAmrState.from_plotfile(plt, "cpu", names=["temp", "density"],
                                     dtype=torch.float64)
    surf = extract_isosurface(ds, "temp", 800.0, ["density"], defer=True)
    eager = extract_isosurface(ds, "temp", 800.0, ["density"])
    assert isinstance(surf, DeferredSurface)
    assert (surf.n_nodes, surf.n_elts) == (eager.n_nodes, eager.n_elts)
    assert surf.names == eager.names
    xyz = surf.positions()
    assert surf._mef is None and xyz.dtype == np.float64
    np.testing.assert_array_equal(xyz, eager.positions())
    mef = surf.to_mef()
    assert surf._nodes is None and surf.to_mef() is mef
    np.testing.assert_array_equal(mef.nodes, eager.nodes)
    np.testing.assert_array_equal(mef.elements, eager.elements)
    assert mef.elements.dtype == np.int32
    np.testing.assert_array_equal(surf.elements, eager.elements)
    from peleanalysis_tpu_torch.geom.marching_cubes import \
        extract_isosurface_enum
    with pytest.raises(ValueError, match="want_eids"):
        extract_isosurface_enum(ds, "temp", 800.0, defer=True,
                                want_eids=True)


@pytest.mark.parametrize("compress", [False, True])
def test_deferred_lines_finish_equals_eager(plt, compress):
    """finish(extra=) decodes every level's payload from one packed copy
    into the eager lines bitwise, and returns the extras with the JAX
    dtype rules (int32 and float64 kept, the rest float32); a second
    finish raises."""
    ds = DenseAmrState.from_plotfile(plt, "cpu", names=["temp", "density"],
                                     dtype=torch.float64)
    rng = np.random.default_rng(7)
    seeds = rng.uniform(0.05, 0.95, (300, 3))
    kw = dict(trace_field="temp", sample_names=["density"],
              fetch_compress=compress)
    eager = trace_streamlines(ds, seeds, 11, 0.5, **kw)
    dl = trace_streamlines(ds, seeds, 11, 0.5, defer=True, **kw)
    assert isinstance(dl, DeferredLines)
    extra = [torch.arange(5, dtype=torch.float64) / 3,
             torch.linspace(0, 1, 7, dtype=torch.float32).reshape(7, 1),
             torch.arange(6, dtype=torch.int32).reshape(2, 3),
             torch.tensor([1.5, 2.5], dtype=torch.bfloat16),
             torch.arange(3, dtype=torch.int64)]
    lines, got = dl.finish(extra=extra)
    np.testing.assert_array_equal(lines, eager)
    assert [g.dtype for g in got] == [np.float64, np.float32, np.int32,
                                      np.float32, np.float32]
    for g, e in zip(got, extra):
        assert g.shape == tuple(e.shape)
        np.testing.assert_array_equal(g, e.to(torch.float64).numpy())
    with pytest.raises(RuntimeError, match="already consumed"):
        dl.finish()


def test_deferred_lines_without_seeds(plt):
    ds = DenseAmrState.from_plotfile(plt, "cpu", names=["temp"],
                                     dtype=torch.float64)
    lines, extras = trace_streamlines(ds, np.zeros((0, 3)), 11, 0.5,
                                      trace_field="temp",
                                      defer=True).finish()
    assert lines.shape == (0, 11, 3) and extras == []


def test_session_extends_comps_in_place(plt):
    """A later load needing more comps extends the cached entry in place:
    the same entry and the same dense state, the new comp's values those
    of a fresh read."""
    s = Session()
    st1 = s.load(plt, names=["temp"], is_periodic=[False] * 3)
    ds1 = s.dense(st1, "cpu", torch.float32)
    st2 = s.load(plt, names=["temp", "density"], is_periodic=[False] * 3)
    assert st2 is st1 and st1.names == ["temp", "density"]
    ds2 = s.dense(st2, "cpu", torch.float32)
    assert ds2 is ds1 and ds1.names == ["temp", "density"]
    ref = DenseAmrState.from_plotfile(plt, "cpu", names=["density"],
                                      is_periodic=[False] * 3)
    for lev in range(ds1.meta.n_levels):
        torch.testing.assert_close(ds1.data[lev][1], ref.data[lev][0],
                                   rtol=0, atol=0)


def test_pipeline_mef_tools_stage(plt, tmp_path, monkeypatch):
    """MEF tool stages resolve an upstream surface from the session and
    equal the file-chained run."""
    monkeypatch.chdir(tmp_path)
    iso = ["isosurface", f"infile={plt}", "isoCompName=temp", "isoVal=800",
           "comps=density", D]
    scale = ["scaleMEF", "comps=temp", "factors=2", D]
    assert cli.main(iso + ["outfile_base=f_iso"]) == 0
    assert cli.main(scale + ["infile=f_iso.mef", "outfile=f_sc.mef"]) == 0
    assert cli.main(pipeline([iso + ["outfile_base=iso", "write=0"],
                              scale + ["infile=iso.mef",
                                       "outfile=sc.mef"]])) == 0
    assert not os.path.exists("iso.mef")
    assert_same("f_sc.mef", "sc.mef")
    np.testing.assert_allclose(read_mef("sc.mef").field("temp"), 1600.0)


def test_pipeline_stats_stage(plt, tmp_path, monkeypatch):
    """conditionalMean and jpdf ride the session's cache."""
    monkeypatch.chdir(tmp_path)
    cm = ["conditionalMean", f"infiles={plt}", "binComp=temp",
          "avgComps=density", "nBins=16", "binMin=300", "binMax=1800",
          "outfile=cm.dat", D]
    assert cli.main(cm) == 0
    os.rename("cm.dat", "cm_file.dat")
    assert cli.main(pipeline([
        ["grad", f"infile={plt}", "gradVar=temp", "is_per=0 0 0",
         "outfile=g", "write=0", D], cm])) == 0
    assert not os.path.exists("g")
    assert_same("cm_file.dat", "cm.dat")


def test_pipeline_streamdata_handoff(plt, file_chain, tmp_path,
                                     monkeypatch):
    """stream write=0 -> streamTubeStats and stream2plt resolve the lines
    from the session (no folder on disk), equal to the file chain."""
    monkeypatch.chdir(tmp_path)
    sd = os.path.join(file_chain, "sd")
    tube = ["streamTubeStats", "nSmooth=1", D]
    to_plt = ["stream2plt", D]
    assert cli.main(tube + [f"infile={sd}", "outfile=f_tube"]) == 0
    assert cli.main(to_plt + [f"infile={sd}", "outfile=f_l.fab"]) == 0
    stream = chain(plt, file_chain)[3]
    stream = [a for a in stream
              if not a.startswith(("outFile=", "streamFile="))]
    assert cli.main(pipeline([
        stream + ["streamFile=sd_mem", "write=0"],
        tube + ["infile=sd_mem", "outfile=m_tube"],
        to_plt + ["infile=sd_mem", "outfile=m_l.fab"]])) == 0
    assert not os.path.exists("sd_mem")
    assert_same("f_tube.mef", "m_tube.mef")
    assert_same("f_l.fab", "m_l.fab")


def test_pipeline_combine_and_filter_stages(plt, tmp_path, monkeypatch):
    """combinePlts takes earlier write=0 stages' plotfiles (a float32 grad,
    a float32 filterPlt) from the session: equal to the file chain."""
    monkeypatch.chdir(tmp_path)
    grad = ["grad", f"infile={plt}", "gradVar=temp", D]
    filt = ["filterPlt", f"infile={plt}", "vars=temp density", D]
    comb = ["combinePlts", "vars=||gradtemp|| density", D]
    assert cli.main(grad + ["outfile=fg"]) == 0
    assert cli.main(filt + ["outfile=ff"]) == 0
    assert cli.main(comb + ["infiles=fg ff", "outfile=fc"]) == 0
    assert cli.main(pipeline([grad + ["outfile=g", "write=0"],
                              filt + ["outfile=f", "write=0"],
                              comb + ["infiles=g f", "outfile=c"]])) == 0
    assert not os.path.exists("g") and not os.path.exists("f")
    assert_same("fc", "c")
    assert PlotfileReader("c").var_names == ["||gradtemp||", "density"]


@pytest.mark.parametrize("tool", [
    ["subPlt", "box=4 4 4 11 11 11", "comps=||gradtemp||"],
    ["regridPlt", "max_grid_size=8"],
    ["flattenAMRFile"],
    ["slicePlot", "varname=||gradtemp||", "slicedir=2", "sliceloc=16",
     "outtype=gray"],
    ["avgToPlane", "vars=||gradtemp||", "dir=2", "format=dat"],
    ["integral", "vars=||gradtemp||", "integralDimension=1", "dir=2"],
    ["amrToFE", "vars=||gradtemp||", "outType=flt"],
], ids=lambda t: t[0])
def test_load_only_tools_take_a_write0_output(plt, tmp_path, monkeypatch,
                                              tool):
    """A load-only tool after a write=0 grad resolves the plotfile from the
    session; its outputs equal the same tool on the written file."""
    monkeypatch.chdir(tmp_path)
    grad = ["grad", f"infile={plt}", "gradVar=temp", "outfile=g", D]
    assert cli.main(grad) == 0
    assert cli.main([tool[0], "infile=g", *tool[1:], D]
                    if tool[0] != "slicePlot"
                    else [tool[0], "file=g", *tool[1:], D]) == 0
    before = {f: tree_bytes(f) for f in os.listdir(".") if f != "g"}
    import shutil
    shutil.rmtree("g")
    for f in before:
        shutil.rmtree(f) if os.path.isdir(f) else os.remove(f)
    key = "file=g" if tool[0] == "slicePlot" else "infile=g"
    assert cli.main(pipeline([grad + ["write=0"],
                              [tool[0], key, *tool[1:], D]])) == 0
    assert not os.path.exists("g")
    after = {f: tree_bytes(f) for f in os.listdir(".")}
    assert before and after == before


def test_pipeline_rejects_empty_stage(plt):
    assert cli.main(["pipeline", "--", "grad", f"infile={plt}", D]) == 2
    assert cli.main(["pipeline"]) == 2


def test_session_output_option_mismatch_errors(plt, tmp_path, monkeypatch):
    """A write=0 output asked for with comps it does not have, or load
    options the producer did not use, raises the JAX package's error."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="write=1") as ei:
        cli.main(pipeline([
            ["grad", f"infile={plt}", "gradVar=temp", "outfile=g",
             "write=0", D],
            ["curvature", "infile=g", "progressName=density",
             "outfile=K", D]]))
    assert "comps ['density']" in str(ei.value)
    with pytest.raises(ValueError, match="different load options"):
        cli.main(pipeline([
            ["grad", f"infile={plt}", "gradVar=temp", "outfile=g",
             "write=0", D],
            ["curvature", "infile=g", "progressName=||gradtemp||",
             "is_per=0 0 0", "outfile=K", D]]))


def test_session_shadow_not_served_to_wider_compute_dtype(plt, tmp_path,
                                                          monkeypatch):
    """A dtype=float64 stage does not run on a float32 output: with the
    file written it reads the file (equal to the file chain), with write=0
    it raises; copy-only combinePlts takes the narrower output."""
    monkeypatch.chdir(tmp_path)
    grad = ["grad", f"infile={plt}", "gradVar=temp", D]
    curv = ["curvature", "progressName=||gradtemp||", "dtype=float64", D]
    assert cli.main(grad + ["outfile=fg"]) == 0
    assert cli.main(curv + ["infile=fg", "outfile=fK"]) == 0
    s = Session(async_writes=True)
    assert cli.main(pipeline([grad + ["outfile=g"],
                              curv + ["infile=g", "outfile=K"]]),
                    session=s) == 0
    assert_same("fK", "K")
    assert s.plotfiles["g"].state.dtype == torch.float32
    with pytest.raises(ValueError, match="write=1"):
        cli.main(pipeline([grad + ["outfile=gnw", "write=0"],
                           curv + ["infile=gnw", "outfile=Knw"]]))


def test_pipeline_2d_plotfile(tmp_path, monkeypatch):
    """A DIM=2 plotfile chains isosurface (marching squares) -> scaleMEF
    through the session."""
    monkeypatch.chdir(tmp_path)
    write_synthetic_plotfile("plt2d", n_cell=32, n_levels=2, ndim=2)
    assert cli.main(pipeline([
        ["isosurface", "infile=plt2d", "isoCompName=temp", "isoVal=800",
         "outfile_base=c2", "write=0", D],
        ["scaleMEF", "infile=c2.mef", "comps=temp", "factors=0.5",
         "outfile=s2.mef", D]])) == 0
    m = read_mef("s2.mef")
    assert not os.path.exists("c2.mef") and m.n_elts > 0
    np.testing.assert_allclose(m.field("temp"), 400.0)


def test_session_reset_frees(plt, tmp_path, monkeypatch):
    """reset drops every cached state and output: nothing keeps them
    alive afterwards."""
    monkeypatch.chdir(tmp_path)
    s = Session()
    s.run("curvature", infile=plt, progressName="temp", outfile="K0",
          write=0, device="cpu")
    assert s.plotfiles and s._states and s._dense
    refs = [weakref.ref(v) for v in s._dense.values()]
    refs += [weakref.ref(v.state) for v in s.plotfiles.values()]
    s.reset()
    assert not (s.plotfiles or s._states or s._dense or s._retain)
    gc.collect()
    assert all(r() is None for r in refs)
    s.run("grad", infile=plt, outfile="g1", write=0, device="cpu")
    assert "g1" in s.plotfiles


def test_async_writeback_parity_and_order(plt, tmp_path, monkeypatch):
    """to_plotfile_async writes the bytes of to_plotfile, and a rewrite of
    the same path does not race its predecessor."""
    monkeypatch.chdir(tmp_path)
    ds = DenseAmrState.from_plotfile(plt, "cpu", dtype=torch.float32)
    ds.to_plotfile("sync_plt")
    s = Session(async_writes=True)
    for _ in range(2):
        ds.to_plotfile_async("async_plt",
                             lambda th: s.submit_write("async_plt", th))
    s.flush_writes()
    assert s._wb == []
    assert_same("sync_plt", "async_plt")


def test_writeback_error_surfaces_on_flush():
    s = Session(async_writes=True)

    def boom():
        raise IOError("disk full")

    s.submit_write("some/path", boom)
    with pytest.raises(IOError, match="disk full"):
        s.flush_writes()
    assert s._wb == []


def test_writeback_runs_in_order():
    s = Session(async_writes=True)
    done = []
    for i in range(20):
        s.submit_write(f"p{i}", lambda i=i: done.append(i))
    s.flush_writes(match=["p19"])
    assert done == list(range(20))
    s.flush_writes()


def test_writeback_stress_from_threads():
    """Eight threads submitting and flushing with a short switch interval:
    every write runs exactly once, each thread's in submission order."""
    import sys
    import threading
    s = Session(async_writes=True)
    done = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(w):
            for i in range(40):
                s.submit_write(f"w{w}/p{i % 3}",
                               lambda w=w, i=i: done.append((w, i)))
                if i % 7 == 0:
                    s.flush_writes(match=[f"w{w}/p0"])

        ts = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        s.flush_writes()
    finally:
        sys.setswitchinterval(old)
    assert sorted(done) == [(w, i) for w in range(8) for i in range(40)]
    for w in range(8):
        assert [i for ww, i in done if ww == w] == list(range(40))
    assert s._wb == []


def test_flush_match_normalizes_path_spelling(tmp_path, monkeypatch):
    """flush_writes(match=argv) settles a pending write named with another
    spelling of the same path; an unrelated argv settles nothing."""
    monkeypatch.chdir(tmp_path)
    for producer, consumer in (("./out_g", f"infile={tmp_path}/out_g"),
                               (str(tmp_path / "out_g"), "infile=out_g"),
                               ("out_g", "infile=./out_g")):
        s = Session(async_writes=True)
        done = []
        s.submit_write(producer, lambda: done.append(1))
        s.flush_writes(match=[consumer])
        assert s._wb == [] and done == [1], (producer, consumer)
    s = Session(async_writes=True)
    s.submit_write("out_g", lambda: None)
    s.flush_writes(match=["infile=unrelated"])
    assert len(s._wb) == 1
    s.flush_writes()


def test_pipeline_failing_stage_rc_survives_writeback_error(
        plt, tmp_path, monkeypatch, capsys):
    """A failing stage's exception is not replaced by a write-back error
    from the final flush; the write error goes to stderr."""
    monkeypatch.chdir(tmp_path)
    orig = Session.flush_writes
    calls = {"n": 0}

    def flaky(self, match=None):
        if match is None and calls["n"] == 0:
            calls["n"] += 1
            raise IOError("late write-back failure")
        return orig(self, match=match)

    monkeypatch.setattr(Session, "flush_writes", flaky)
    s = Session(async_writes=True)
    with pytest.raises(FileNotFoundError):
        cli.main(pipeline([
            ["grad", f"infile={plt}", "gradVar=temp",
             f"outfile={tmp_path / 'g1'}", D],
            ["grad", "infile=NO_SUCH_PLT", "gradVar=temp", D]]), session=s)
    assert "pending write failed" in capsys.readouterr().err
    orig(s)            # the write the failed flush left pending
    assert os.path.isfile(tmp_path / "g1" / "Header")


def test_pipeline_flushes_write_before_disk_read(plt, tmp_path,
                                                 monkeypatch):
    """A stage that reads a pending write-back from disk (fcompare does
    not go through the session) sees the finished file."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(pipeline([
        ["grad", f"infile={plt}", "gradVar=temp", "outfile=gg", D],
        ["fcompare", "infile1=gg", "infile2=gg", D]])) == 0


def test_session_rewrite_evicts_stale_state(tmp_path):
    """A rewritten plotfile evicts its cache entry: the reload serves the
    new values and the session holds one entry for the path."""
    p = str(tmp_path / "plt_rw")
    write_synthetic_plotfile(p, n_cell=8, n_levels=1,
                             fields={"temp": lambda x, y, z: x * 0 + 1.0})
    s = Session()
    st1 = s.load(p, names=["temp"])
    assert float(s.dense(st1, "cpu", torch.float64).data[0][0, 0, 0, 0]) \
        == 1.0
    write_synthetic_plotfile(p, n_cell=8, n_levels=1,
                             fields={"temp": lambda x, y, z: x * 0 + 2.0})
    os.utime(os.path.join(p, "Header"), (1.0, 1.0))
    st2 = s.load(p, names=["temp"])
    assert st2 is not st1
    assert float(s.dense(st2, "cpu", torch.float64).data[0][0, 0, 0, 0]) \
        == 2.0
    assert len(s._states) == 1 and len(s._dense) == 1


def test_unused_write_key_warns_outside_a_session(plt, tmp_path, capsys):
    out = str(tmp_path / "g")
    assert cli.main(["grad", f"infile={plt}", f"outfile={out}", "write=0",
                     D]) == 0
    assert "unused input keys (typo?): write" in capsys.readouterr().err
    assert os.path.isdir(out)      # outside a session write= is not read


def test_pele_profile_writes_a_chrome_trace(plt, tmp_path, monkeypatch):
    monkeypatch.setenv("PELE_PROFILE", str(tmp_path / "prof"))
    assert cli.main(["grad", f"infile={plt}",
                     f"outfile={tmp_path / 'g'}", D]) == 0
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].startswith("grad_")
    import json
    with open(tmp_path / "prof" / traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_port_pipeline_matches_jax_pipeline(plt, tmp_path, monkeypatch):
    """The JAX package's pipeline and the port's, the same four stages on
    one plotfile: grad and curvature within the float32 tolerances of the
    per-tool parity tests with the same non-finite cells, the isosurface's
    node set and element count, the lines within 1e-12."""
    from peleanalysis_tpu import cli as jax_cli
    from peleanalysis_tpu import config as jax_config
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.chdir(tmp_path)
    for d in ("jax", "port"):
        os.makedirs(d)
    stages = chain(plt, "port")
    assert cli.main(pipeline(stages)) == 0
    jstages = [[a for a in st if a != D and not a.startswith(
        "streamFile")] for st in chain(plt, "jax")]
    assert jax_cli.main(pipeline(jstages)) == 0
    for name in ("g", "K"):
        ra, rb = PlotfileReader(f"port/{name}"), PlotfileReader(f"jax/{name}")
        assert ra.var_names == rb.var_names
        for lev in range(ra.meta.n_levels):
            for fa, fb in zip(ra.read_level(lev), rb.read_level(lev)):
                np.testing.assert_array_equal(np.isfinite(fa),
                                              np.isfinite(fb))
                fin = np.isfinite(fb)
                for c in range(fb.shape[0]):
                    a, b = fa[c][fin[c]], fb[c][fin[c]]
                    scale = float(np.max(np.abs(b), initial=0.0))
                    tol = 1e-5 if name == "g" else 1e-3
                    assert np.max(np.abs(a - b), initial=0.0) <= \
                        tol * scale, (name, lev, ra.var_names[c])
    ma, mb = read_mef("port/iso.mef"), read_mef("jax/iso.mef")
    assert ma.n_elts == mb.n_elts and ma.n_nodes == mb.n_nodes
    np.testing.assert_allclose(np.sort(ma.nodes, axis=0),
                               np.sort(mb.nodes, axis=0), rtol=0,
                               atol=1e-12 * np.abs(mb.nodes).max())
    la = np.loadtxt([ln for ln in open("port/lines.dat")
                     if ln[:1].isdigit() or ln[:1] in "-."])
    lb = np.loadtxt([ln for ln in open("jax/lines.dat")
                     if ln[:1].isdigit() or ln[:1] in "-."])
    assert la.shape == lb.shape
    np.testing.assert_allclose(la, lb, rtol=0, atol=1e-12 * np.abs(lb).max())
