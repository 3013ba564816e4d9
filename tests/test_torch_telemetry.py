"""The port's spans and counters (``peleanalysis_tpu_torch/telemetry.py``):
a pipeline's spans nest under its tools and carry its request onto the
prefetch and write-back threads, the read and session counters count
what ``Session.load`` and ``Session.dense`` decided, a stopped telemetry
keeps nothing, and counting from many threads loses nothing."""
import contextlib
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from peleanalysis_tpu_torch import cli, telemetry
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.hierarchy import load_plotfile_fabs
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.server import send_command, serve
from peleanalysis_tpu_torch.session import Session
from peleanalysis_tpu_torch.testing import write_synthetic_plotfile

D = "device=cpu"
DEADLINE = 60.0


@pytest.fixture(scope="module")
def plt(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("plttel") / "plt")
    write_synthetic_plotfile(p, n_cell=16, n_levels=2)
    return p


@pytest.fixture(autouse=True)
def _stopped(monkeypatch):
    # the CLI sets a process-wide compute dtype; telemetry is process-wide
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    telemetry.stop()
    yield
    telemetry.stop()


def cells(plt) -> int:
    r = PlotfileReader(plt)
    return sum(b.size for lev in range(r.meta.finest_level + 1)
               for b in r.box_array(lev))


def series_stages(plt, out):
    """flame-series' four stages on the small plotfile; conditionalMean
    reads its plotfile twice, so the second read runs on the prefetch
    thread."""
    return [["curvature", f"infile={plt}", "progressName=temp",
             "dtype=float64", "Aux_Variables=density", "write=0",
             f"outfile={out}/K", D],
            ["isosurface", f"infile={out}/K", "isoCompName=temp",
             "isoVal=800", "comps=MeanCurvature_temp density",
             f"outfile_base={out}/iso", D],
            ["conditionalMean", f"infiles={plt} {plt}", "binComp=temp",
             "avgComps=density progress", "nBins=16", "binMin=300",
             "binMax=1800", f"outfile={out}/cm.dat", D],
            ["jpdf", f"infile={plt}", "vars=temp progress", "nBins=16",
             "useminmax1=300 1800", "useminmax2=0 1", "output_gnuplot=1",
             "output_plotfile=0", f"outSuffix=_{os.path.basename(out)}", D]]


def pipeline(stages):
    argv = ["pipeline"]
    for st in stages:
        argv += st + ["--"]
    return argv[:-1]


@pytest.fixture(scope="module")
def traced(plt, tmp_path_factory):
    """The telemetry record of one pipeline of the four stages."""
    out = str(tmp_path_factory.mktemp("tel"))
    port_dtype = port_config.compute_dtype
    telemetry.stop()
    telemetry.start()
    try:
        assert cli.main(pipeline(series_stages(plt, out))) == 0
    finally:
        rec = telemetry.stop()
        port_config.set_compute_dtype(port_dtype)
    return rec


def _by_id(rec):
    return {s["id"]: s for s in rec["spans"]}


def _ancestors(s, by_id):
    out = []
    while s["parent"] in by_id:
        s = by_id[s["parent"]]
        out.append(s["name"])
    return out


def test_pipeline_spans_nest_under_their_tools(traced):
    by_id = _by_id(traced)
    names = [s["name"] for s in traced["spans"]]
    (pipe,) = [s for s in traced["spans"] if s["name"] == "pipeline"]
    assert pipe["parent"] == 0 and pipe["request"] > 0
    tools = [s for s in traced["spans"] if s["name"].startswith("tool.")]
    assert [t["name"] for t in sorted(tools, key=lambda t: t["start"])] == [
        "tool.curvature", "tool.isosurface", "tool.conditionalMean",
        "tool.jpdf"]
    assert all(t["parent"] == pipe["id"] for t in tools)
    # every span but the pipeline's has a parent in the record, and a span
    # on its parent's thread lies inside the parent's interval
    for s in traced["spans"]:
        if s is pipe:
            continue
        p = by_id[s["parent"]]
        if p["thread"] == s["thread"]:
            assert p["start"] <= s["start"] <= s["end"] <= p["end"], s
    # each layer's span under the tool that does the work
    want = {"read.plotfile": {"tool.curvature", "tool.conditionalMean",
                              "tool.jpdf"},
            "assemble.host": {"tool.curvature", "tool.conditionalMean",
                              "tool.jpdf"},
            "assemble.h2d": {"tool.curvature", "tool.conditionalMean",
                             "tool.jpdf"},
            "fill.dense": {"tool.curvature", "tool.isosurface"},
            "isosurface.classify": {"tool.isosurface"},
            "write.mef": {"tool.isosurface"},
            "stats.accumulate": {"tool.conditionalMean", "tool.jpdf"},
            "write.text": {"tool.conditionalMean", "tool.jpdf"}}
    for name, tools_of in want.items():
        got = {next(a for a in _ancestors(s, by_id) if a.startswith("tool."))
               for s in traced["spans"] if s["name"] == name}
        assert got == tools_of, name
    assert "session.flush" in names
    assert traced["dropped"] == 0


def test_worker_threads_carry_the_pipeline_request(traced):
    (pipe,) = [s for s in traced["spans"] if s["name"] == "pipeline"]
    by_thread = {}
    for s in traced["spans"]:
        by_thread.setdefault(s["thread"].split("_")[0], []).append(s)
    assert set(by_thread) >= {"MainThread", "pele-prefetch",
                              "pele-writeback"}
    for thread in ("pele-prefetch", "pele-writeback"):
        assert all(s["request"] == pipe["request"]
                   for s in by_thread[thread]), thread
    assert {s["name"] for s in by_thread["pele-prefetch"]} == {
        "read.plotfile"}
    assert "write.mef" in {s["name"] for s in by_thread["pele-writeback"]}
    assert all(s["request"] == pipe["request"] for s in traced["spans"])


def test_read_and_session_counters_of_the_pipeline(traced, plt):
    c = traced["counters"]
    # curvature reads temp and density; conditionalMean's two uncached
    # reads take three comps each, jpdf's two (progress is not cached)
    assert c["read.plotfiles"] == 4
    assert c["read.bytes"] == 8 * cells(plt) * (2 + 3 + 3 + 2)
    assert c["session.host_miss"] == 4 and c["session.host_hit"] == 1
    # isosurface takes curvature's registered output as it is
    assert c["session.dense_build"] == 4 and c["session.dense_hit"] == 1
    assert "h2d.bytes" not in c and "d2h.bytes" not in c    # on the CPU


def test_read_bytes_equal_the_comps_bytes(plt):
    telemetry.start()
    meta, names, fabs = load_plotfile_fabs(plt, ["temp", "density"])
    rec = telemetry.stop()
    assert rec["counters"] == {"read.plotfiles": 1,
                               "read.bytes": 2 * 8 * cells(plt)}
    assert rec["counters"]["read.bytes"] == sum(
        f.nbytes for level in fabs for f in level)
    assert [s["name"] for s in rec["spans"]] == ["read.plotfile"]


def test_second_conditional_mean_moves_session_counters(plt, tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    s = Session()

    def run(argv):
        before = telemetry.counters()
        assert cli.main(argv + [D], session=s) == 0
        after = telemetry.counters()
        return {k.replace("session.", ""): after.get(k, 0) - before.get(k, 0)
                for k in ("session.host_hit", "session.host_miss",
                          "session.dense_hit", "session.dense_build",
                          "read.bytes")}

    def cm(avg):
        return ["conditionalMean", f"infile={plt}", "binComp=temp",
                f"avgComps={avg}", "nBins=8", "binMin=300", "binMax=1800",
                "outfile=cm.dat"]

    n = 8 * cells(plt)
    iso = ["isosurface", f"infile={plt}", "isoCompName=temp", "isoVal=800",
           "comps=density", "outfile_base=iso"]
    # isosurface caches temp and density and their float64 state
    assert run(iso) == {"host_hit": 0, "host_miss": 1, "dense_hit": 0,
                        "dense_build": 1, "read.bytes": 2 * n}
    assert run(iso) == {"host_hit": 1, "host_miss": 0, "dense_hit": 1,
                        "dense_build": 0, "read.bytes": 0}
    # the stats tools load uncached (cache=False): the cached comps are
    # served, their float32 state is built anew each time and not kept
    for _ in range(2):
        assert run(cm("density")) == {"host_hit": 1, "host_miss": 0,
                                      "dense_hit": 0, "dense_build": 1,
                                      "read.bytes": 0}
    # a comp the entry lacks: a fresh, uncached read each time
    for _ in range(2):
        assert run(cm("progress")) == {"host_hit": 0, "host_miss": 1,
                                       "dense_hit": 0, "dense_build": 1,
                                       "read.bytes": 2 * n}


def test_server_request_spans_and_counter(plt, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sock = str(tmp_path / "tel.sock")
    t = threading.Thread(target=serve, args=({"socket": [sock]},),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 10.0
    while True:
        try:
            send_command(sock, cmd="ping", timeout=DEADLINE)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    try:
        telemetry.start()
        for _ in range(2):
            rep = send_command(sock, argv=[
                "isosurface", f"infile={plt}", "isoCompName=temp",
                "isoVal=800", "outfile_base=iso", D], sync=True,
                timeout=DEADLINE)
            assert rep["rc"] == 0, rep["err"]
        send_command(sock, cmd="ping", timeout=DEADLINE)
        rec = telemetry.stop()
    finally:
        send_command(sock, cmd="shutdown", timeout=DEADLINE)
        t.join(timeout=10)
    assert not t.is_alive()
    assert rec["counters"]["serve.requests"] == 2
    by_id = _by_id(rec)
    reqs = [s for s in rec["spans"] if s["name"] == "serve.request"]
    assert len(reqs) == 2 and len({r["request"] for r in reqs}) == 2
    for r in reqs:
        kids = {s["name"] for s in rec["spans"] if s["parent"] == r["id"]}
        assert kids == {"tool.isosurface", "serve.settle"}
        inside = [s for s in rec["spans"] if r["id"] in
                  [x["id"] for x in _ancestor_spans(s, by_id)]]
        assert all(s["request"] == r["request"] for s in inside)
        assert {"write.mef", "isosurface.gather"} <= {s["name"]
                                                      for s in inside}


def _ancestor_spans(s, by_id):
    out = []
    while s["parent"] in by_id:
        s = by_id[s["parent"]]
        out.append(s)
    return out


def test_stopped_span_is_one_shared_null_context(plt, tmp_path):
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = telemetry.span("tool.a"), telemetry.span("read.plotfile")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    # a whole tool run while stopped keeps nothing
    assert cli.main(["conditionalMean", f"infile={plt}", "binComp=temp",
                     "avgComps=density", "nBins=8", "binMin=300",
                     "binMax=1800", f"outfile={tmp_path / 'cm.dat'}",
                     D]) == 0
    telemetry.start()
    rec = telemetry.stop()
    assert rec["spans"] == [] and rec["dropped"] == 0


def test_stopped_span_is_a_profiler_range_under_a_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s = telemetry.span("tool.profiled")
        assert not isinstance(s, contextlib.nullcontext)
        with s:
            torch.ones(4).sum()
        telemetry.start()
        with telemetry.span("isosurface.fill"):
            torch.ones(4).sum()
        kept = telemetry.stop()
    names = {e.name for e in prof.events()}
    assert {"tool.profiled", "isosurface.fill"} <= names
    assert [s["name"] for s in kept["spans"]] == ["isosurface.fill"]


def test_buffer_bound_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(telemetry, "LIMIT", 5)
    telemetry.start()
    for _ in range(8):
        with telemetry.span("write.text"):
            pass
    # a span still open at stop() is not kept
    late = telemetry.span("write.text")
    late.__enter__()
    rec = telemetry.stop()
    late.__exit__(None, None, None)
    assert len(rec["spans"]) == 5 and rec["dropped"] == 3
    telemetry.start()
    assert telemetry.stop() == {"spans": [], "counters": {}, "dropped": 0}


def test_counting_and_spans_from_many_threads_lose_nothing():
    n_threads, n = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        telemetry.start()
        go = threading.Event()

        def work():
            go.wait()
            for _ in range(n):
                telemetry.count("write.test")
                with telemetry.span("write.text"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        go.set()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        rec = telemetry.stop()
    finally:
        sys.setswitchinterval(old)
    assert rec["counters"]["write.test"] == n_threads * n
    assert len(rec["spans"]) == n_threads * n and rec["dropped"] == 0
    assert len({s["id"] for s in rec["spans"]}) == n_threads * n
    durations = np.array([s["end"] - s["start"] for s in rec["spans"]])
    assert (durations >= 0).all()
