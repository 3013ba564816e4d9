"""The metrics that read the program's own spans and counters
(``portbench/program.py``): their arithmetic on synthetic records, the
window the hooks open and close, the breakdown's labels, and a traced run
of each cell on the CPU that reports them all."""
from __future__ import annotations

import pytest

from conftest import run_tiny
from portbench import program
from portbench.devtrace import idle_gaps
from portbench.hooks import Hooks
from portbench.spec import load_benchmark, load_metric

SERIES = ["read_span_s.series", "assemble_s.series", "tool_self_s.series",
          "write_span_s.series"]
EXPLORE = ["read_mb_per_request.explore", "h2d_mb_per_request.explore",
           "dense_hit_share.explore", "serve_ms.explore"]


def _span(i, name, s, t, parent=0, request=1, thread="MainThread"):
    return {"name": name, "start": s, "end": t, "id": i, "parent": parent,
            "request": request, "thread": thread}


def _series_record():
    # one pipeline [0, 10]: curvature [0, 4] reads [0, 1] and assembles
    # [1, 1.5] and [1.4, 2]; isosurface [4, 7] with a stage [5, 6] and its
    # MEF written on the write-back thread [6.5, 8] (past the tool's end);
    # conditionalMean [7, 10] reads on the prefetch thread [7, 8] and
    # writes text [9, 9.5]
    spans = [_span(1, "pipeline", 0, 10),
             _span(2, "tool.curvature", 0, 4, 1),
             _span(3, "read.plotfile", 0, 1, 2),
             _span(4, "assemble.host", 1, 1.5, 2),
             _span(5, "assemble.h2d", 1.4, 2, 2),
             _span(6, "tool.isosurface", 4, 7, 1),
             _span(7, "isosurface.fill", 5, 6, 6),
             _span(8, "write.mef", 6.5, 8, 6, thread="pele-writeback_0"),
             _span(9, "tool.conditionalMean", 7, 10, 1),
             _span(10, "read.plotfile", 7, 8, 9, thread="pele-prefetch_0"),
             _span(11, "write.text", 9, 9.5, 9),
             _span(12, "writeback.wait", 9.25, 9.75, 9)]
    tel = {"spans": spans, "counters": {}, "dropped": 0}
    return {"jobs": 2, "kinds": {}, "trace": None,
            "hooks": {"spans": {}, "calls": {"program": [tel]}}}


def test_series_span_metrics():
    rec = _series_record()
    assert load_metric("read_span_s.series").read(rec) == pytest.approx(1.0)
    assert load_metric("assemble_s.series").read(rec) == pytest.approx(0.5)
    assert load_metric("write_span_s.series").read(rec) == pytest.approx(
        (1.5 + 0.75) / 2)
    # tools cover [0, 10]; descendants cover [0, 2], [5, 6], [6.5, 8],
    # [7, 8] and [9, 9.75]: 10 - (2 + 1 + 1.5 + 0.75) = 4.75 of self time
    assert load_metric("tool_self_s.series").read(rec) == pytest.approx(
        4.75 / 2)


def test_self_time_counts_descendants_on_other_threads_once():
    spans = [_span(1, "serve.request", 0, 4),
             _span(2, "tool.jpdf", 0.5, 2, 1),
             _span(3, "stats.accumulate", 1, 3, 2, thread="worker"),
             _span(4, "serve.settle", 3.5, 3.8, 1),
             _span(5, "serve.request", 10, 11, request=2),
             _span(6, "write.text", 20, 21, 0)]
    tel = {"spans": spans, "counters": {}, "dropped": 0}
    # request 1: [0, 4] less [0.5, 3] and [3.5, 3.8]; request 2: all
    assert program.self_s(tel, lambda n: n == "serve.request") == \
        pytest.approx(4 - 2.5 - 0.3 + 1)
    assert program.union_s(tel, lambda n: n.startswith("write.")) == 1.0


def test_explore_counter_metrics():
    c = {"serve.requests": 10, "read.bytes": 330_000_000,
         "h2d.bytes": 180_000_000, "session.dense_hit": 5,
         "session.dense_build": 5}
    spans = [_span(1, "serve.request", 0, 0.1),
             _span(2, "tool.isosurface", 0.01, 0.08, 1),
             _span(3, "serve.settle", 0.09, 0.095, 1)]
    rec = {"jobs": 10, "hooks": {"spans": {}, "calls": {"program": [
        {"spans": spans, "counters": c, "dropped": 0}]}}}
    assert load_metric("read_mb_per_request.explore").read(rec) == 33.0
    assert load_metric("h2d_mb_per_request.explore").read(rec) == 18.0
    assert load_metric("dense_hit_share.explore").read(rec) == 50.0
    assert load_metric("serve_ms.explore").read(rec) == pytest.approx(
        1e3 * 0.025 / 10)
    # no read at all is a reading of 0, not a missing one
    c.pop("read.bytes")
    assert load_metric("read_mb_per_request.explore").read(rec) == 0.0


@pytest.mark.parametrize("name", SERIES + EXPLORE)
def test_new_readers_return_nothing_without_the_program(name):
    # a checkout whose program has no telemetry leaves no record
    rec = {"jobs": 4, "kinds": {}, "trace": None,
           "hooks": {"spans": {}, "calls": {}}}
    assert load_metric(name).read(rec) is None
    assert load_metric(name).HOOKS == [program.WINDOW]


def test_benchmark_lists_each_new_metric_in_its_cell():
    per_layer = {m["name"]: m for m in load_benchmark()["per_layer"]}
    for names, cell in ((SERIES, "flame-series"),
                        (EXPLORE, "flame-explore")):
        for n in names:
            assert per_layer[n]["workloads"] == [cell]
            assert per_layer[n]["source"] in ("program_span",
                                              "program_counter")


def test_hooks_open_and_close_the_program_window():
    from peleanalysis_tpu_torch import telemetry
    telemetry.stop()
    # two metrics' copies of the hook: one window
    hk = Hooks([program.WINDOW, {"span": "write", "open_in": [
        "peleanalysis_tpu_torch.io.mef"]}, program.WINDOW]).install()
    try:
        with telemetry.span("read.plotfile"):
            telemetry.count("read.bytes", 8)
        with telemetry.span("isosurface.fill"):
            pass
    finally:
        hk.uninstall()
    assert not hasattr(program, "open")
    rec = hk.record()
    (tel,) = rec["calls"]["program"]
    assert [s["name"] for s in tel["spans"]] == ["read.plotfile",
                                                 "isosurface.fill"]
    assert tel["counters"] == {"read.bytes": 8} and tel["dropped"] == 0
    # the breakdown sees the program's spans; the device trace carries
    # the isosurface ranges
    s = tel["spans"][0]
    assert rec["spans"] == {"read.plotfile": [[s["start"], s["end"]]]}
    # telemetry is stopped again: spans are not kept
    assert telemetry.span("tool.x") is telemetry.span("tool.y")


def test_breakdown_labels_idle_time_with_program_spans():
    # idle [0, 1], [2, 10]: the hooks' stage covers [2, 10], the program's
    # stats span [3, 6] inside it and a serve span [0, 10] around all
    trace = {"window": [0.0, 10.0], "device": [["k", 1.0, 2.0]],
             "ranges": []}
    hooks = {"stage.jpdf": [[2.0, 10.0]]}
    tel = {"spans": [_span(1, "serve.request", 0, 10),
                     _span(2, "stats.accumulate", 3, 6, 1)]}
    for s in tel["spans"]:
        hooks.setdefault(s["name"], []).append([s["start"], s["end"]])
    gaps = dict(idle_gaps(trace, hooks))
    assert gaps == pytest.approx({"serve.request": 1.0, "stage.jpdf": 5.0,
                                  "stats.accumulate": 3.0})


@pytest.mark.parametrize("workload,names", [("flame-series", SERIES),
                                            ("flame-explore", EXPLORE)])
def test_traced_cell_reports_the_program_metrics(workload, names):
    keep = []
    out = run_tiny(workload, seconds=3.0, trace=True, keep=keep)
    assert out["correct"], out["checks"]
    for n in names:
        assert out["metrics"][n]["value"] is not None, n
    tel = program.telemetry(keep[0])
    assert tel["dropped"] == 0
    # the breakdown labels idle time with the program's spans too
    labels = {k for k, _ in out["breakdown"]["idle_gaps"]}
    assert labels & {s["name"] for s in tel["spans"]
                     if not s["name"].startswith("isosurface.")}, labels
    if workload == "flame-explore":
        c = tel["counters"]
        # the stats requests read and build again; the isosurfaces do not
        assert c["serve.requests"] == keep[0]["attempted"]
        assert c["read.bytes"] > 0
        assert 0 < out["metrics"]["dense_hit_share.explore"]["value"] < 100
