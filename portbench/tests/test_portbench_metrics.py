"""The metric arithmetic on synthetic records."""
from __future__ import annotations

import statistics

import pytest

from portbench import roofline
from portbench.devtrace import busy_s, device_ops, idle_gaps, union
from portbench.harness import E2E, _p90
from portbench.spec import load_metric


def _trace():
    # window [0, 10]: kernels 1-2 and 1.5-3 overlap, a copy 5-6, a kernel
    # running past the window's end 9.5-11
    return {"window": [0.0, 10.0],
            "device": [["k_a", 1.0, 2.0], ["k_b", 1.5, 3.0],
                       ["Memcpy DtoH", 5.0, 6.0], ["k_a", 9.5, 11.0]],
            "ranges": [["isosurface.fill", 3.5, 4.5],
                       ["isosurface.gather", 4.0, 4.8]]}


def test_union_and_idle_share():
    t = _trace()
    assert union([(1, 2), (1.5, 3), (5, 6)], 0, 10) == [(1, 3), (5, 6)]
    assert busy_s(t) == pytest.approx(2.0 + 1.0 + 0.5)
    idle = load_metric("device_idle.series").read({"trace": t})
    assert idle == pytest.approx(100.0 * (1 - 3.5 / 10.0))
    assert load_metric("device_idle.explore").read({"trace": t}) == idle


def test_device_ops_and_idle_gaps():
    t = _trace()
    ops = dict(device_ops(t))
    assert ops["k_a"] == pytest.approx(1.5)
    assert ops["k_b"] == pytest.approx(1.5)
    gaps = dict(idle_gaps(t, {"stage.isosurface": [[3.2, 5.0]],
                              "read": [[6.0, 9.5]]}))
    # idle 0-1, 3-5 and 6-9.5; each stretch to its innermost span: 3-3.2
    # none, 3.2-3.5 and 4.8-5 the stage, 3.5-4 fill, 4-4.8 gather (shorter
    # than fill), 6-9.5 read
    assert gaps["host"] == pytest.approx(1.2)
    assert gaps["stage.isosurface"] == pytest.approx(0.5)
    assert gaps["isosurface.fill"] == pytest.approx(0.5)
    assert gaps["isosurface.gather"] == pytest.approx(0.8)
    assert gaps["read"] == pytest.approx(3.5)


def test_p90_and_rates():
    lat = [i / 100 for i in range(1, 101)]
    assert _p90(lat) == pytest.approx(
        statistics.quantiles(lat, n=10, method="inclusive")[-1])
    assert _p90(lat) == pytest.approx(0.901)
    rec = {"jobs": 40, "window_s": 20.0, "latencies": lat,
           "peak_bytes": 3e9, "setup_s": 12.5}
    assert E2E["requests_per_s"](rec) == 2.0
    assert load_metric("plotfile_s.series").read(rec) == 0.5
    assert load_metric("plotfile_s.series").read(
        dict(rec, jobs=0)) is None
    assert E2E["request_p90_ms"](rec) == pytest.approx(901.0)
    assert E2E["peak_device_gb"](rec) == 3.0


def test_grad_mag_roofline_of_a_known_shape():
    # grown 124^3 float32 with the magnitude: 124^3 * 4 read, 4 * 122^3 * 4
    # written = 36.69 MB, bytes-bound at 3.35 TB/s
    call = {"args": [{"shape": [124, 124, 124], "itemsize": 4,
                      "dtype": "float32"}, [0.1, 0.1, 0.1], True],
            "kwargs": {}}
    nbytes, flops, dt = roofline.grad_mag(call)
    assert nbytes == 124 ** 3 * 4 + 4 * 122 ** 3 * 4
    t, by = roofline.bound(nbytes, flops, dt)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    tr = {"window": [0.0, 1.0],
          "device": [["void grad_mag_kernel<float>(...)", 0.1, 0.1 + 2 * t]]}
    rec = {"trace": tr, "hooks": {"calls": {"grad_mag": [call]}}}
    assert load_metric("grad_mag_roofline").read(rec) == pytest.approx(50.0)


def test_stats_roofline_of_a_known_shape():
    n = 1 << 20
    cell = {"shape": [n], "itemsize": 4, "dtype": "float32"}
    b = {"args": [cell, {"shape": [1, n], "itemsize": 4, "dtype": "float32"},
                  64.0, {"shape": [n], "itemsize": 1, "dtype": "bool"},
                  [300.0, 0.04, False], 64, False, False, None],
         "kwargs": {}}
    nbytes, _, _ = roofline.binned_moments(b)
    assert nbytes == 4 * n * 2 + n + 4 * 64 * 3
    j = {"args": [[cell, cell], 1e-6, {"shape": [n], "itemsize": 1,
                                        "dtype": "bool"},
                  [[0.0, 1.0, True], [0.0, 1.0, True]], 64, [[0, 1]], None],
         "kwargs": {}}
    jb, _, _ = roofline.joint_hist(j)
    assert jb == 4 * n * 2 + n + 4 * 3 * 64 * 64
    tb = roofline.bound(nbytes, 0, "float32")[0]
    tj = roofline.bound(jb, 0, "float32")[0]
    tr = {"window": [0.0, 1.0],
          "device": [["binned_kernel<float>", 0.0, tb * 2],
                     ["joint_kernel<float>", 0.5, 0.5 + tj * 2]]}
    rec = {"trace": tr, "hooks": {"calls": {"binned_moments": [b],
                                            "joint_hist": [j]}}}
    assert load_metric("stats_hist_roofline").read(rec) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["read_s.series", "write_s.series",
                                  "device_idle.series", "grad_mag_roofline",
                                  "device_idle.explore",
                                  "launches_per_request.explore",
                                  "extract_ms.explore",
                                  "stats_hist_roofline"])
def test_readers_return_nothing_without_data(name):
    rec = {"jobs": 0, "kinds": {}, "trace": None,
           "hooks": {"spans": {}, "calls": {}}}
    assert load_metric(name).read(rec) is None


def test_span_and_launch_readers():
    t = _trace()
    rec = {"jobs": 4, "kinds": {"isosurface": 2}, "trace": t,
           "hooks": {"spans": {"read": [[0, 1], [2, 2.5]],
                               "write": [[3, 3.25]]}, "calls": {}}}
    assert load_metric("read_s.series").read(rec) == pytest.approx(1.5 / 4)
    assert load_metric("write_s.series").read(rec) == pytest.approx(0.25 / 4)
    assert load_metric("launches_per_request.explore").read(rec) == \
        pytest.approx(3 / 4)
    assert load_metric("extract_ms.explore").read(rec) == \
        pytest.approx(1e3 * 1.3 / 2)
