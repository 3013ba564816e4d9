"""The four-card flame cell (``flame3d-4card``) at a size the CPU holds:
the slab reference equals the whole-level reference, the tiny cell is
``correct`` through the harness with ``ndevices=4`` on the CPU, the control
and planted faults are not, the full configuration's input bytes, and the
new readers on synthetic records."""
from __future__ import annotations

import copy
import sys
import time

import numpy as np
import pytest
import torch

from conftest import SEED, TINY
from portbench import gen
from portbench.amr import fab_header
from portbench.judge import verdict
from portbench.reference import flame, flame_slabs
from portbench.spec import Cell, load_benchmark, load_kind, load_metric

CELL = "flame3d-4card"
EXTRAS = ["MeanCurvature_temp", "GaussianCurvature_temp", "density"]
# float64 outputs agree to rounding
BOUNDS = {"mef_node_dist": 1e-9, "mef_field_gap": 1e-9, "mef_area_gap": 1e-9}


def tiny_cell() -> Cell:
    """The cell with its configuration cut to flamesheet3d's CPU size."""
    c = Cell(load_benchmark(), CELL)
    c.config = copy.deepcopy(c.config)
    c.config.update(TINY["flamesheet3d"])
    return c


def run_tiny(seconds: float = 1.0, **kw) -> dict:
    from portbench.harness import run_cell
    t0 = time.time()
    return run_cell(tiny_cell(), SEED, seconds, False, "cpu",
                    lambda: time.time() - t0, **kw)


def state(cfg, dtype=torch.float64):
    h = gen.hierarchy(cfg)
    return load_kind(cfg["kind"]).State(cfg, h, SEED, 0, "cpu", dtype)


@pytest.fixture(scope="module")
def whole():
    cfg = tiny_cell().config
    return cfg, flame.isosurface(state(cfg), "temp", 1000.0, EXTRAS)


@pytest.mark.parametrize("slab", [1, 3, 5])
def test_slabs_equal_the_whole_level(whole, slab):
    """Slabs of 1 and 3 rows divide the tiny finest level's 24; 5 does
    not."""
    from scipy.spatial import cKDTree
    cfg, ref = whole
    st = state(cfg)
    assert st.levels[-1]["temp"].shape[2] % 5 != 0
    got = flame_slabs.isosurface(st, "temp", 1000.0, EXTRAS, slab=slab)
    a, b = ref["nodes"], got["nodes"]
    assert a.shape == b.shape and len(a) > 100
    dx = st.h.dx(st.h.n_levels - 1)
    d_ab, i_ab = cKDTree(b[:, :3]).query(a[:, :3])
    d_ba, _ = cKDTree(a[:, :3]).query(b[:, :3])
    assert max(d_ab.max(), d_ba.max()) / dx <= 1e-14
    np.testing.assert_array_equal(a[:, 3:], b[i_ab, 3:])
    assert abs(got["area"] - ref["area"]) / ref["area"] <= 1e-14


def test_slabs_default_height_fits_the_level():
    st = state(tiny_cell().config)
    assert flame_slabs.slab_height(st) >= 1


def test_tiny_cell_is_correct_on_four_shards():
    out = run_tiny(seconds=1.5)
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == set(BOUNDS)
    for k, c in out["checks"].items():
        assert c["value"] <= BOUNDS[k], (k, c)
    assert out["correct"]


def test_control_is_not_correct():
    out = run_tiny(control=True)
    ok, checks = verdict(out["control"], tiny_cell().traffic["limits"], [])
    assert not ok, checks


def _drop_second_shard():
    """``unchanged``: the second window's output is never gathered, so the
    gathered curvature keeps its zeros there."""
    from peleanalysis_tpu_torch.parallel import dense_shard
    orig = dense_shard.ShardGather.add

    def add(self, s, out):
        if s != 1:
            orig(self, s, out)
    return dense_shard.ShardGather, "add", add


def _half_windows():
    """``half``: the isosurface merges every other window's triangles."""
    from peleanalysis_tpu_torch.geom import marching_cubes as mc
    orig = mc._merge_runs

    def merge(results, label=None, cells=None):
        keep = range(0, len(results), 2)
        return orig([results[i] for i in keep], label,
                    None if cells is None else [cells[i] for i in keep])
    return mc, "_merge_runs", merge


PLANTED = {"unchanged": _drop_second_shard, "half": _half_windows}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    if fault == "altered":
        import faults
        faults.load()
        saved = {k: dict(vars(m)) for k, m in list(sys.modules.items())
                 if k.startswith("peleanalysis_tpu_torch")}
        faults.apply("flame:altered")
        try:
            out = run_tiny()
        finally:
            for k, d in saved.items():
                for a, v in d.items():
                    setattr(sys.modules[k], a, v)
    else:
        monkeypatch.setattr(*PLANTED[fault]())
        out = run_tiny()
    assert not out["correct"], (fault, out.get("checks"))


def test_full_input_bytes():
    cfg = Cell(load_benchmark(), CELL).config
    h = gen.hierarchy(cfg)
    assert h.cells() == 283_115_520 == cfg["cells"]
    heads = sum(len(fab_header(b, 2)) for bs in h.boxes for b in bs)
    assert gen.input_bytes(cfg, 1) == 283_115_520 * 2 * 8 + heads \
        == cfg["input_bytes"]


# -- the readers on synthetic records ----------------------------------------
def _trace(events):
    """A traced window of 10 s over ``(card, start, end)`` device events."""
    return {"window": [0.0, 10.0], "cards": 4,
            "device": [["k", s, t] for _, s, t in events],
            "device_card": [c for c, _, _ in events]}


@pytest.mark.parametrize("events,want", [
    ([(0, 0.0, 2.0), (1, 2.0, 4.0)], 1.0),             # in turn
    ([(0, 0.0, 2.0), (1, 0.0, 2.0)], 2.0),             # at once
    ([(0, 0.0, 2.0), (1, 1.0, 3.0)], 4.0 / 3.0)])       # half overlap
def test_card_overlap(events, want):
    got = load_metric("card_overlap.4card").read({"trace": _trace(events)})
    assert got == pytest.approx(want)


def test_device_idle_is_of_the_cards_mean():
    rec = {"trace": _trace([(0, 0.0, 2.0), (1, 0.0, 2.0)])}
    # 4 s busy of 4 cards x 10 s
    assert load_metric("device_idle.4card").read(rec) == pytest.approx(90.0)


def _program(spans=(), counters=None, jobs=2):
    keys = ("name", "start", "end", "id", "parent", "request", "thread")
    tel = {"spans": [dict(zip(keys, (n, s, t, i + 1, 0, 1, "main")))
                     for i, (n, s, t) in enumerate(spans)],
           "counters": counters or {}, "dropped": 0}
    return {"jobs": jobs, "hooks": {"spans": {}, "calls": {"program": [tel]}}}


def test_halo_share():
    rec = _program(counters={"shard.window_cells": 150,
                             "shard.owned_cells": 100})
    assert load_metric("halo_share.4card").read(rec) == pytest.approx(50.0)


def test_span_readers():
    rec = _program([("shard.assemble", 0.0, 1.0), ("shard.h2d", 0.5, 1.5),
                    ("shard.gather", 2.0, 3.0), ("shard.merge", 4.0, 4.5),
                    ("shard.run", 1.0, 2.0)])
    assert load_metric("shard_assemble_s.4card").read(rec) == \
        pytest.approx(0.75)
    assert load_metric("shard_gather_s.4card").read(rec) == \
        pytest.approx(0.75)


@pytest.mark.parametrize("name", ["shard_assemble_s.4card",
                                  "shard_gather_s.4card",
                                  "halo_share.4card"])
def test_readers_of_a_program_without_shard_telemetry(name):
    """A program without these spans and counters (an older checkout)
    reads as nothing, without raising."""
    rec = _program([("tool.curvature", 0.0, 1.0)],
                   counters={"read.bytes": 10})
    assert load_metric(name).read(rec) is None
    assert load_metric(name).read({"jobs": 1, "hooks": {}}) is None
