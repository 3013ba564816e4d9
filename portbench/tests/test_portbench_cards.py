"""A cell on several cards: the run sees exactly its cards, and the harness
synchronises, resets and reads every one of them, reports the fullest, and
reduces the trace card by card.  Cards are faked on the CPU by replacing
``torch.cuda``'s calls."""
from __future__ import annotations

import os
import sys

import pytest
import torch

from conftest import run_tiny
from portbench import cards, devtrace, gen, spec
from portbench.devtrace import (busy_by_card, busy_s, idle_gaps,
                                idle_gaps_by_card)
from portbench.harness import device_info
from portbench.serve_child import Window


class FakeCards:
    """``n`` cards whose calls are logged; card ``d``'s peak is
    ``peaks[d]``."""

    def __init__(self, monkeypatch, n: int):
        self.n, self.log = n, []
        self.peaks = [(d + 1) * 1000 + 7 * (d % 2) for d in range(n)]
        self.peaks[n // 2] = 10 ** 9   # the fullest is not the last
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda d=None: self.log.append(("sync", d)))
        monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                            lambda d=None: self.log.append(("reset", d)))
        monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                            self._peak)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None: f"card {d}")

    def _peak(self, d=None):
        self.log.append(("read", d))
        return self.peaks[d]

    def calls(self, what: str) -> list:
        return [d for w, d in self.log if w == what]


@pytest.mark.parametrize("n", [2, 4])
def test_each_card_synced_reset_and_read(monkeypatch, n):
    fake = FakeCards(monkeypatch, n)
    cards.sync()
    cards.reset_peaks()
    assert cards.peaks() == fake.peaks
    assert fake.calls("sync") == fake.calls("reset") == \
        fake.calls("read") == list(range(n))


@pytest.mark.parametrize("n", [2, 4])
def test_series_window_measures_every_card(monkeypatch, n):
    fake = FakeCards(monkeypatch, n)
    keep = []
    out = run_tiny("flame-series", seconds=1.0, keep=keep)
    assert out["correct"], out["checks"]
    # the window's start and end each synchronise every card; each card's
    # peak is reset at the start and read at the end
    assert fake.calls("sync") == list(range(n)) * 2
    assert fake.calls("reset") == fake.calls("read") == list(range(n))
    assert keep[0]["peak_by_card"] == fake.peaks
    assert keep[0]["peak_bytes"] == 10 ** 9
    assert out["metrics"]["peak_device_gb"]["value"] == 1.0
    dev = out["device"]
    assert dev["count"] == n
    assert dev["memory_peak_bytes"] == 10 ** 9
    assert dev["memory_peak_bytes_by_card"] == fake.peaks


@pytest.mark.parametrize("n", [2, 4])
def test_server_window_measures_every_card(monkeypatch, n):
    fake = FakeCards(monkeypatch, n)
    win = Window([], trace=False)
    win.start()
    assert fake.calls("sync") == fake.calls("reset") == list(range(n))
    win.stop()
    assert fake.calls("sync") == list(range(n)) * 2
    assert fake.calls("read") == list(range(n))
    assert win.state["peak_by_card"] == fake.peaks
    assert win.state["peak_window"] == 10 ** 9


def test_traced_window_syncs_every_card_and_counts_them(monkeypatch):
    fake = FakeCards(monkeypatch, 4)
    tr = devtrace.Tracer()
    tr.start()
    torch.ones(8).sum()
    t = tr.stop()
    assert fake.calls("sync") == list(range(4)) * 2
    assert t["cards"] == 4
    assert len(t["device_card"]) == len(t["device"])
    assert busy_by_card(t) == [0.0] * 4


def test_device_block():
    one = device_info("cpu", [])
    assert one == {"platform": "cpu", "kind": "cpu", "count": 1,
                   "memory_peak_bytes": 0, "memory_peak_bytes_by_card": [0]}
    d = device_info("cpu", [5, 9, 2])
    assert d["count"] == 3 and d["memory_peak_bytes"] == 9
    assert d["memory_peak_bytes_by_card"] == [5, 9, 2]


def test_device_block_names_card_zero(monkeypatch):
    FakeCards(monkeypatch, 4)
    d = device_info("cuda", [1, 2, 3, 4])
    assert d["platform"] == "gpu" and d["kind"] == "card 0"
    assert d["count"] == 4 and d["memory_peak_bytes"] == 4


def _two_card_trace():
    # window [0, 10].  Card 0: 1-3 (two overlapping kernels), 5-6.  Card 1:
    # 2-4 and 8-9.5, and card 2 ran nothing
    return {"window": [0.0, 10.0],
            "device": [["k_a", 1.0, 2.0], ["k_b", 1.5, 3.0],
                       ["k_c", 2.0, 4.0], ["Memcpy DtoH", 5.0, 6.0],
                       ["k_a", 8.0, 9.5]],
            "device_card": [0, 0, 1, 0, 1], "cards": 3, "ranges": []}


def test_per_card_busy_and_idle():
    t = _two_card_trace()
    assert busy_by_card(t) == pytest.approx([3.0, 3.5, 0.0])
    assert busy_s(t) == pytest.approx(6.5 / 3)
    idle = spec.load_metric("device_idle.series").read({"trace": t})
    assert idle == pytest.approx(100.0 * (1 - 6.5 / 30.0))
    spans = {"read": [[0.0, 5.0]]}
    per = [dict(g) for g in idle_gaps_by_card(t, spans)]
    # card 0 idle 0-1, 3-5 (read) and 6-10 (host); card 1 idle 0-2, 4-5
    # (read), 5-8 and 9.5-10 (host); card 2 idle throughout
    assert per[0] == pytest.approx({"read": 3.0, "host": 4.0})
    assert per[1] == pytest.approx({"read": 3.0, "host": 3.5})
    assert per[2] == pytest.approx({"read": 5.0, "host": 5.0})
    assert dict(idle_gaps(t, spans)) == pytest.approx(
        {"read": 11.0, "host": 12.5})


def test_one_card_gives_the_single_card_numbers():
    """A trace of one card reads the same with and without card indices,
    and the per-card reductions are the totals."""
    from test_portbench_metrics import _trace
    spans = {"stage.isosurface": [[3.2, 5.0]], "read": [[6.0, 9.5]]}
    t = _trace()
    t1 = dict(t, device_card=[0] * len(t["device"]), cards=1)
    for x in (t, t1):
        assert busy_by_card(x) == [busy_s(x)] == [busy_s(t)]
        assert busy_s(x) == pytest.approx(3.5)
        assert idle_gaps_by_card(x, spans) == [idle_gaps(t, spans)]
    assert idle_gaps(t1, spans) == idle_gaps(t, spans)


@pytest.fixture
def run_env(monkeypatch):
    """``run.main`` sets variables and ``sys.path``: put them back."""
    for var in ("CUDA_VISIBLE_DEVICES", "TRITON_CACHE_DIR",
                "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH", "USE_FLAX",
                "USE_JAX", "OMP_NUM_THREADS"):
        # recorded as it is, so that teardown restores it, also unset
        was = os.environ.get(var)
        monkeypatch.setenv(var, "")
        if was is None:
            monkeypatch.delenv(var)
        else:
            monkeypatch.setenv(var, was)
    monkeypatch.setattr(sys, "path", list(sys.path))
    return monkeypatch


@pytest.mark.parametrize("visible,chips,want", [
    (None, 1, "0"), (None, 4, "0,1,2,3"), ("3,5,7", 2, "3,5"),
    ("GPU-a, GPU-b", 1, "GPU-a"), ("1", 4, "1"), ("", 1, "")])
def test_run_sees_the_cells_cards(run_env, visible, chips, want):
    from portbench.run import narrow_cards
    if visible is None:
        run_env.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        run_env.setenv("CUDA_VISIBLE_DEVICES", visible)
    narrow_cards(chips)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == want


@pytest.mark.parametrize("seen", [0, 3])
def test_run_with_fewer_cards_than_the_cell_exits_3(run_env, capsys, seen):
    from portbench import run
    run_env.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        w["chips"] = 4
    run_env.setattr(spec, "load_benchmark", lambda path=None: bench)
    run_env.setattr(torch.cuda, "is_available", lambda: seen > 0)
    run_env.setattr(torch.cuda, "device_count", lambda: seen)
    rc = run.main(["--workload", "flame-series", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 3
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,1,2,3"
    cap = capsys.readouterr()
    assert cap.out == "" and "needs 4 CUDA card(s)" in cap.err


def test_no_room_for_the_inputs(monkeypatch, tmp_path, capsys):
    """Inputs that do not fit under ``TMPDIR`` stop the run before any is
    written, with both numbers; a run that fits says what it wrote."""
    from conftest import tiny_cell
    need = gen.input_bytes(tiny_cell("flame-series").config, 1)
    usage = type("U", (), {"free": need - 1})
    monkeypatch.setattr(gen.shutil, "disk_usage", lambda p: usage)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    with pytest.raises(gen.NoRoom, match=f"need {need} B .* {need - 1} B"):
        run_tiny("flame-series", seconds=0.5)
    assert os.listdir(tmp_path) == []
    usage.free = need
    out = run_tiny("flame-series", seconds=0.5)
    assert out["correct"]
    assert f"portbench: inputs {need} B of FAB records in 1 plotfile(s), " \
        "written in " in capsys.readouterr().err

