"""BENCHMARK.json and the files it names: the contract's shapes and
characters, and a cell added as files alone."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import spec
from portbench.spec import Cell, load_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$")


def test_benchmark_keys_and_names():
    b = load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["portbench"]
    assert all(LINE.match(w) for w in b["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
        assert LINE.match(c["why"]) and LINE.match(c["source"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and LINE.match(m["layer"])
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(spec.HERE, "metrics",
                                           m["name"] + ".py"))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("workload", ["flame-series", "flame-explore"])
def test_every_cell_reports_what_it_must(workload):
    b = load_benchmark()
    c = Cell(b, workload)
    e2e = c.metric_names(False)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert hasattr(spec.load_metric(m["name"]), "read")
    cfg = c.config
    assert cfg["name"] == c.entry["config"]
    entry = next(x for x in b["configs"] if x["name"] == cfg["name"])
    assert entry["reduced"] == cfg["reduced"]
    for check in (c.traffic.get("checks", []) + [
            ch for k in c.traffic.get("requests", [])
            for ch in k.get("checks", [])]):
        assert check["tool"] in cfg["precision"]


def test_config_and_traffic_files_parse():
    for kind in ("configs", "traffic"):
        d = os.path.join(spec.HERE, kind)
        for f in os.listdir(d):
            assert NAME.match(f[:-5]) and f.endswith(".json")
            with open(os.path.join(d, f)) as fh:
                obj = json.load(fh)
            assert obj["name"] == f[:-5]


def test_new_cell_from_files_alone(tmp_path, monkeypatch):
    """A traffic file and a BENCHMARK.json entry are all a new cell takes."""
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__"))
    tr = json.loads((here / "traffic" / "flame-series.json").read_text())
    tr["name"] = "flame-series-k3"
    tr["plotfiles"] = 3
    (here / "traffic" / "flame-series-k3.json").write_text(json.dumps(tr))
    b = load_benchmark()
    b["workloads"].append({"name": "flame-series-k3", "config": "flamesheet3d",
                           "traffic": "flame-series-k3", "chips": 1,
                           "why": "three members"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "flame-series" in m.get("workloads", []):
            m["workloads"].append("flame-series-k3")
    monkeypatch.setattr(spec, "HERE", str(here))
    c = Cell(b, "flame-series-k3")
    assert c.traffic["plotfiles"] == 3
    assert "peak_device_gb" in c.metric_names(False)
    assert "plotfile_s.series" in c.metric_names(True)
    assert "grad_mag_roofline" in c.metric_names(True)


def test_new_kind_and_check_from_files_alone(tmp_path, monkeypatch):
    """A configuration of a new kind, checked by a new type of check, runs
    from files of their own: ``kinds/<kind>.py``, ``checks/<type>.py``,
    the configuration, the traffic mix and the entries."""
    from conftest import TINY
    from portbench.harness import run_cell
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__"))
    (here / "kinds" / "sheet_twin.py").write_text(
        "from portbench.kinds.flame_sheet import level_fields, State\n")
    (here / "checks" / "cm_twin.py").write_text(
        "from portbench.checks.cm import program, reference\n"
        "from portbench.checks.cm import numbers as _numbers\n\n\n"
        "def numbers(p, r, st):\n"
        "    return {'cm_twin_gap': _numbers(p, r, st)['cm_gap']}\n")
    cfg = json.loads((here / "configs" / "flamesheet3d.json").read_text())
    cfg.update(TINY["flamesheet3d"], name="twin", kind="sheet_twin")
    (here / "configs" / "twin.json").write_text(json.dumps(cfg))
    tr = json.loads((here / "traffic" / "flame-series.json").read_text())
    tr.update(name="twin-series", stages=tr["stages"][2:3],
              checks=[dict(tr["checks"][1], type="cm_twin")],
              limits={"cm_twin_gap": 0.01})
    (here / "traffic" / "twin-series.json").write_text(json.dumps(tr))
    b = load_benchmark()
    b["configs"].append({"name": "twin", "source": "a test",
                         "file": "portbench/configs/twin.json",
                         "reduced": cfg["reduced"], "why": "a test"})
    b["workloads"].append({"name": "twin-series", "config": "twin",
                           "traffic": "twin-series", "chips": 1,
                           "why": "a test"})
    monkeypatch.setattr(spec, "HERE", str(here))
    import time
    t0 = time.time()
    out = run_cell(Cell(b, "twin-series"), 5, 0.5, False, "cpu",
                   lambda: time.time() - t0)
    assert out["correct"] and set(out["checks"]) == {"cm_twin_gap"}
    assert set(out["metrics"]) == {"peak_device_gb", "setup_s"}
