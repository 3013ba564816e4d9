"""``correct`` at a size the CPU holds: the program (its plain versions)
agrees with the reference, the control does not, and nor does a run with
a fault planted in the timed path."""
from __future__ import annotations

import os
import sys

import pytest

from conftest import ROOT, run_tiny
from portbench.judge import verdict

HERE = os.path.dirname(os.path.abspath(__file__))
CELLS = ["flame-series", "flame-explore"]
# float64 outputs agree to rounding; float32 statistics lose digits to
# cancellation in the deviations of nearly constant bins at this size
BOUNDS = {"mef_node_dist": 1e-9, "mef_field_gap": 1e-9, "mef_area_gap": 1e-9,
          "cm_gap": 2e-2, "jpdf_gap": 1e-5}


@pytest.mark.parametrize("workload", CELLS)
def test_program_agrees_with_reference(workload):
    out = run_tiny(workload)
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]
    for k, c in out["checks"].items():
        assert c["value"] <= BOUNDS[k], (k, c)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    out = run_tiny(workload, seconds=1.0, control=True)
    from portbench.spec import Cell, load_benchmark
    limits = Cell(load_benchmark(), workload).traffic["limits"]
    ok, checks = verdict(out["control"], limits, [])
    assert not ok, checks


FAULTS = [(w, f) for w in CELLS for f in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault, tmp_path, monkeypatch):
    spec = f"flame:{fault}"
    if workload == "flame-explore":
        # the server is a process of its own: the fault goes in at its start
        (tmp_path / "sitecustomize.py").write_text(
            f"import sys\nsys.path.insert(0, {HERE!r})\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import faults\nfaults.apply(%r)\n" % spec)
        monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep
                           + os.environ.get("PYTHONPATH", ""))
        out = run_tiny(workload, seconds=1.0)
    else:
        import faults
        faults.load()
        saved = {k: dict(vars(m)) for k, m in list(sys.modules.items())
                 if k.startswith("peleanalysis_tpu_torch")}
        faults.apply(spec)
        try:
            out = run_tiny(workload, seconds=1.0)
        finally:
            for k, d in saved.items():
                for a, v in d.items():
                    setattr(sys.modules[k], a, v)
    assert not out["correct"], (spec, out.get("checks"))
