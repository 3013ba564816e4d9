"""Fixtures of the benchmark's tests: cells cut to a size the CPU runs in
seconds (the generators, the references and the program's plain versions
at full widths of everything but the grid), and the card marker.

Run: ``python -m pytest portbench/tests`` from the checkout's root; the
tests marked ``card`` run only where ``torch.cuda.is_available()``."""
from __future__ import annotations

import copy
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.spec import Cell, load_benchmark  # noqa: E402

TINY = {
    "flamesheet3d": {
        "amr.n_cell": [8, 8, 16], "amr.blocking_factor": 4,
        "amr.max_grid_size": 8, "front_thickness": 0.0012,
        "prob.pertmag": 0.0004,
        "refined": [[[[0.0, 0.0, 0.008], [0.016, 0.016, 0.024]]],
                    [[[0.0, 0.0, 0.010], [0.016, 0.016, 0.022]]]]},
}
SEED = 2 ** 31 + 17


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")


def tiny_cell(workload: str) -> Cell:
    """The workload with its configuration cut to the CPU test size."""
    c = Cell(load_benchmark(), workload)
    c.config = copy.deepcopy(c.config)
    c.config.update(TINY[c.config["name"]])
    return c


def run_tiny(workload: str, seed: int = SEED, seconds: float = 1.5,
             trace: bool = False, **kw) -> dict:
    from portbench.harness import run_cell
    t0 = time.time()
    return run_cell(tiny_cell(workload), seed, seconds, trace, "cpu",
                    lambda: time.time() - t0, **kw)
