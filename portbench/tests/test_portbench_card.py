"""On the card: each cell at its committed size, a short window, correct
and with every metric of its kind.  Skips without a card."""
from __future__ import annotations

import time

import pytest

from portbench.harness import run_cell
from portbench.spec import Cell, load_benchmark


@pytest.mark.card
@pytest.mark.parametrize("workload", ["flame-series", "flame-explore"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_card(card, workload, trace):
    cell = Cell(load_benchmark(), workload)
    t0 = time.time()
    out = run_cell(cell, 2 ** 31 + 99, 3.0, trace, "cuda",
                   lambda: time.time() - t0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) <= set(cell.metric_names(trace))
    if trace:
        assert out["device"]["busy_s"] > 0
    else:
        assert set(out["metrics"]) == set(cell.metric_names(False))
