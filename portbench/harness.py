"""One run of one cell: inputs, window, metrics, the comparison, the result
line."""
from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import drive, gen
from .devtrace import busy_by_card, busy_s, device_ops, idle_gaps
from .judge import States, evaluate, free, verdict
from .serve_child import forbidden_modules
from .spec import Cell, load_metric

__all__ = ["run_cell", "report", "forbidden_modules"]


def _p90(xs) -> Optional[float]:
    if len(xs) < 2:
        return None
    return statistics.quantiles(xs, n=10, method="inclusive")[-1]


# the end-to-end metrics, from the run's record
E2E: Dict[str, Callable] = {
    "requests_per_s": lambda r: r["jobs"] / r["window_s"],
    "request_p90_ms": lambda r: (None if _p90(r["latencies"]) is None
                                 else 1e3 * _p90(r["latencies"])),
    "peak_device_gb": lambda r: r["peak_bytes"] / 1e9,
    "setup_s": lambda r: r["setup_s"],
}


def device_info(device: str, peaks: List[int]) -> dict:
    """The result line's ``device``: the cards measured, the fullest
    card's peak and each card's."""
    by_card = [int(p) for p in peaks] or [0]
    return {"platform": "gpu" if device == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device == "cuda"
            else "cpu",
            "count": len(by_card), "memory_peak_bytes": max(by_card),
            "memory_peak_bytes_by_card": by_card}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, setup_clock: Callable[[], float],
             sample: Optional[int] = None, keep: Optional[list] = None,
             control: bool = False) -> dict:
    """The result of one run (the result line's keys, ``checks`` last, and
    ``server_modules``).  ``device="cpu"`` runs the program's plain
    versions (tests); ``keep`` receives the run record for tests;
    ``control`` also reads the control on the same outputs
    (``control.py``)."""
    cfg, tr = cell.config, cell.traffic
    extra = ["device=cpu"] if device == "cpu" else []
    metrics = {m: load_metric(m) for m in cell.metric_names(True)} \
        if trace else {}
    hooks = [h for mod in metrics.values() for h in mod.HOOKS]
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    work = tempfile.mkdtemp(prefix="portbench-", dir=base)
    states = None
    try:
        plts = [os.path.join(work, "in", f"plt{m:02d}")
                for m in range(int(tr["plotfiles"]))]
        need = gen.input_bytes(cfg, len(plts))
        gen.check_room(need, work)
        t0 = time.perf_counter()
        h = gen.write_inputs(cfg, seed, plts, device)
        print(f"portbench: inputs {need} B of FAB records in {len(plts)} "
              f"plotfile(s), written in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)
        if device == "cuda":
            torch.cuda.empty_cache()
        if tr["kind"] == "series":
            rec = drive.series(tr, plts, work, seconds, hooks, trace, extra,
                               setup_clock)
        else:
            rec = drive.explore(tr, seed, plts[0], work, seconds, hooks,
                                trace, extra, setup_clock)
        rec["setup_s"] = rec["setup_end"]
        if keep is not None:
            keep.append(rec)
        out = {"correct": False, "attempted": rec["attempted"],
               "failed": rec["failed"]}
        vals = {}
        if trace:
            for name, mod in metrics.items():
                v = mod.read(rec)
                if v is not None:
                    vals[name] = v
        else:
            for name in cell.metric_names(False):
                v = E2E[name](rec)
                if v is not None:
                    vals[name] = v
        units = cell.units()
        out["metrics"] = {k: {"value": v, "unit": units[k]}
                          for k, v in vals.items()}
        out["device"] = device_info(device, rec["peak_by_card"])
        if trace and rec.get("trace"):
            t = rec["trace"]
            out["device"]["busy_s"] = busy_s(t)
            out["device"]["busy_s_by_card"] = busy_by_card(t)
            out["device"]["window_s"] = t["window"][1] - t["window"][0]
            out["breakdown"] = {"device_ops": device_ops(t),
                                "idle_gaps": idle_gaps(
                                    t, rec["hooks"]["spans"])}
        _timing(rec)
        # the comparison, once the window is closed and its peak read
        rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 5])
        picked = drive.sample(rec["done"], sample or int(tr["sample"]), rng)
        states = States(cfg, h, seed, device)
        nums, errors = evaluate(cfg, states, picked)
        for e in errors:
            print(f"portbench: {e}", file=sys.stderr)
        ok, checks = verdict(nums, tr["limits"], errors)
        out["correct"] = bool(ok and rec["failed"] == 0 and rec["jobs"] > 0)
        if control:
            out["control"] = evaluate(cfg, states, picked, control=True)[0]
        out["checks"] = checks
        out["server_modules"] = rec.get("server_modules", [])
        return out
    finally:
        free(states)
        shutil.rmtree(work, ignore_errors=True)


def _timing(rec: dict) -> None:
    """Seconds of the window's jobs by kind and member, on standard
    error (ahead of the numbers compared)."""
    by = {}
    for (job, _, _), d in zip(rec["done"], rec["durations"]):
        by.setdefault(f"{job.kind}.m{job.member}", []).append(d)
    for k, v in sorted(by.items()):
        v = sorted(v)
        print(f"timing {k} n={len(v)} median={statistics.median(v):.4f} "
              f"p90={v[int(0.9 * (len(v) - 1))]:.4f} max={v[-1]:.4f}",
              file=sys.stderr)


def _finite(v):
    """JSON has no inf or NaN: such a reading is printed as a string."""
    return v if v is None or np.isfinite(v) else repr(float(v))


def report(out: dict) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output."""
    out["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                     for k, c in out["checks"].items()}
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
