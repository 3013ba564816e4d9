"""The device trace of a traced window, and its reduction.

``Tracer`` runs ``torch.profiler`` (CUPTI on the card) over the window and
keeps the device's own events (kernels, copies, memsets) and the
program's ``isosurface.<stage>`` ranges, moved onto this process's
``time.perf_counter`` clock by a mark taken on the main thread at the
window's start.  The reduction gives the busy time (the union of the
device intervals), the device operations that took most time and the
idle gaps by what the host was doing.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

MARK = "portbench.window"


class Tracer:
    def __init__(self):
        self.prof = None

    def start(self) -> float:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        with torch.profiler.record_function(MARK):
            self.t0 = time.perf_counter()
        return self.t0

    def stop(self) -> dict:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.prof.stop()
        evs = list(self.prof.profiler.kineto_results.events())
        marks = [e.start_ns() for e in evs if e.name() == MARK]
        off = marks[0] / 1e9 - self.t0 if marks else None
        cuda = torch.autograd.DeviceType.CUDA
        # a host range (record_function) is mirrored on the device's
        # timeline: only the device's own operations count
        host_names = {e.name() for e in evs if e.device_type() != cuda}
        device, ranges = [], []
        for e in evs:
            if off is None:
                break
            s = e.start_ns() / 1e9 - off
            t = s + e.duration_ns() / 1e9
            if e.device_type() == cuda:
                if e.name() not in host_names:
                    device.append([e.name(), s, t])
            elif e.name().startswith("isosurface."):
                ranges.append([e.name(), s, t])
        self.prof = None
        return {"window": [self.t0, t1], "device": device, "ranges": ranges,
                "aligned": off is not None}


def union(intervals: List[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    """The merged intervals, clipped to [lo, hi]."""
    out = []
    for s, t in sorted((max(s, lo), min(t, hi)) for s, t in intervals):
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def busy_s(tr: dict) -> float:
    lo, hi = tr["window"]
    return sum(t - s for s, t in union([(s, t) for _, s, t in tr["device"]],
                                       lo, hi))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def device_ops(tr: dict, n: int = 10) -> List[list]:
    """The device operations by total seconds in the window."""
    lo, hi = tr["window"]
    tot: Dict[str, float] = {}
    for name, s, t in tr["device"]:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            key = name if len(name) <= 120 else name[:117] + "..."
            tot[key] = tot.get(key, 0.0) + (t - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: dict, spans: Dict[str, List[List[float]]],
              n: int = 10) -> List[list]:
    """Idle seconds of the device in the window, by what the host was
    doing: each stretch of idle time goes to the innermost host span (a
    stage, a read, a write, an isosurface range) covering it, ``host``
    where none does."""
    lo, hi = tr["window"]
    busy = union([(s, t) for _, s, t in tr["device"]], lo, hi)
    gaps, prev = [], lo
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if hi > prev:
        gaps.append((prev, hi))
    labelled = [(name, s, t) for name, ivs in spans.items() for s, t in ivs]
    labelled += [(name, s, t) for name, s, t in tr.get("ranges", [])]
    starts = np.array([x[1] for x in labelled])
    ends = np.array([x[2] for x in labelled])
    tot: Dict[str, float] = {}
    for s, t in gaps:
        cover = [labelled[i] for i in np.nonzero((starts < t) & (ends > s))[0]]
        cuts = sorted({s, t} | {c for _, a, b in cover for c in (a, b)
                                if s < c < t})
        for a, b in zip(cuts[:-1], cuts[1:]):
            mid = 0.5 * (a + b)
            inner = [x for x in cover if x[1] <= mid <= x[2]]
            key = min(inner, key=lambda x: x[2] - x[1])[0] if inner \
                else "host"
            tot[key] = tot.get(key, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
