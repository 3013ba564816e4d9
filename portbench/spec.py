"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json`` and a per-layer metric ``metrics/<name>.py``; a
configuration's ``kind`` is ``kinds/<kind>.py`` and a check's ``type``
``checks/<type>.py``, all under this directory.  A later change adds a
cell, a configuration, a kind of deployment, a check or a metric as files
of its own and entries in ``BENCHMARK.json``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def root() -> str:
    """The checkout: the directory that holds ``BENCHMARK.json`` and this
    one."""
    return os.path.dirname(HERE)


def load_benchmark(path: str = None) -> dict:
    with open(path or os.path.join(root(), "BENCHMARK.json")) as f:
        return json.load(f)


def _named(kind: str, name: str, ext: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return os.path.join(HERE, kind, name + ext)


def load_config(name: str) -> dict:
    with open(_named("configs", name, ".json")) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(_named("traffic", name, ".json")) as f:
        return json.load(f)


def _module(kind: str, name: str):
    """``portbench.<kind>.<name>``: the module of a configuration's kind
    or of a check's type, by the name a file gives it."""
    if not name.isidentifier():
        raise ValueError(f"bad {kind} name {name!r}")
    full = f"portbench.{kind}.{name}"
    path = os.path.join(HERE, kind, name + ".py")
    mod = sys.modules.get(full)
    if mod is None or os.path.abspath(mod.__file__) != path:
        spec = importlib.util.spec_from_file_location(full, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        spec.loader.exec_module(mod)
    return mod


def load_kind(name: str):
    """``kinds/<name>.py``: ``level_fields`` and ``State`` of a kind of
    deployment."""
    return _module("kinds", name)


def load_check(name: str):
    """``checks/<name>.py``: ``program``, ``reference`` and ``numbers`` of
    a type of output."""
    return _module("checks", name)


def load_metric(name: str):
    """The reader module of a per-layer metric: ``HOOKS`` (what the traced
    run records for it) and ``read(record) -> float | None``."""
    path = _named("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and metrics."""

    def __init__(self, bench: dict, workload: str):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(by_name)})")
        self.entry = by_name[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        self.config = load_config(self.entry["config"])
        self.traffic = load_traffic(self.entry["traffic"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if self._reports(m)]

    def _reports(self, m: dict) -> bool:
        if "workloads" in m:
            return self.name in m["workloads"]
        return any(e["name"] == m["moves"] for e in self.end_to_end)

    def metric_names(self, trace: bool) -> List[str]:
        return [m["name"] for m in (self.per_layer if trace
                                    else self.end_to_end)]

    def units(self) -> Dict[str, str]:
        return {m["name"]: m["unit"] for m in self.end_to_end + self.per_layer}
