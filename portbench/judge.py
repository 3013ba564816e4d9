"""The comparison of a run's sampled outputs with the reference, and of the
control with the reference: the widest reading of each number over the
outputs compared."""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import torch

from .reference import DTYPES, LOWER
from .spec import load_check, load_kind


class States:
    """Reference states of a run, built when first needed: by member and
    dtype."""

    def __init__(self, cfg: dict, h, seed: int, device):
        self.cfg, self.h, self.seed, self.device = cfg, h, seed, device
        self._st = {}

    def get(self, member: int, dtype: torch.dtype):
        key = (member, dtype)
        if key not in self._st:
            self._st[key] = load_kind(self.cfg["kind"]).State(
                self.cfg, self.h, self.seed, member, self.device, dtype)
        return self._st[key]


def control_dtype(cfg: dict, spec: dict) -> torch.dtype:
    """The nearest precision below the one the configuration states for
    the check's tool."""
    return DTYPES[LOWER[cfg["precision"][spec["tool"]]]]


def evaluate(cfg: dict, states: States, jobs, control: bool = False
             ) -> (Dict[str, float], List[str]):
    """Numbers (each the widest over the jobs' checks) and the errors of
    outputs that could not be read.  ``control``: the reference in the
    nearest precision below the configuration's stands in the program's
    place."""
    nums: Dict[str, float] = {}
    errors: List[str] = []
    cache = {}
    for job in jobs:
        for spec in job.checks:
            kind = load_check(spec["type"])
            ref_key = (job.member, json.dumps(
                {k: v for k, v in spec.items() if "file" not in k},
                sort_keys=True))
            st = states.get(job.member, torch.float64)
            if ref_key not in cache:
                cache[ref_key] = kind.reference(spec, st)
            try:
                if control:
                    low = states.get(job.member, control_dtype(cfg, spec))
                    p = kind.reference(spec, low)
                else:
                    p = kind.program(spec, cfg)
            except (OSError, ValueError) as e:
                errors.append(f"{spec['type']} of job {job.index}: {e}")
                continue
            for k, v in kind.numbers(p, cache[ref_key], st).items():
                v = float(v) if v == v else float("inf")   # NaN fails
                nums[k] = max(nums.get(k, float("-inf")), v)
    return nums, errors


def verdict(nums: Dict[str, float], limits: Dict[str, float],
            errors: List[str]) -> (bool, Dict[str, dict]):
    """``correct`` and each number beside its limit: no output unread, at
    least one number, and each within a limit of its own."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in sorted(nums.items())}
    ok = not errors and bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks


def free(states: Optional[States]) -> None:
    if states is not None:
        states._st.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
