"""The one generator of every traffic mix: a traffic file's parameters in,
the jobs of a run out, the same for the same seed.

``"kind": "series"``: a time series of ``plotfiles`` members, one job a
plotfile, taken in turn; a job is one ``pipeline`` of ``stages``.
``"kind": "explore"``: one resident plotfile and a closed loop of
requests, each one command of a ``requests`` kind.  The requests come in
decks of ``deck`` that hold every kind in proportion to its ``weight``,
each parameter stratified over its range (``uniform``) or cycled through
its values (``choice``) within the deck, shuffled by the seed: every seed
gives the same work in another order.

Argv and check strings take ``{plt}`` (the member's path), ``{pltname}``
(its last component), ``{out}`` (the job's output directory), ``{step}``
and the request's parameters.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np


def fill(obj, subs: dict):
    """``obj`` with every ``{name}`` of ``subs`` substituted in its
    strings (lists and dicts walked)."""
    if isinstance(obj, str):
        for k, v in subs.items():
            obj = obj.replace("{" + k + "}", str(v))
        return obj
    if isinstance(obj, list):
        return [fill(x, subs) for x in obj]
    if isinstance(obj, dict):
        return {k: fill(v, subs) for k, v in obj.items()}
    return obj


class Job:
    """One pipeline (series) or one request (explore)."""

    def __init__(self, index: int, member: int, kind: str, argv: List[str],
                 checks: List[dict], out: str):
        self.index, self.member, self.kind = index, member, kind
        self.argv, self.checks, self.out = argv, checks, out


def _subs(plt: str, out: str, step, params: dict) -> dict:
    return {"plt": plt, "pltname": os.path.basename(plt), "out": out,
            "step": step, **params}


def _pipeline_argv(stages: List[List[str]], extra=()) -> List[str]:
    argv = ["pipeline"]
    for st in stages:
        argv += list(st) + list(extra) + ["--"]
    return argv[:-1]


def series_jobs(tr: dict, plts: List[str], outdir: str,
                extra=()) -> Iterator[Job]:
    i = 0
    while True:
        m = i % len(plts)
        out = os.path.join(outdir, f"s{i:05d}")
        s = _subs(plts[m], out, i, {})
        yield Job(i, m, "pipeline",
                  fill(_pipeline_argv(tr["stages"], extra), s),
                  fill(tr["checks"], s), out)
        i += 1


def series_warm(tr: dict, plts: List[str], outdir: str,
                extra=()) -> List[Job]:
    """One job a member, into ``outdir``."""
    jobs = []
    for m, p in enumerate(plts):
        out = os.path.join(outdir, f"w{m}")
        s = _subs(p, out, f"w{m}", {})
        jobs.append(Job(-1 - m, m, "pipeline",
                        fill(_pipeline_argv(tr["stages"], extra), s), [], out))
    return jobs


def _deck(tr: dict, rng: np.random.Generator) -> List[tuple]:
    n = int(tr["deck"])
    kinds = tr["requests"]
    w = np.array([k["weight"] for k in kinds], float)
    counts = np.floor(w / w.sum() * n + 1e-9).astype(int)
    counts[np.argmax(w)] += n - counts.sum()
    deck = []
    for ki, (kind, c) in enumerate(zip(kinds, counts)):
        vals: Dict[str, list] = {}
        for name, p in kind.get("params", {}).items():
            if "uniform" in p:
                lo, hi = p["uniform"]
                u = (rng.permutation(c) + rng.uniform(size=c)) / max(c, 1)
                vals[name] = [float(np.round(lo + (hi - lo) * x, 6))
                              for x in u]
            else:
                ch = p["choice"]
                vals[name] = [ch[j % len(ch)] for j in rng.permutation(c)]
        deck += [(ki, {k: v[j] for k, v in vals.items()}) for j in range(c)]
    return [deck[j] for j in rng.permutation(len(deck))]


def explore_jobs(tr: dict, seed: int, plt: str, outdir: str,
                 extra=()) -> Iterator[Job]:
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 77])
    i = 0
    while True:
        for ki, params in _deck(tr, rng):
            kind = tr["requests"][ki]
            out = os.path.join(outdir, f"r{i:05d}")
            s = _subs(plt, out, i, params)
            yield Job(i, 0, kind["name"],
                      fill(kind["argv"] + list(extra), s),
                      fill(kind.get("checks", []), s), out)
            i += 1


def explore_warm(tr: dict, plt: str, outdir: str,
                 extra=()) -> List[Job]:
    """Each kind once for each of its ``warm`` parameter sets."""
    jobs = []
    for kind in tr["requests"]:
        for j, params in enumerate(kind.get("warm", [{}])):
            out = os.path.join(outdir, f"w_{kind['name']}_{j}")
            s = _subs(plt, out, f"w{j}", params)
            jobs.append(Job(-1, 0, kind["name"],
                            fill(kind["argv"] + list(extra), s), [], out))
    return jobs
