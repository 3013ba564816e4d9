"""The measured window of each kind of cell.

``series``: the harness process runs ``cli.main(["pipeline", ...])`` once
a plotfile, the members in turn, each call with a new session (so every
job reads its plotfile again), until ``seconds`` have passed; the window
ends when the last job started in it has its outputs on disk.

``explore``: a ``serve`` process of the program's own (``serve_child``)
holds one session; one client sends the requests one after another through
the program's ``send_command(..., sync=True)`` until ``seconds`` have
passed.  Its window starts and ends with a signal, on which the server
resets and reads its peak device memory and, in a traced run, starts and
stops the profiler.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time
import traceback
from typing import List

import torch

from . import traffic as tg
from .hooks import Hooks, import_tools
from .spec import root
from .devtrace import Tracer


def cuda_sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _peak_reset() -> None:
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def _peak() -> int:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0


def _stage_tools(tr: dict) -> List[str]:
    if tr["kind"] == "series":
        return [st[0] for st in tr["stages"]]
    return [k["argv"][0] for k in tr["requests"]]


def run_job(argv: List[str], log) -> int:
    """One CLI call in this process, its output kept only on failure."""
    from peleanalysis_tpu_torch import cli
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            rc = cli.main(argv)
    except Exception:
        rc = 1
        buf.write(traceback.format_exc())
    if rc != 0:
        log.write(f"job failed (rc {rc}): {' '.join(argv)}\n"
                  f"{buf.getvalue()[-4000:]}\n")
    return rc


def series(tr: dict, plts: List[str], work: str, seconds: float,
           hooks: List[dict], trace: bool, extra, clock) -> dict:
    import_tools(_stage_tools(tr))
    for job in tg.series_warm(tr, plts, os.path.join(work, "warm"), extra):
        os.makedirs(job.out, exist_ok=True)
        if run_job(job.argv, sys.stderr) != 0:
            raise RuntimeError("a warm-up job failed")
    jobs = tg.series_jobs(tr, plts, os.path.join(work, "out"), extra)
    hk = Hooks(hooks).install() if trace else None
    tracer = Tracer() if trace else None
    cuda_sync()
    _peak_reset()
    setup_end = clock()
    t0 = tracer.start() if trace else time.perf_counter()
    done, dur = [], []
    try:
        while time.perf_counter() - t0 < seconds:
            job = next(jobs)
            os.makedirs(job.out, exist_ok=True)
            ts = time.perf_counter()
            rc = run_job(job.argv, sys.stderr)
            te = time.perf_counter()
            done.append((job, rc, te))
            dur.append(te - ts)
        cuda_sync()
        t1 = time.perf_counter()
        tr_rec = tracer.stop() if trace else None
    finally:
        if hk is not None:
            hk.uninstall()
    ok = sum(1 for _, rc, _ in done if rc == 0)
    return {"setup_end": setup_end, "window_s": t1 - t0,
            "attempted": len(done), "failed": len(done) - ok, "jobs": ok,
            "done": done, "durations": dur, "peak_bytes": _peak(),
            "trace": tr_rec,
            "hooks": hk.record() if hk else {"spans": {}, "calls": {}},
            "kinds": {"pipeline": ok}}


class Server:
    """The program's server in a child process of its own."""

    def __init__(self, work: str, hooks: List[dict], trace: bool):
        self.sock = os.path.join(work, "serve.sock")
        self.rec = os.path.join(work, "serve_record.json")
        self.log = open(os.path.join(work, "serve.log"), "w")
        spec = os.path.join(work, "serve_hooks.json")
        with open(spec, "w") as f:
            json.dump(hooks, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = root() + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.serve_child",
             "--socket", self.sock, "--record", self.rec,
             "--hooks", spec, "--trace", str(int(trace))],
            cwd=work, env=env, stdout=self.log, stderr=subprocess.STDOUT)
        from peleanalysis_tpu_torch.server import send_command
        self.send = send_command
        deadline = time.monotonic() + 300.0
        while True:
            if self.proc.poll() is not None:
                raise RuntimeError("the server exited "
                                   f"({self.proc.returncode}): {self.tail()}")
            try:
                if self.send(self.sock, cmd="ping", timeout=60.0)["rc"] == 0:
                    break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    def tail(self) -> str:
        self.log.flush()
        with open(self.log.name) as f:
            return f.read()[-4000:]

    def signal(self, sig) -> None:
        """A signal the server handles on its main thread before it
        answers the ping that follows."""
        self.proc.send_signal(sig)
        self.send(self.sock, cmd="ping", timeout=600.0)

    def close(self) -> dict:
        rec = {}
        try:
            if self.proc.poll() is None:
                self.send(self.sock, cmd="shutdown", timeout=600.0)
                self.proc.wait(timeout=120)
            with open(self.rec) as f:
                rec = json.load(f)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.log.close()
        return rec


def explore(tr: dict, seed: int, plt: str, work: str, seconds: float,
            hooks: List[dict], trace: bool, extra, clock) -> dict:
    srv = Server(work, hooks, trace)
    try:
        for job in tg.explore_warm(tr, plt, os.path.join(work, "warm"), extra):
            os.makedirs(job.out, exist_ok=True)
            rep = srv.send(srv.sock, argv=job.argv, sync=True, timeout=600.0)
            if rep["rc"] != 0:
                raise RuntimeError(f"a warm-up request failed: {rep['err']}")
        jobs = tg.explore_jobs(tr, seed, plt, os.path.join(work, "out"), extra)
        srv.signal(signal.SIGUSR1)
        setup_end = clock()
        done, lat = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            job = next(jobs)
            os.makedirs(job.out, exist_ok=True)
            ts = time.perf_counter()
            try:
                rep = srv.send(srv.sock, argv=job.argv, sync=True,
                               timeout=600.0)
                rc = int(rep.get("rc", 1))
                if rc != 0:
                    sys.stderr.write(f"request failed: {' '.join(job.argv)}\n"
                                     f"{rep.get('err', '')[-4000:]}\n")
            except OSError as e:
                rc = 1
                sys.stderr.write(f"request lost: {e}\n")
            te = time.perf_counter()
            lat.append(te - ts)
            done.append((job, rc, te))
        t1 = time.perf_counter()
        srv.signal(signal.SIGUSR2)
    finally:
        rec = srv.close()
    ok = [j for j, rc, _ in done if rc == 0]
    kinds = {k: sum(1 for j in ok if j.kind == k)
             for k in {j.kind for j in ok}}
    return {"setup_end": setup_end, "window_s": t1 - t0,
            "attempted": len(done), "failed": len(done) - len(ok),
            "jobs": len(ok), "done": done, "latencies": lat,
            "durations": lat,
            "peak_bytes": rec.get("peak_window", 0),
            "trace": rec.get("trace"),
            "hooks": rec.get("hooks", {"spans": {}, "calls": {}}),
            "kinds": kinds, "server_modules": rec.get("forbidden", [])}


def sample(done, n: int, rng) -> list:
    """Up to ``n`` finished jobs drawn by ``rng``, every member and kind
    among them where there are enough."""
    ok = [(j, t) for j, rc, t in done if rc == 0]
    groups = {}
    for j, _ in ok:
        groups.setdefault((j.member, j.kind), []).append(j)
    picked = []
    for key in sorted(groups):
        g = groups[key]
        picked.append(g[int(rng.integers(len(g)))])
    rest = [j for j, _ in ok if j not in picked]
    for i in rng.permutation(len(rest))[:max(0, n - len(picked))]:
        picked.append(rest[int(i)])
    return picked[:max(n, len(groups))]

