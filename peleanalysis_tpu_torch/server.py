"""Persistent tool server: one process, one Session, one CUDA context.

Counterpart of ``peleanalysis_tpu/server.py``.  A reference tool is an
ahead-of-time compiled binary; a Python CLI pays interpreter start, the
torch import, CUDA context creation, the kernels' first load and the
plotfile read on every invocation.  ``python -m peleanalysis_tpu_torch
serve`` keeps one process with its CUDA context, the loaded kernels and a
shared :class:`~peleanalysis_tpu_torch.session.Session` (cached plotfile
loads, device states, registered outputs) across commands.

Protocol (newline-delimited JSON over a unix socket):

  request   {"argv": ["grad", "infile=plt", ...]}     run one CLI command
            {"argv": [...], "sync": true}              ... and settle the
                                                       session's write-backs
                                                       before replying
            {"cmd": "ping"}                            liveness probe
            {"cmd": "flush"}                           settle ALL pending
                                                       write-backs
            {"cmd": "reset"}                           drop the Session's
                                                       states and outputs
            {"cmd": "shutdown"}                        reply, then exit
  reply     {"rc": int, "out": str, "err": str}

Writes are asynchronous by default: a reply can arrive while its plotfile
is still being written (the write overlaps the next command; a later
command whose argv names the path settles it first).  A client that needs
the files on reply sends ``sync: true`` (the ``send`` client does) or
``flush``.

Commands run through the one-shot CLI's code path (``cli.main`` with the
session), one after another in the server's one CUDA context, so keys and
outputs are the CLI's.  Each command takes its own ``device=``; the server
itself picks no device.  A failing command (an exception, or
``SystemExit`` with any code) replies rc 1 with its traceback and leaves
the server running; a failure on the card is not retried on the CPU.
``send_command()`` is the Python client and ``python -m
peleanalysis_tpu_torch send socket=S <tool> k=v ...`` the CLI client."""
from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import sys
import traceback

from .telemetry import count, request, span

DEFAULT_SOCKET = "pele_serve.sock"


def _recv_lines(conn):
    buf = b""
    while True:
        try:
            chunk = conn.recv(1 << 16)
        except socket.timeout:
            # a client connected but stalled mid-request must not wedge the
            # single accept loop: drop it and serve the next one (clients
            # open one connection a command)
            return
        if not chunk:
            return
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                yield line


def serve(args: dict) -> int:
    """CLI: serve [socket=pele_serve.sock] [verbose=0] [max_requests=0
    (unlimited)] [idle_timeout=120: seconds before an idle or stalled
    CONNECTION is dropped; commands themselves are unbounded; 0 disables]"""
    from .parmparse import ParmParse
    from .session import Session

    pp = ParmParse(args)
    path = pp.query_str("socket", DEFAULT_SOCKET)
    verbose = pp.query_bool("verbose", False)
    max_requests = pp.query_int("max_requests", 0)
    idle_timeout = pp.query_float("idle_timeout", 120.0)
    if os.path.exists(path):
        os.unlink(path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(8)
    sess = Session(async_writes=True)
    print(f"serving on {path}", flush=True)
    n_req = 0
    try:
        while True:
            conn, _ = srv.accept()
            try:
                rc_done, n_req = _serve_conn(conn, sess, idle_timeout,
                                             verbose, max_requests, n_req)
            except OSError as e:
                # a client that vanished mid-request must not take the
                # server's session down with it
                print(f"server: client connection dropped ({e}); "
                      "keeping the session", flush=True)
                continue
            if rc_done is not None:
                return rc_done
    finally:
        with contextlib.suppress(Exception):
            sess.flush_writes()
        srv.close()
        with contextlib.suppress(OSError):
            os.unlink(path)


def _settle(sess, what: str, reset: bool = False) -> dict:
    try:
        sess.reset() if reset else sess.flush_writes()
        return {"rc": 0, "out": what, "err": ""}
    except Exception as e:
        return {"rc": 1, "out": "", "err": f"pending write failed: {e}"}


def _run(sess, argv, sync: bool) -> dict:
    """One CLI command with the session, its stdout and stderr captured."""
    from .cli import main as cli_main
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            # settle pending write-backs this command might read
            sess.flush_writes(match=argv)
            rc = cli_main(argv, session=sess)
    except SystemExit as e:
        # sys.exit("message") carries a str code
        code = e.code
        if isinstance(code, int) or code is None:
            rc = code or 0
        else:
            rc = 1
            err.write(str(code))
    except Exception as e:
        rc = 1
        err.write(traceback.format_exc())
        err.write(f"\n{type(e).__name__}: {e}")
    if sync and rc == 0:
        # the caller wants the files on reply: a write failure is this
        # command's failure
        try:
            with span("serve.settle"):
                sess.flush_writes()
        except Exception as e:
            rc = 1
            err.write(f"pending write failed: {e}")
    return {"rc": rc, "out": out.getvalue(), "err": err.getvalue()}


def _serve_conn(conn, sess, idle_timeout, verbose, max_requests, n_req):
    """One client connection.  Returns (rc, n_req): rc an exit code that
    stops the server (shutdown, max_requests reached) or None to keep
    accepting; n_req the request count across connections."""
    with conn:
        if idle_timeout:
            conn.settimeout(idle_timeout)
        f = conn.makefile("wb")

        def reply(rep):
            f.write(json.dumps(rep).encode() + b"\n")
            f.flush()

        for line in _recv_lines(conn):
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                reply({"rc": 2, "out": "", "err": f"bad json: {e}"})
                continue
            cmd = req.get("cmd")
            if cmd == "shutdown":
                reply(_settle(sess, "bye"))
                return 0, n_req
            if cmd == "ping":
                reply({"rc": 0, "out": "pong", "err": ""})
                continue
            if cmd == "flush":
                reply(_settle(sess, "flushed"))
                continue
            if cmd == "reset":
                reply(_settle(sess, "reset", reset=True))
                continue
            if cmd is not None:
                reply({"rc": 2, "out": "", "err": f"unknown cmd: {cmd}"})
                continue
            argv = req.get("argv") or []
            if verbose:
                print(f"<- {' '.join(argv)}", flush=True)
            with request(), span("serve.request"):
                count("serve.requests")
                reply(_run(sess, argv, bool(req.get("sync"))))
            n_req += 1
            if max_requests and n_req >= max_requests:
                return 0, n_req
    return None, n_req


def send_command(path: str, argv=None, cmd=None, timeout=600.0,
                 sync=False) -> dict:
    """One request over the socket; returns the reply dict.  sync=True has
    the server settle its write-backs before replying (the files exist
    when this returns)."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(timeout)
    c.connect(path)
    try:
        if argv is not None:
            req = {"argv": list(argv)}
            if sync:
                req["sync"] = True
        else:
            req = {"cmd": cmd}
        c.sendall(json.dumps(req).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            chunk = c.recv(1 << 16)
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
        return json.loads(buf.split(b"\n", 1)[0])
    finally:
        c.close()


def send(args: dict, argv_rest) -> int:
    """CLI client: send [socket=pele_serve.sock] [sync=1] <tool> key=value...
    Prints the server's stdout and stderr and returns its rc.  sync
    defaults on, so that ``send ... && cat out`` sees the files; sync=0
    lets the write overlap the next command."""
    from .parmparse import ParmParse

    pp = ParmParse(args)
    path = pp.query_str("socket", DEFAULT_SOCKET)
    sync = pp.query_bool("sync", True)
    if not argv_rest:
        print("send: missing command (usage: send [socket=S] <tool> k=v...)")
        return 2
    rep = send_command(path, argv=argv_rest, sync=sync)
    if rep.get("out"):
        sys.stdout.write(rep["out"])
    if rep.get("err"):
        sys.stderr.write(rep["err"])
    return int(rep.get("rc", 1))
