"""The port's persistent tool server (``peleanalysis_tpu_torch/server.py``):
commands run through the one-shot CLI's path (byte-identical files), one
Session lives across commands, and the server survives bad commands and
bad clients.  Mirrors ``tests/test_server.py``; every wait has a deadline,
so a hang fails the test instead of running into the suite's clock."""
import os
import socket
import threading
import time

import pytest

from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.server import send_command, serve
from peleanalysis_tpu_torch.testing import write_synthetic_plotfile

D = "device=cpu"
DEADLINE = 60.0        # seconds for any one request on these small inputs


def _start(sock, **keys):
    t = threading.Thread(target=serve, args=(
        {"socket": [sock], **{k: [str(v)] for k, v in keys.items()}},),
        daemon=True)
    t.start()
    # the socket file appears at bind(), connects succeed after listen()
    deadline = time.monotonic() + 10.0
    while True:
        try:
            assert send_command(sock, cmd="ping",
                                timeout=DEADLINE)["out"] == "pong"
            return t
        except (FileNotFoundError, ConnectionRefusedError, OSError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _stop(sock, t):
    assert send_command(sock, cmd="shutdown", timeout=DEADLINE)["rc"] == 0
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture()
def server(tmp_path, monkeypatch):
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    sock = str(tmp_path / "pele.sock")
    t = _start(sock)
    yield sock
    _stop(sock, t)


@pytest.fixture(scope="module")
def plt(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("pltsrv") / "plt")
    write_synthetic_plotfile(p, n_cell=16, n_levels=2)
    return p


def send(sock, argv, **kw):
    return send_command(sock, argv=argv, timeout=DEADLINE, **kw)


def tree_bytes(root):
    out = {}
    for dp, _, fns in os.walk(root):
        for fn in fns:
            p = os.path.join(dp, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_server_commands_match_direct_cli(server, plt, tmp_path,
                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    rep = send(server, ["grad", f"infile={plt}", "gradVar=temp",
                        "outfile=g_srv", D], sync=True)
    assert rep["rc"] == 0 and "wrote g_srv" in rep["out"], rep["err"]
    assert cli.main(["grad", f"infile={plt}", "gradVar=temp",
                     "outfile=g_dir", D]) == 0
    a, b = tree_bytes("g_srv"), tree_bytes("g_dir")
    assert a and a == b
    rep = send(server, ["fextrema", "infile=g_srv", D])
    assert rep["rc"] == 0 and "gradtemp" in rep["out"]


def test_server_session_persists_across_commands(server, plt, tmp_path,
                                                 monkeypatch):
    """A write=0 surface registered by one command seeds a later command's
    streamlines, equal to the file-chained run's."""
    monkeypatch.chdir(tmp_path)
    iso = ["isosurface", f"infile={plt}", "isoCompName=temp", "isoVal=800",
           D]
    stream = ["stream", f"plotfile={plt}", "traceAlongV=1", "nRKsteps=11",
              D]
    rep = send(server, iso + ["outfile_base=iso_mem", "write=0"])
    assert rep["rc"] == 0, rep["err"]
    assert not os.path.exists("iso_mem.mef")
    rep = send(server, stream + ["isoFile=iso_mem.mef",
                                 "outFile=lines_srv.dat"], sync=True)
    assert rep["rc"] == 0, rep["err"]
    assert cli.main(iso + ["outfile_base=iso_f"]) == 0
    assert cli.main(stream + ["isoFile=iso_f.mef",
                              "outFile=lines_dir.dat"]) == 0
    assert (open("lines_srv.dat", "rb").read()
            == open("lines_dir.dat", "rb").read())


def test_server_runs_pipeline_commands(server, plt, tmp_path, monkeypatch):
    """A pipeline sent to the server shares its session and writes the
    bytes of a direct pipeline run."""
    monkeypatch.chdir(tmp_path)

    def pipe(tag):
        return ["pipeline",
                "isosurface", f"infile={plt}", "isoCompName=temp",
                "isoVal=800", f"outfile_base={tag}_iso", "write=0", D, "--",
                "stream", f"plotfile={plt}", "traceAlongV=1",
                f"isoFile={tag}_iso.mef", "nRKsteps=11",
                f"outFile={tag}_lines.dat", D]

    rep = send(server, pipe("s"), sync=True)
    assert rep["rc"] == 0, rep["err"]
    assert not os.path.exists("s_iso.mef")
    assert cli.main(pipe("d")) == 0
    assert (open("s_lines.dat", "rb").read()
            == open("d_lines.dat", "rb").read())


def test_server_survives_bad_commands(server, tmp_path):
    assert send(server, ["nonsense_tool"])["rc"] == 2
    rep = send(server, ["grad", "infile=/does/not/exist", "gradVar=temp",
                        "outfile=x", D])
    assert rep["rc"] == 1 and "FileNotFoundError" in rep["err"]
    # a tool that calls sys.exit with a message: rc 1, message in err
    import peleanalysis_tpu_torch.tools.template as tmpl

    def gives_up(args):
        raise SystemExit("gave up")

    orig, tmpl.main = tmpl.main, gives_up
    try:
        rep = send(server, ["template", "infile=x", D])
    finally:
        tmpl.main = orig
    assert rep["rc"] == 1 and "gave up" in rep["err"]
    # bad JSON and an unknown cmd are rc 2 and leave the server up
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(DEADLINE)
    c.connect(server)
    c.sendall(b"{not json\n")
    assert b'"rc": 2' in c.recv(1 << 16)
    c.close()
    rep = send_command(server, cmd="flus", timeout=DEADLINE)
    assert rep["rc"] == 2 and "unknown cmd" in rep["err"]
    assert send_command(server, cmd="ping", timeout=DEADLINE)["out"] == "pong"
    assert send_command(server, cmd="reset",
                        timeout=DEADLINE)["out"] == "reset"


def test_send_cli_client(server, plt, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["send", f"socket={server}", "fextrema",
                     f"infile={plt}", D]) == 0
    assert "temp" in capsys.readouterr().out
    assert cli.main(["send", f"socket={server}"]) == 2


def test_server_sync_and_flush(server, plt, tmp_path, monkeypatch):
    """sync settles the write-backs before the reply, flush settles all of
    them, and the send client takes sync= as its own key."""
    monkeypatch.chdir(tmp_path)
    grad = ["grad", f"infile={plt}", "gradVar=temp", D]
    rep = send(server, grad + ["outfile=g_sync"], sync=True)
    assert rep["rc"] == 0 and os.path.exists("g_sync/Header")
    rep = send(server, grad + ["outfile=g_async"])
    assert rep["rc"] == 0
    rep = send_command(server, cmd="flush", timeout=DEADLINE)
    assert rep == {"rc": 0, "out": "flushed", "err": ""}
    assert os.path.exists("g_async/Header")
    assert cli.main(["send", f"socket={server}", "sync=1", *grad,
                     "outfile=g_cli"]) == 0
    assert os.path.exists("g_cli/Header")


def test_server_reports_a_failed_write_back(server, tmp_path, monkeypatch):
    """A write-back that fails surfaces as rc 1 on the flush (and the
    server keeps running)."""
    from peleanalysis_tpu_torch import session as sess_mod
    orig = sess_mod.Session.submit_write
    monkeypatch.setattr(
        sess_mod.Session, "submit_write",
        lambda self, path, thunk: orig(self, path, lambda: 1 / 0))
    monkeypatch.chdir(tmp_path)
    write_synthetic_plotfile("p", n_cell=8, n_levels=1)
    rep = send(server, ["grad", "infile=p", "outfile=g", D])
    assert rep["rc"] == 0
    rep = send_command(server, cmd="flush", timeout=DEADLINE)
    assert rep["rc"] == 1 and "division by zero" in rep["err"]
    assert send_command(server, cmd="ping", timeout=DEADLINE)["out"] == "pong"


def test_stalled_client_does_not_wedge_server(tmp_path):
    """A client that connects and never finishes a request line is dropped
    after idle_timeout; the next client is served."""
    sock = str(tmp_path / "pele_idle.sock")
    t = _start(sock, idle_timeout=1)
    stalled = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stalled.connect(sock)
    stalled.sendall(b'{"cmd": "pi')          # no newline
    assert send_command(sock, cmd="ping", timeout=15.0)["out"] == "pong"
    stalled.close()
    _stop(sock, t)


def test_vanished_client_keeps_server_alive(server):
    """A client gone before its reply does not take the server down."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(server)
    c.sendall(b'{"cmd": "flush"}\n')
    c.close()
    time.sleep(0.2)
    for _ in range(3):
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(server)
        c.sendall(b'{"cmd": "ping"}\n')
        c.close()
    assert send_command(server, cmd="ping", timeout=DEADLINE)["out"] == "pong"


def test_max_requests_stops_the_server(tmp_path):
    sock = str(tmp_path / "pele_max.sock")
    t = threading.Thread(target=serve, args=(
        {"socket": [sock], "max_requests": ["1"]},), daemon=True)
    t.start()
    deadline = time.monotonic() + 10.0
    while not os.path.exists(sock):
        assert time.monotonic() < deadline
        time.sleep(0.05)
    while True:
        try:
            rep = send_command(sock, argv=["nonsense_tool"], timeout=DEADLINE)
            break
        except (ConnectionRefusedError, FileNotFoundError):
            assert time.monotonic() < deadline
            time.sleep(0.05)
    assert rep["rc"] == 2
    t.join(timeout=10)
    assert not t.is_alive() and not os.path.exists(sock)
