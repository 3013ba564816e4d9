"""Read-ahead plotfile iteration (``peleanalysis_tpu_torch/io/prefetch.py``)
and the series tools on it: order, serial parity, per-path names, errors in
order, early stop, the in-flight bound, no series member pinned in a
session, and each series tool's ``prefetch=1`` outputs byte-equal to
``prefetch=0``.  Mirrors ``tests/test_prefetch.py``."""
import os
import threading

import numpy as np
import pytest
import torch

from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.hierarchy import load_plotfile_fabs
from peleanalysis_tpu_torch.io.prefetch import iter_states
from peleanalysis_tpu_torch.session import Session, dense_state
from peleanalysis_tpu_torch.testing import write_synthetic_plotfile

D = "device=cpu"


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    td = tmp_path_factory.mktemp("series")
    paths = []
    for i in range(3):
        p = str(td / f"plt{i:05d}")
        write_synthetic_plotfile(p, n_cell=16, n_levels=2, time=0.1 * i)
        paths.append(p)
    return paths


@pytest.fixture(autouse=True)
def _keep_dtype(monkeypatch):
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_iter_states_order_and_parity(series, depth):
    got = list(iter_states({}, series, names=["temp", "density"],
                           depth=depth))
    assert [p for p, _ in got] == list(series)
    for p, st in got:
        meta, names, fabs = load_plotfile_fabs(p, names=["temp", "density"])
        assert st.names == names and st.meta.time == meta.time
        for lev in range(meta.n_levels):
            for a, b in zip(st.fabs[lev], fabs[lev]):
                np.testing.assert_array_equal(a, b)


def test_iter_states_callable_names(series):
    seen = []

    def names(p):
        seen.append(threading.current_thread().name)
        return ["temp"]

    got = list(iter_states({}, series, names=names))
    assert all(st.names == ["temp"] for _, st in got)
    # resolved on the read-ahead thread, but the first (serial start)
    assert any(n.startswith("pele-prefetch") for n in seen)


def test_iter_states_error_in_order(series, tmp_path):
    paths = [series[0], str(tmp_path / "missing_plt"), series[2]]
    it = iter_states({}, paths, names=["temp"])
    p0, _ = next(it)
    assert p0 == series[0]
    with pytest.raises(FileNotFoundError):
        next(it)                     # the missing file fails on its turn


def test_iter_states_early_stop(series):
    it = iter_states({}, series, names=["temp"])
    p, _ = next(it)
    it.close()                       # the worker is cancelled, no hang
    assert p == series[0]


def test_iter_states_inflight_bound(series):
    """depth=1 keeps exactly one load in flight beyond the file held: the
    load of file i+2 does not start before file i+1 is yielded."""
    started = []

    def names_cb(p):
        started.append(p)
        return ["temp"]

    for i, (p, st) in enumerate(iter_states({}, series, names=names_cb)):
        assert set(started) <= set(series[: i + 2]), (i, started)


def test_iter_states_does_not_pin_session_states(series):
    """Series members are never inserted into the session's cache (nor
    their dense states), while an entry cached beforehand is reused."""
    s = Session()
    pre = s.load(series[0], names=["temp"])
    args = {"_session": s}
    got = list(iter_states(args, series, names=["temp"]))
    assert got[0][1] is pre
    assert len(s._states) == 1
    for _, st in got[1:]:
        dense_state(args, st, "cpu", torch.float32)
    assert len(s._dense) == 0


def tree_bytes(root):
    out = {}
    for dp, _, fns in os.walk(root):
        for fn in sorted(fns):
            with open(os.path.join(dp, fn), "rb") as f:
                out[os.path.relpath(os.path.join(dp, fn), root)] = f.read()
    return out


def _outputs(tmp_path, tag):
    return {f: open(os.path.join(tmp_path, f), "rb").read()
            for f in sorted(os.listdir(tmp_path)) if tag in f
            and os.path.isfile(os.path.join(tmp_path, f))}


@pytest.mark.parametrize("tool", [
    ["conditionalMean", "binComp=progress", "avgComps=temp density",
     "nBins=8", "binMin=0", "binMax=1", "writeBinMinMax=1",
     "outfile=cm_{tag}.dat"],
    ["rmsVel", "outfile=rv_{tag}.dat"],
    ["turbulenceSpectra", "outfile_base=ts_{tag}"],
    ["avgPlotfiles", "outfile=avg_{tag}"],
], ids=lambda t: t[0])
def test_series_tool_prefetch_matches_serial(series, tmp_path, monkeypatch,
                                             tool):
    monkeypatch.chdir(tmp_path)
    files = " ".join(series)
    for tag, pre in (("pre", "prefetch=1"), ("ser", "prefetch=0")):
        argv = [a.format(tag=tag) for a in tool]
        assert cli.main(argv + [f"infile={files}", pre, D]) == 0
    pre, ser = _outputs(tmp_path, "pre"), _outputs(tmp_path, "ser")
    if tool[0] == "avgPlotfiles":
        pre, ser = tree_bytes("avg_pre"), tree_bytes("avg_ser")
    assert pre and list(pre.values()) == list(ser.values())
    if tool[0] == "rmsVel":
        assert len(open("rv_pre.dat").read().splitlines()) == 3


def test_jpdf_prefetch_matches_serial(series, tmp_path, monkeypatch):
    """jpdf writes into each plotfile: copies of the series, one a run."""
    import shutil
    monkeypatch.chdir(tmp_path)
    outs = {}
    for pre in ("1", "0"):
        copies = []
        for p in series:
            dst = f"{os.path.basename(p)}_{pre}"
            shutil.copytree(p, dst)
            copies.append(dst)
        assert cli.main(["jpdf", f"infile={' '.join(copies)}",
                         "vars=temp density", "nBins=8", "output_gnuplot=1",
                         "do_average=1", f"prefetch={pre}", D]) == 0
        outs[pre] = [open(f"{c}/Pdf_temp_density.gpd", "rb").read()
                     for c in copies]
        outs[pre].append(open(f"{copies[0]}_avg/Pdf_temp_density.gpd",
                              "rb").read())
    assert outs["1"] == outs["0"]


def test_series_in_a_session_reads_a_registered_output(series, tmp_path,
                                                       monkeypatch):
    """A series member that an earlier stage produced with write=0 comes
    from the session: conditionalMean over [grad output, plotfile]."""
    monkeypatch.chdir(tmp_path)
    cm = ["conditionalMean", "binComp=temp", "avgComps=||gradtemp||",
          "nBins=8", "binMin=300", "binMax=1801", D]
    grad = ["grad", f"infile={series[0]}", "outfile=g", D]
    assert cli.main(grad) == 0
    assert cli.main(cm + ["infile=g g", "outfile=cm_file.dat"]) == 0
    os.rename("g", "g_file")
    assert cli.main(["pipeline", *grad, "write=0", "--",
                     *cm, "infile=g g", "outfile=cm_mem.dat"]) == 0
    assert not os.path.exists("g")
    assert (open("cm_file.dat", "rb").read()
            == open("cm_mem.dat", "rb").read())
