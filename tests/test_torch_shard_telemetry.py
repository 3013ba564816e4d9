"""The spans and counters of the shard windows (``parallel/dense_shard.py``,
``geom/marching_cubes.extract_isosurface_windows``) on the CPU with four
shards: a pipeline of ``curvature`` (``write=0``) and ``isosurface`` over
``ndevices=4`` windows, as a four-card flame series runs it, builds four
windows a tool, owns every cell (every dual cell for the isosurface) once,
keeps each ``shard.*`` span inside its tool's span, writes the unsharded
pipeline's MEF byte for byte, and keeps no span with telemetry stopped."""
import os

import numpy as np
import pytest

from peleanalysis_tpu_torch import cli, telemetry
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.testing import write_synthetic_plotfile

D = "device=cpu"
TOOLS = ("curvature", "isosurface")
SHARD_SPANS = ("shard.assemble", "shard.h2d", "shard.run", "shard.gather",
               "shard.merge")


def flame(x, y, z):
    """A wrinkled front across z, 300 K below and 2200 K above it."""
    zf = 0.5 + 0.06 * np.sin(2 * np.pi * x + 0.3) * np.cos(2 * np.pi * y)
    return 1250.0 + 950.0 * np.tanh((z - zf) / 0.08)


FIELDS = {"temp": flame,
          "density": lambda x, y, z: 1.12 * 300.0 / flame(x, y, z)}


@pytest.fixture(scope="module")
def plt(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("pltshtel") / "plt")
    write_synthetic_plotfile(p, n_cell=16, n_levels=3, max_grid_size=8,
                             fields=FIELDS)
    return p


@pytest.fixture(autouse=True)
def _stopped(monkeypatch):
    # the CLI sets a process-wide compute dtype; telemetry is process-wide
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    telemetry.stop()
    yield
    telemetry.stop()


def stages(plt, out, shards=("ndevices=4",)):
    """The four-card flame cell's two stages, on the CPU."""
    return [["curvature", f"infile={plt}", "progressName=temp",
             "dtype=float64", "Aux_Variables=density", "write=0",
             *shards, f"outfile={out}/K", D],
            ["isosurface", f"infile={out}/K", "isoCompName=temp",
             "isoVal=1000",
             "comps=MeanCurvature_temp GaussianCurvature_temp density",
             *shards, f"outfile_base={out}/iso", D]]


def pipeline(argv_stages):
    argv = ["pipeline"]
    for st in argv_stages:
        argv += st + ["--"]
    return argv[:-1]


def run(plt, out, traced=True, shards=("ndevices=4",)):
    """The pipeline once; with ``traced`` its telemetry record."""
    os.makedirs(out, exist_ok=True)
    dtype = port_config.compute_dtype
    if traced:
        telemetry.start()
    try:
        assert cli.main(pipeline(stages(plt, out, shards))) == 0
    finally:
        rec = telemetry.stop()
        port_config.set_compute_dtype(dtype)
    return rec


@pytest.fixture(scope="module")
def traced(plt, tmp_path_factory):
    return run(plt, str(tmp_path_factory.mktemp("shtel")))


def _tool_of(s, by_id):
    """The ``tool.<tool>`` span above ``s``, or None."""
    while s["parent"] in by_id:
        s = by_id[s["parent"]]
        if s["name"].startswith("tool."):
            return s
    return None


def _by_tool(rec, name):
    by_id = {s["id"]: s for s in rec["spans"]}
    out = {}
    for s in rec["spans"]:
        if s["name"] == name:
            t = _tool_of(s, by_id)
            key = t["name"][len("tool."):] if t else None
            out[key] = out.get(key, 0) + 1
    return out


def hierarchy_cells(plt):
    r = PlotfileReader(plt)
    return sum(b.size for lev in range(r.meta.finest_level + 1)
               for b in r.box_array(lev))


def dual_cells(plt):
    """Dual cells of every level: lower corners over the level's bbox grown
    by one below."""
    r = PlotfileReader(plt)
    n = 0
    for lev in range(r.meta.finest_level + 1):
        bb = r.box_array(lev).minimal_box()
        n += int(np.prod([s + 1 for s in bb.shape]))
    return n


@pytest.mark.parametrize("name", ["shard.assemble", "shard.h2d",
                                  "shard.run"])
def test_four_windows_a_tool(traced, name):
    # the isosurface's windows are cut from the curvature's output where
    # its parts lie: no copy from the host
    tools = ("curvature",) if name == "shard.h2d" else TOOLS
    assert _by_tool(traced, name) == {t: 4 for t in tools}


def test_gather_and_merge_spans(traced):
    # the curvature's four owned parts, kept on their devices for the
    # session (no state gathered); the isosurface's one merge of its
    # windows
    assert _by_tool(traced, "shard.gather") == {"curvature": 4}
    assert _by_tool(traced, "shard.merge") == {"isosurface": 1}


def test_window_counter(traced):
    assert traced["counters"]["shard.windows"] == 4 * len(TOOLS)
    # the isosurface's four, cut from the curvature's resident output
    assert traced["counters"]["shard.device_windows"] == 4


def test_owned_cells_sum_to_the_hierarchy(traced, plt):
    # the curvature's shards own every cell, the isosurface's every dual
    # cell, once
    assert traced["counters"]["shard.owned_cells"] == (
        hierarchy_cells(plt) + dual_cells(plt))


def test_windows_hold_their_owned_cells(traced):
    c = traced["counters"]
    assert c["shard.window_cells"] >= c["shard.owned_cells"] > 0


def test_nothing_crosses_a_card_on_the_cpu(traced):
    # the windows' copies and the gather stay on the host, and no window
    # counts in the dense states' own counter
    c = traced["counters"]
    for k in ("shard.h2d_bytes", "shard.gather_bytes", "h2d.bytes"):
        assert c.get(k, 0) == 0, k


@pytest.mark.parametrize("name", SHARD_SPANS)
def test_shard_spans_nest_inside_their_tool(traced, name):
    by_id = {s["id"]: s for s in traced["spans"]}
    got = [s for s in traced["spans"] if s["name"] == name]
    assert got
    for s in got:
        t = _tool_of(s, by_id)
        assert t is not None and t["name"] in {f"tool.{x}" for x in TOOLS}
        assert t["start"] <= s["start"] <= s["end"] <= t["end"], s


def test_mef_equals_the_unsharded_pipeline(plt, tmp_path):
    sharded, one = str(tmp_path / "four"), str(tmp_path / "one")
    run(plt, sharded, traced=False)
    run(plt, one, traced=False, shards=())
    with open(f"{sharded}/iso.mef", "rb") as a, \
            open(f"{one}/iso.mef", "rb") as b:
        assert a.read() == b.read()


def test_stopped_telemetry_keeps_no_span(plt, tmp_path):
    assert telemetry.span("shard.run") is telemetry._NULL
    before = telemetry.counter("shard.windows")
    run(plt, str(tmp_path / "off"), traced=False)
    # counters are always on; spans only while telemetry is started
    assert telemetry.counter("shard.windows") == before + 4 * len(TOOLS)
    assert telemetry._spans == []
    telemetry.start()
    assert telemetry.stop()["spans"] == []
