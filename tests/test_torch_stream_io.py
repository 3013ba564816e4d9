"""Parity of the port's MEF and StreamData I/O and of its ``stream`` and
``sampleStreamlines`` CLIs with the JAX package's, on identical inputs.

Writers are held byte for byte.  CLI outputs: names, elements and inside
nodes identical; lines and sampled fields within 1e-12 of the domain
extent and of each field's largest value (float64, the tools' dtype; the
JAX einsum may sum the 8 corners in another order); under the lossy
packing (marchPrecision=bfloat16) within one int16 delta step (h/32000)
per station from the seed; Tecplot text parses to the same zones with
values within 1e-8 relative (``%.9g`` keeps 9 digits).
"""
import os

import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.amr.hierarchy import AmrMeta as JaxMeta
from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.io import mef as jax_mef
from peleanalysis_tpu.io import stream_data as jax_sd
from peleanalysis_tpu.stream.trace import \
    trace_streamlines as jax_trace_streamlines
from peleanalysis_tpu.testing import make_amr_hierarchy as jax_hierarchy
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr import cluster as port_cluster
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.amr.hierarchy import AmrMeta
from peleanalysis_tpu_torch.io import mef as port_mef
from peleanalysis_tpu_torch.io import stream_data as port_sd
from peleanalysis_tpu_torch.stream.trace import trace_streamlines
from peleanalysis_tpu_torch.testing import (make_amr_hierarchy,
                                            write_synthetic_plotfile)
from peleanalysis_tpu_torch.tools import grad as port_grad_tool

TOL = 1e-12


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def icosphere(center=0.5, radius=0.2, subdiv=1):
    """Closed triangulated sphere: an icosahedron subdivided ``subdiv``
    times, nodes pushed onto the sphere."""
    t = (1.0 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.array(p, float) / np.linalg.norm(p) for p in v]
    for _ in range(subdiv):
        mid, nf = {}, []

        def m(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = verts[a] + verts[b]
                verts.append(p / np.linalg.norm(p))
                mid[key] = len(verts) - 1
            return mid[key]
        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    return center + radius * np.array(verts), np.array(f, np.int32)


def _sample_mef(rng):
    pos, elts = icosphere()
    nodes = np.concatenate([pos, rng.normal(size=(len(pos), 2))], axis=1)
    return ("0.5", ["X", "Y", "Z", "temp", "c"], nodes, elts)


# -- MEF and StreamData writers -------------------------------------------------
def test_mef_writers_byte_equal(tmp_path):
    label, names, nodes, elts = _sample_mef(np.random.default_rng(0))
    ours = port_mef.MEF(label, names, nodes, elts)
    ref = jax_mef.MEF(label, names, nodes, elts)
    port_mef.write_mef(str(tmp_path / "p.mef"), ours)
    jax_mef.write_mef(str(tmp_path / "j.mef"), ref)
    port_mef.write_mef_tecplot(str(tmp_path / "p.dat"), ours)
    jax_mef.write_mef_tecplot(str(tmp_path / "j.dat"), ref)
    for a, b in (("p.mef", "j.mef"), ("p.dat", "j.dat")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    back = port_mef.read_mef(str(tmp_path / "j.mef"))
    assert back.names == names and back.label == label
    np.testing.assert_array_equal(back.nodes, nodes)
    np.testing.assert_array_equal(back.elements, elts)
    assert back.total_area() == pytest.approx(ref.total_area(), rel=1e-14)
    dat = port_mef.read_mef_tecplot(str(tmp_path / "p.dat"))
    np.testing.assert_array_equal(dat.elements, elts)
    np.testing.assert_allclose(dat.nodes, nodes, rtol=1e-11)


@pytest.mark.parametrize("version", ["0", "1.0"])
def test_stream_data_writers_byte_equal(tmp_path, version):
    geoms, bas, ratios = make_amr_hierarchy(n_cell=16, n_levels=2,
                                            max_grid_size=8)
    jgeoms, jbas, jratios = jax_hierarchy(n_cell=16, n_levels=2,
                                          max_grid_size=8)
    meta, jmeta = AmrMeta(geoms, bas, ratios), JaxMeta(jgeoms, jbas, jratios)
    rng = np.random.default_rng(1)
    n_lines, n_pts = 23, 9
    seeds = rng.uniform(0.05, 0.95, size=(n_lines, 3))
    lines = rng.normal(size=(n_lines, n_pts, 5))
    lines[:, n_pts // 2, :3] = seeds
    elts = rng.integers(0, n_lines, size=(7, 3)).astype(np.int32)
    inside = port_sd.compute_inside_nodes(meta, seeds)
    jinside = jax_sd.compute_inside_nodes(jmeta, seeds)
    for a, b in zip(inside, jinside):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    names = ["X", "Y", "Z", "temp", "c"]
    port_sd.write_stream_data(str(tmp_path / "p"), port_sd.StreamData(
        names, elts, inside, lines), meta=meta, version=version)
    jax_sd.write_stream_data(str(tmp_path / "j"), jax_sd.StreamData(
        names, elts, jinside, lines), meta=jmeta, version=version)
    assert _tree_bytes(tmp_path / "p") == _tree_bytes(tmp_path / "j")
    back = port_sd.read_stream_data(str(tmp_path / "j"))
    assert back.names == names
    np.testing.assert_array_equal(back.elements, elts)
    np.testing.assert_array_equal(back.lines, lines)
    with pytest.raises(ValueError):
        port_sd.write_stream_data(str(tmp_path / "bad"), back, version="2.0")


def test_tecplot_lines_byte_equal(tmp_path):
    from peleanalysis_tpu.tools.stream import write_tecplot_lines as jax_w
    from peleanalysis_tpu_torch.tools.stream import write_tecplot_lines
    rng = np.random.default_rng(3)
    lines = rng.standard_normal((6, 7, 4)) * 10.0 ** rng.integers(
        -8, 8, (6, 7, 4))
    lines[0, :, 0] = [0.0, -0.0, 1e-300, np.inf, -np.inf, np.nan, 1e30]
    names = ["X", "Y", "Z", "temp"]
    write_tecplot_lines(str(tmp_path / "p.dat"), names, lines)
    jax_w(str(tmp_path / "j.dat"), names, lines)
    assert (tmp_path / "p.dat").read_bytes() == (tmp_path / "j.dat").read_bytes()


@pytest.fixture(scope="module")
def jax_native_lib():
    """The JAX package's native library, loaded in this process, so its
    writers take their native formatter (they fall back to numpy text,
    which prints a negative NaN as "nan", if it fails to load).  Its build
    writes the library in place: wait out another process's build."""
    import time
    from peleanalysis_tpu import native as jax_native
    deadline = time.monotonic() + 120
    while True:
        try:
            return jax_native.get_lib()
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(1.0)


def _nan_hazards(rng, shape):
    v = rng.standard_normal(shape) * 10.0 ** rng.integers(-300, 300, shape)
    flat = v.reshape(-1)
    flat[:8] = [np.nan, np.copysign(np.nan, -1.0), np.inf, -np.inf, 0.0,
                -0.0, 5e-324, -1e300]
    return v


@pytest.mark.parametrize("writer", ["tecplot_lines", "mef_tecplot",
                                    "stream_data"])
def test_text_writers_byte_equal_with_nan_signs(tmp_path, jax_native_lib,
                                                writer):
    """The port's text writers go through its copy of the native formatter:
    the same bytes as the JAX package's on NaN of both signs (glibc prints
    "-nan"), +-inf, +-0 and extremes, above the formatter's 256-line
    threading cut-off."""
    rng = np.random.default_rng(12)
    if writer == "tecplot_lines":
        from peleanalysis_tpu.tools.stream import write_tecplot_lines as jw
        from peleanalysis_tpu_torch.tools.stream import write_tecplot_lines
        lines = _nan_hazards(rng, (300, 5, 4))
        write_tecplot_lines(str(tmp_path / "p"), ["X", "Y", "Z", "t"], lines)
        jw(str(tmp_path / "j"), ["X", "Y", "Z", "t"], lines)
    elif writer == "mef_tecplot":
        pos, elts = icosphere(subdiv=3)
        nodes = np.concatenate([pos, _nan_hazards(rng, (len(pos), 2))], 1)
        names = ["X", "Y", "Z", "temp", "c"]
        port_mef.write_mef_tecplot(str(tmp_path / "p"), port_mef.MEF(
            "0.5", names, nodes, elts))
        jax_mef.write_mef_tecplot(str(tmp_path / "j"), jax_mef.MEF(
            "0.5", names, nodes, elts))
    else:
        geoms, bas, ratios = make_amr_hierarchy(n_cell=16, n_levels=2,
                                                max_grid_size=8)
        jg, jb, jr = jax_hierarchy(n_cell=16, n_levels=2, max_grid_size=8)
        lines = _nan_hazards(rng, (400, 5, 4))
        lines[:, 2, :3] = rng.uniform(0.05, 0.95, (400, 3))
        elts = rng.integers(0, 400, size=(500, 3)).astype(np.int32)
        names = ["X", "Y", "Z", "temp"]
        meta, jmeta = AmrMeta(geoms, bas, ratios), JaxMeta(jg, jb, jr)
        port_sd.write_stream_data(str(tmp_path / "p"), port_sd.StreamData(
            names, elts, port_sd.compute_inside_nodes(meta, lines[:, 2, :3]),
            lines), meta=meta)
        jax_sd.write_stream_data(str(tmp_path / "j"), jax_sd.StreamData(
            names, elts, jax_sd.compute_inside_nodes(jmeta, lines[:, 2, :3]),
            lines), meta=jmeta)
    p, j = tmp_path / "p", tmp_path / "j"
    got = _tree_bytes(p) if p.is_dir() else {"": p.read_bytes()}
    want = _tree_bytes(j) if j.is_dir() else {"": j.read_bytes()}
    assert got == want
    if writer != "stream_data":
        text = got[""]
        assert b"-nan" in text and text.count(b"nan") > text.count(b"-nan")
    else:
        assert len(got["Elements"].splitlines()) > 500


# -- the two CLIs on one plotfile ------------------------------------------------
@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("streamcli")
    plt = str(d / "plt")
    write_synthetic_plotfile(plt, n_cell=16, n_levels=3, max_grid_size=8)
    pos, elts = icosphere()
    port_mef.write_mef(str(d / "sphere.mef"), port_mef.MEF(
        "0", ["X", "Y", "Z"], pos, elts))
    return d, plt


@pytest.fixture
def run_both(monkeypatch, case):
    d, _ = case
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    # both CLIs set a process-wide compute dtype: restore it afterwards
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    monkeypatch.chdir(d)

    def run(tool, args, outs):
        """Run both CLIs; ``outs`` maps each output key to a file name,
        which each CLI writes with a ``port_`` or ``jax_`` prefix."""
        for who, main, extra in (("port", cli.main, ["device=cpu"]),
                                 ("jax", jax_cli.main, [])):
            keys = [f"{k}={d / (who + '_' + v)}" for k, v in outs.items()]
            assert main([tool, *args, *keys, *extra]) == 0
        return {k: (str(d / ("port_" + v)), str(d / ("jax_" + v)))
                for k, v in outs.items()}
    return run


def _compare_stream_data(a, b, pos_tol=TOL):
    sa, sb = port_sd.read_stream_data(a), port_sd.read_stream_data(b)
    assert sa.names == sb.names
    np.testing.assert_array_equal(sa.elements, sb.elements)
    assert len(sa.inside_nodes) == len(sb.inside_nodes)
    for la, lb in zip(sa.inside_nodes, sb.inside_nodes):
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)
    assert sa.lines.shape == sb.lines.shape
    assert np.isfinite(sa.lines).all()
    np.testing.assert_allclose(sa.lines[..., :3], sb.lines[..., :3], rtol=0,
                               atol=pos_tol)
    for c in range(3, sa.lines.shape[2]):
        scale = np.abs(sb.lines[..., c]).max()
        np.testing.assert_allclose(sa.lines[..., c], sb.lines[..., c],
                                   rtol=0, atol=max(pos_tol, TOL) * scale)
    with open(os.path.join(a, "Header")) as fa, \
            open(os.path.join(b, "Header")) as fb:
        assert fa.read() == fb.read()
    return sa


def _parse_tecplot(path):
    head, zones = [], []
    with open(path) as f:
        for line in f:
            if line.startswith(("VARIABLES", "ZONE")):
                head.append(line)
                zones.append([])
            else:
                zones[-1].append([float(v) for v in line.split()])
    return head, [np.array(z) for z in zones[1:]]


def _compare_tecplot(a, b, atol):
    ha, za = _parse_tecplot(a)
    hb, zb = _parse_tecplot(b)
    assert ha == hb and len(za) == len(zb)
    for x, y in zip(za, zb):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=1e-8, atol=atol)


def test_stream_cli_gradient_mode(run_both, case):
    _, plt = case
    out = run_both("stream", [
        f"plotfile={plt}", "progressName=progress", "isoFile=sphere.mef",
        "nRKsteps=11", "hRK=0.5", "aux_comps=temp density",
        "bounds=0.2 0.2 0.2 0.8 0.8 0.62", "sd_version=1.0"],
        {"streamFile": "sd_grad", "outFile": "grad.dat"})
    sd = _compare_stream_data(*out["streamFile"])
    assert sd.names == ["X", "Y", "Z", "progress", "temp", "density"]
    # the bounds drop the sphere's top cap and the elements that lose a node
    assert 0 < sd.n_lines < 42 and 0 < len(sd.elements) < 80
    _compare_tecplot(*out["outFile"], atol=1e-12)


def test_stream_cli_velocity_bf16_packed(run_both, case):
    _, plt = case
    h_phys, n_half = 0.5 / 32, 10           # finestLevel=1: dx 1/32
    out = run_both("stream", [
        f"plotfile={plt}", "traceAlongV=1", "progressName=progress",
        "seedRakeL=0.3 0.35 0.45", "seedRakeR=0.7 0.6 0.55",
        "seedRakeNum=17", "nRKsteps=21", "hRK=0.5", "aux_sComp=2",
        "aux_nComp=1", "finestLevel=1", "marchPrecision=bfloat16"],
        {"streamFile": "sd_vel", "outFile": "vel.dat"})
    sd = _compare_stream_data(*out["streamFile"],
                              pos_tol=n_half * h_phys / 32000.0 + TOL)
    assert sd.names == ["X", "Y", "Z", "progress", "density"]
    _compare_tecplot(*out["outFile"], atol=n_half * h_phys / 32000.0)


@pytest.mark.parametrize("out_key", ["streamSampleFile", "outFile"])
def test_sample_streamlines_cli(run_both, case, out_key):
    d, plt = case
    assert cli.main(["stream", f"plotfile={plt}", "progressName=progress",
                     "isoFile=sphere.mef", "nRKsteps=11", "hRK=0.5",
                     f"streamFile={d / 'sd_in'}", "device=cpu"]) == 0
    out = run_both("sampleStreamlines", [
        f"plotfile={plt}", f"pathFile={d / 'sd_in'}",
        "comps=density temp", "nCompsPerPass=1"],
        {out_key: "sampled" + (".dat" if out_key == "outFile" else "")})
    if out_key == "streamSampleFile":
        sd = _compare_stream_data(*out[out_key])
        assert sd.names == ["X", "Y", "Z", "distance_from_seed", "density",
                            "temp"]
        mid = (sd.n_pts - 1) // 2
        np.testing.assert_allclose(sd.lines[:, mid, 3], 0.0, atol=1e-14)
    else:
        _compare_tecplot(*out[out_key], atol=1e-12)


def test_build_alt_surf_cli(run_both, case):
    _, plt = case
    out = run_both("stream", [
        f"plotfile={plt}", "progressName=progress", "isoFile=sphere.mef",
        "nRKsteps=41", "hRK=0.5", "buildAltSurf=1", "altVal=0.3",
        "addAngle=1", "thickCompName=progress", "thickLo=0.2",
        "thickHi=0.4"], {"outFile": "alt_lines.dat",
                         "altSurfFile": "alt.mef"})
    a, b = (port_mef.read_mef(p) for p in out["altSurfFile"])
    assert a.names == b.names and a.label == b.label
    assert "angle" in a.names and "thermal_thickness" in a.names
    np.testing.assert_array_equal(a.elements, b.elements)
    scale = np.maximum(np.abs(b.nodes).max(axis=0), 1.0)
    np.testing.assert_allclose(a.nodes / scale, b.nodes / scale, rtol=0,
                               atol=TOL)
    # lines are radial: the progress=0.3 crossings sit on that sphere
    rr = np.linalg.norm(a.positions() - 0.5, axis=1)
    assert np.abs(rr - 0.15 * np.sqrt(np.log(1 / 0.3))).max() < 3 / 64


@pytest.mark.parametrize("trace_field", ["progress", None])
def test_trace_streamlines_2d_promotion(tmp_path, trace_field):
    plt = str(tmp_path / "plt2d")
    write_synthetic_plotfile(plt, n_cell=16, n_levels=2, max_grid_size=8,
                             ndim=2)
    jds = JaxDense.from_batched(AmrState.from_plotfile(plt,
                                                       dtype=np.float64))
    pds = DenseAmrState.from_plotfile(plt, "cpu",
                                      dtype=torch.float64)
    seeds = 0.5 + 0.5 * (np.random.default_rng(2).random((9, 2)) - 0.5)
    kw = dict(n_rk_steps=11, h_rk=0.5, trace_field=trace_field,
              sample_names=("density",))
    want = jax_trace_streamlines(jds, seeds, **kw)
    got = trace_streamlines(pds, seeds, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_stream_refusals(case, tmp_path, monkeypatch, capsys):
    """stream without an output refuses; a hierarchy taken for sparse
    refinement runs the clustered stream and sampleStreamlines, whose files
    equal the force_dense=1 runs'."""
    _, plt = case
    common = [f"plotfile={plt}", "seedLoc=0.5 0.5 0.6", "device=cpu"]
    with pytest.raises(ValueError, match="streamFile or outFile"):
        cli.main(["stream", *common])
    monkeypatch.setattr(port_cluster, "needs_clustering", lambda ba: True)
    seeds = ["seedRakeL=0.2 0.3 0.4", "seedRakeR=0.7 0.6 0.5",
             "seedRakeNum=12", f"plotfile={plt}", "device=cpu"]
    for mode, extra in (("c", []), ("d", ["force_dense=1"])):
        sd, sd2 = tmp_path / f"sd_{mode}", tmp_path / f"sd2_{mode}"
        assert cli.main(["stream", *seeds, f"streamFile={sd}",
                         *extra]) == 0
        assert cli.main(["sampleStreamlines", f"plotfile={plt}",
                         f"pathFile={sd}", "comps=temp density",
                         f"streamSampleFile={sd2}", "device=cpu",
                         *extra]) == 0
        assert capsys.readouterr().out.count("clustered path") == (
            2 if mode == "c" else 0)
    for name in ("sd", "sd2"):
        a = port_sd.read_stream_data(str(tmp_path / f"{name}_c"))
        b = port_sd.read_stream_data(str(tmp_path / f"{name}_d"))
        assert a.names == b.names
        np.testing.assert_allclose(a.lines, b.lines, rtol=0, atol=TOL)
