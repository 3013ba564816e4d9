"""Parity of the port's streamline post-processing verbs (``stream2plt``,
``streamScatter``, ``streamSub``, ``streamTubeStats``) and of its VTK
writers (``io/vtk.py``) with the JAX package's, on the CPU
(``device=cpu``), on the same inputs: one StreamData with elements from a
small isosurface-seeded ``stream`` run (a 2-level 16^3 synthetic
plotfile, the progress = 0.5 surface, nRKsteps=11), a copy of it with
degenerate elements, and the UV sphere and 2-D segment MEFs.

Tolerances:
  * stream2plt FABs: equal bytes (the values are copies, and the
    distance component's arclength is computed in numpy's order);
  * streamScatter's text, streamSub's StreamData and the VTK files: equal
    bytes;
  * streamTubeStats: the same element-centred MEF layout and node count,
    values within 1e-12 of each column's largest (the station and
    neighbour sums run in another order).
"""
import filecmp
import os

import numpy as np
import pytest

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.io import vtk as jax_vtk
from peleanalysis_tpu.io.mef import MEF as JMEF
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools import stream_tube_stats as jst
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.io import vtk
from peleanalysis_tpu_torch.io.mef import MEF, read_mef
from peleanalysis_tpu_torch.io.stream_data import (StreamData,
                                                   read_stream_data,
                                                   write_stream_data)
from peleanalysis_tpu_torch.tools import stream_tube_stats as pst

RTOL = 1e-12


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The plotfile, the seed surface (with temp) and the StreamData (with
    temp and density), written by the port's CLI; and a copy of the
    StreamData with three degenerate elements appended."""
    d = tmp_path_factory.mktemp("stream_post")
    plt = str(d / "plt")
    write_synthetic_plotfile(plt, n_cell=16, n_levels=2, max_grid_size=8)
    seeds = str(d / "seeds")
    sd = str(d / "sd")
    assert cli.main(["isosurface", f"infile={plt}", "isoCompName=progress",
                     "isoVal=0.5", "comps=temp", f"outfile_base={seeds}",
                     "device=cpu"]) == 0
    assert cli.main(["stream", f"plotfile={plt}", "progressName=progress",
                     f"isoFile={seeds}.mef", "nRKsteps=11", "hRK=0.5",
                     "aux_comps=temp density", f"streamFile={sd}",
                     "device=cpu"]) == 0
    s = read_stream_data(sd)
    bad = np.array([[0, 0, 1], [2, 3, 2], [4, 4, 4]], np.int32)
    deg = str(d / "sd_deg")
    write_stream_data(deg, StreamData(
        s.names, np.concatenate([s.elements, bad]), s.inside_nodes,
        s.lines))
    return {"dir": d, "sd": sd, "deg": deg, "seeds": seeds + ".mef",
            "n_lines": s.n_lines, "n_elts": len(s.elements)}


@pytest.fixture
def both(case, monkeypatch):
    """run(tool, args) runs the port (device=cpu) and the JAX CLI, each in
    its own directory under the case's; returns the two directories."""
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)

    def run(tool, args, name):
        out = []
        for who, main, extra in (("port", cli.main, ["device=cpu"]),
                                 ("jax", jax_cli.main, [])):
            wd = case["dir"] / f"{who}_{name}"
            wd.mkdir(exist_ok=True)
            monkeypatch.chdir(wd)
            assert main([tool, *args, *extra]) == 0
            out.append(wd)
        return out
    return run


def test_case_has_elements(case):
    assert case["n_lines"] > 100 and case["n_elts"] > 100


STREAM2PLT = {
    "all": [],
    "comps": ["comps=X Y Z 4"],
    "nlines": ["nLines=50", "sComp=0", "nComp=4"],
    "finest1": ["finestLevel=1", "comps=X Y Z temp"],
    "maxmin": ["comps=X Y Z progress temp", "maxComps=3 temp",
               "maxVals=0.885 1635", "maxSgns=+ gt", "minComps=progress",
               "minVals=0.163", "minSgns=-"],
    "at": ["atComps=temp", "compAt=progress", "valAt=0.6", "atVal=800",
           "atSgns=+"],
    "rxy": ["RXY=0.7", "RXYsgn=-"],
    "rxy_plus": ["RXY=0.75"],
    "dist": ["comps=X Y Z progress temp", "distComp=3", "distVal=0.7"],
    "dist_nofilter": ["comps=X Y Z temp", "distComp=3", "distVal=1000",
                      "no_filter=1", "RXY=0.1"],
}


@pytest.mark.parametrize("name", sorted(STREAM2PLT))
def test_stream2plt(both, case, name):
    port, jax = both("stream2plt", [f"infile={case['sd']}", "outfile=o.fab",
                                    *STREAM2PLT[name]], f"s2p_{name}")
    assert filecmp.cmp(port / "o.fab", jax / "o.fab", shallow=False)


def test_stream2plt_refusals(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for main, extra in ((cli.main, ["device=cpu"]), (jax_cli.main, [])):
        with pytest.raises(ValueError, match="no lines survive"):
            main(["stream2plt", f"infile={case['sd']}", "outfile=o.fab",
                  "maxComps=progress", "maxVals=5", "maxSgns=+", *extra])
        # every seed lies on the finest level: level 0 owns no line
        with pytest.raises(ValueError, match="no lines survive"):
            main(["stream2plt", f"infile={case['sd']}", "outfile=o.fab",
                  "finestLevel=0", *extra])
        with pytest.raises(ValueError, match="distComp"):
            main(["stream2plt", f"infile={case['sd']}", "outfile=o.fab",
                  "comps=X Y Z", "distComp=1", "distVal=0", *extra])


SCATTER = {
    "temp": ["vars=X Y temp density", "condVar=temp",
             "condValMoreThan=900", "condValLessThan=1500"],
    "comp": ["vars=0 4", "condComp=3"],
    "all": ["vars=density", "condVar=progress"],
}


@pytest.mark.parametrize("name", sorted(SCATTER))
def test_stream_scatter(both, case, name):
    port, jax = both("streamScatter", [f"infile={case['sd']}",
                                       "outfileBase=sc", *SCATTER[name]],
                     f"sc_{name}")
    assert filecmp.cmp(port / "sc.dat", jax / "sc.dat", shallow=False)


def same_tree(a, b) -> None:
    fa = sorted(os.path.relpath(os.path.join(r, f), a)
                for r, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(r, f), b)
                for r, _, fs in os.walk(b) for f in fs)
    assert fa == fb and fa
    for f in fa:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


SUB = {
    "range": ["sElt=3", "nElt=20", "comps=temp"],
    "ids": ["eltIDs=0 5 9 17", "comps=4 X"],
    "all": [],
}


@pytest.mark.parametrize("name", sorted(SUB))
def test_stream_sub(both, case, name):
    port, jax = both("streamSub", [f"infile={case['sd']}", "outfile=sub",
                                   *SUB[name]], f"sub_{name}")
    same_tree(str(port / "sub"), str(jax / "sub"))


def close_mef(a: str, b: str) -> None:
    ma, mb = read_mef(a), read_mef(b)
    assert ma.label == mb.label and ma.names == mb.names
    assert ma.nodes.shape == mb.nodes.shape
    np.testing.assert_array_equal(ma.elements, mb.elements)
    scale = np.maximum(np.abs(mb.nodes).max(axis=0), 1e-300)
    err = np.abs(ma.nodes - mb.nodes) / scale
    assert not (err > RTOL).any(), float(err.max())


TUBE = {
    "plain": ["nSmooth=0"],
    "smooth1": ["intComps=progress temp", "avgComps=progress",
                "gradComps=temp", "peakComp=temp progress", "nSmooth=1"],
    "smooth3": ["intComps=4", "avgComps=density", "FCRComp=4",
                "compsAtPeakFCR=progress density",
                "namesAtPeakFCR=pAt dAt", "nSmooth=3", "write_tec=1"],
    "jlo": ["intComps=temp", "jlo=3", "nSmooth=1", "gradComps=3"],
    "aux": ["intComps=progress", "aux_mef={seeds}", "aux_mef_comps=3",
            "nSmooth=1"],
}


@pytest.mark.parametrize("sd", ["sd", "deg"])
@pytest.mark.parametrize("name", sorted(TUBE))
def test_stream_tube_stats(both, case, name, sd):
    args = [a.format(seeds=case["seeds"]) for a in TUBE[name]]
    port, jax = both("streamTubeStats", [f"infile={case[sd]}",
                                         "outfile=tube", *args],
                     f"tube_{name}_{sd}")
    close_mef(str(port / "tube.mef"), str(jax / "tube.mef"))
    if "write_tec=1" in args:
        ta = np.loadtxt(port / "tube.dat", skiprows=2, max_rows=10)
        tb = np.loadtxt(jax / "tube.dat", skiprows=2, max_rows=10)
        np.testing.assert_allclose(ta, tb, rtol=1e-8)
    m = read_mef(str(port / "tube.mef"))
    assert (m.field("volume") >= 0).all() and m.field("volume").max() > 0


@pytest.mark.parametrize("n_smooth", [1, 3])
def test_smooth_values_paths(n_smooth):
    """Both of smooth_values' paths (inclusion-exclusion and the pair list
    of degenerate elements) against the JAX package's."""
    import torch
    rng = np.random.default_rng(3)
    nn, ne = 400, 900
    e = rng.integers(0, nn, (ne, 3))
    good = (e[:, 0] != e[:, 1]) & (e[:, 1] != e[:, 2]) & (e[:, 0] != e[:, 2])
    vals, areas = rng.normal(size=ne), rng.uniform(0.1, 2.0, ne)
    for elements in (e[good], e):
        k = len(elements)
        got = pst.smooth_values(torch.from_numpy(vals[:k]),
                                torch.from_numpy(areas[:k]),
                                torch.from_numpy(elements), nn, n_smooth)
        want = jst.smooth_values(vals[:k], areas[:k],
                                 elements.astype(np.int32), nn, n_smooth)
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= RTOL * scale
    pa, pb = pst.element_adjacency_pairs(torch.from_numpy(e), nn)
    ja, jb = jst.element_adjacency_pairs(e.astype(np.int32), nn)
    np.testing.assert_array_equal(pa.numpy(), ja)
    np.testing.assert_array_equal(pb.numpy(), jb)


def test_wedge_volumes_chunked(case, monkeypatch):
    """The station chunks change nothing but the order of the sums: one
    station a chunk against all at once, and both against the JAX
    package's station loop."""
    import torch
    s = read_stream_data(case["sd"])
    lines = torch.from_numpy(s.lines)
    e = torch.from_numpy(s.elements.astype(np.int64))
    whole = pst.wedge_volumes_ints(lines, e, [3, 4])
    monkeypatch.setattr(pst, "CHUNK_BYTES", 1)
    one = pst.wedge_volumes_ints(lines, e, [3, 4])
    want = jst.wedge_volumes_ints(s.lines, s.elements, [3, 4])
    for a, b, c in zip(whole, one, want):
        scale = np.abs(c).max()
        assert np.abs(a.numpy() - c).max() <= RTOL * scale
        assert np.abs(b.numpy() - c).max() <= RTOL * scale


@pytest.mark.parametrize("writer", ["write_vtk_legacy", "write_vtu",
                                    "write_vtp"])
def test_vtk_writers(tmp_path, writer):
    """io/vtk.py's writers against the JAX package's: equal bytes, for a
    triangle surface with fields, a 2-D segment MEF and a bare one."""
    rng = np.random.default_rng(2)
    tri = MEF("tri", ["X", "Y", "Z", "f", "g"], rng.normal(size=(30, 5)),
              rng.integers(0, 30, (40, 3)).astype(np.int32))
    seg = MEF("seg", ["X", "Y", "h"], rng.normal(size=(12, 3)),
              np.stack([np.arange(11), np.arange(1, 12)], 1).astype(
                  np.int32))
    bare = MEF("bare", ["X", "Y", "Z"], rng.normal(size=(5, 3)),
               np.array([[0, 1, 2], [2, 3, 4]], np.int32))
    for m in (tri, seg, bare):
        a, b = tmp_path / f"port_{m.label}", tmp_path / f"jax_{m.label}"
        getattr(vtk, writer)(str(a), m)
        getattr(jax_vtk, writer)(str(b), JMEF(m.label, list(m.names),
                                              m.nodes, m.elements))
        assert filecmp.cmp(a, b, shallow=False)


def test_stream_verbs_refuse_missing_card(case, monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for args in (["stream2plt", "outfile=o.fab"], ["streamScatter",
                                                   "vars=X"],
                 ["streamSub"], ["streamTubeStats"]):
        with pytest.raises(RuntimeError, match="not available"):
            cli.main([*args, f"infile={case['sd']}", "device=cuda"])
