"""Parity of the port's MEF surface toolbox (``geom/mef_tools.py``, the 13
MEF verbs and isosurface's ``writeLines=1``) with the JAX package's, on the
CPU (``device=cpu``), on the same inputs: the UV sphere of
tests/test_mef_tools.py (n=24) with a field and a noisy field, a DIM=2
triangle MEF, a 2-D segment MEF, the sphere with degenerate triangles and
a DIM=2 plotfile.

Tolerances:
  * the copy and format verbs (mergeMEF, surfDATtoMEF, surfMEFtoDAT),
    decimateMEF, combineMEF, multMEF and scaleMEF: equal bytes;
  * the computing verbs and functions: the same element and node counts,
    the same connectivity, values within 1e-12 of each column's largest;
  * checkIso's and binMEF's printouts, binMEF's dumpFab and isosurface's
    ``_lines.dat``: equal bytes.
"""
import filecmp

import numpy as np
import pytest

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu.geom import mef_tools as JG
from peleanalysis_tpu.io.mef import MEF as JMEF
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch.geom import mef_tools as G
from peleanalysis_tpu_torch.io.mef import MEF, read_mef, write_mef

RTOL = 1e-12
CPU = "cpu"


def make_sphere_mef(n=24, r=0.3):
    """The UV sphere of tests/test_mef_tools.py:8 with comp zf = z, and a
    second field g of every node's x*y + z."""
    thetas = np.linspace(0, np.pi, n)
    phis = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    verts = [(0.0, 0.0, r)]
    for t in thetas[1:-1]:
        for p in phis:
            verts.append((r * np.sin(t) * np.cos(p),
                          r * np.sin(t) * np.sin(p), r * np.cos(t)))
    verts.append((0.0, 0.0, -r))
    verts = np.array(verts)
    tris = []
    m = len(phis)
    for j in range(m):
        tris.append((0, 1 + j, 1 + (j + 1) % m))
    for i in range(n - 3):
        a, b = 1 + i * m, 1 + (i + 1) * m
        for j in range(m):
            j2 = (j + 1) % m
            tris.append((a + j, b + j, b + j2))
            tris.append((a + j, b + j2, a + j2))
    last = len(verts) - 1
    a = 1 + (n - 3) * m
    for j in range(m):
        tris.append((last, a + (j + 1) % m, a + j))
    g = verts[:, 0] * verts[:, 1] + verts[:, 2]
    nodes = np.concatenate([verts, verts[:, 2:3], g[:, None]], axis=1)
    return MEF("sphere", ["X", "Y", "Z", "zf", "g"], nodes,
               np.array(tris, dtype=np.int32))


def make_plane2d(n=12):
    """A DIM=2 triangulated square [0,1]^2 with field f = x + 2 y^2."""
    x, y = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                       indexing="ij")
    nodes = np.stack([x.ravel(), y.ravel(), (x + 2 * y ** 2).ravel()], 1)
    tris = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b = i * n + j, (i + 1) * n + j
            tris += [(a, b, b + 1), (a, b + 1, a + 1)]
    return MEF("plane", ["X", "Y", "f"], nodes, np.array(tris, np.int32))


def make_segments2d():
    """A 2-D segment MEF: an open polyline and a closed square loop."""
    t = np.linspace(0, 1, 7)
    pts = [np.stack([t, t ** 2], 1),
           np.array([[2.0, 0.0], [3.0, 0.0], [3.0, 1.0], [2.0, 1.0]])]
    nodes = np.concatenate(pts)
    f = nodes[:, 0] - nodes[:, 1]
    segs = [(i, i + 1) for i in range(6)] + [(7, 8), (8, 9), (9, 10),
                                            (10, 7)]
    return MEF("segs", ["X", "Y", "f"], np.concatenate([nodes, f[:, None]],
                                                       1),
               np.array(segs, np.int32))


def make_degenerate():
    """The sphere (n=12) with three degenerate triangles appended."""
    s = make_sphere_mef(12)
    bad = np.array([[0, 0, 1], [5, 6, 5], [7, 7, 7]], np.int32)
    return MEF("deg", s.names, s.nodes, np.concatenate([s.elements, bad]))


@pytest.fixture(scope="module")
def mefs():
    s = make_sphere_mef()
    rng = np.random.default_rng(0)
    noisy = s.nodes.copy()
    noisy[:, 3] += 0.05 * rng.normal(size=len(noisy))
    return {"sphere": s, "noisy": MEF("s", s.names, noisy, s.elements),
            "plane": make_plane2d(), "segs": make_segments2d(),
            "deg": make_degenerate()}


def jmef(m: MEF) -> JMEF:
    return JMEF(m.label, list(m.names), m.nodes.copy(), m.elements.copy())


def same_mef(a, b) -> None:
    """Same label, names, node count and connectivity; nodes within RTOL of
    each column's largest value."""
    assert a.label == b.label and list(a.names) == list(b.names)
    assert a.nodes.shape == b.nodes.shape
    np.testing.assert_array_equal(a.elements, b.elements)
    close(a.nodes, b.nodes)


def close(a, b) -> None:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    if a.size == 0:
        return
    scale = np.abs(b).max(axis=0) if b.ndim > 1 else np.abs(b).max()
    err = np.abs(a - b) / np.maximum(scale, 1e-300)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert not (err > RTOL).any(), float(np.nanmax(err))


# -- geom/mef_tools.py, function by function ----------------------------------
@pytest.mark.parametrize("which", ["sphere", "noisy", "deg"])
def test_check_iso(mefs, which):
    m = mefs[which]
    assert G.check_iso(m, CPU) == JG.check_iso(jmef(m))


def test_combine_merge_mult_scale(mefs):
    s = mefs["sphere"]
    n = mefs["noisy"]
    b2 = MEF("s", ["X", "Y", "Z", "other", "g"], n.nodes, n.elements)
    got = G.combine_mef(s, b2, ["zf"], ["other", "g"], CPU)
    want = JG.combine_mef(jmef(s), jmef(b2), ["zf"], ["other", "g"])
    same_mef(got, want)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    for got, want in ((G.merge_mef(s, n), JG.merge_mef(jmef(s), jmef(n))),
                      (G.mult_mef(s, n, ["zf", "g"], CPU),
                       JG.mult_mef(jmef(s), jmef(n), ["zf", "g"])),
                      (G.scale_mef(s, ["zf", "Y"], [3.0, -0.7], CPU),
                       JG.scale_mef(jmef(s), ["zf", "Y"], [3.0, -0.7]))):
        same_mef(got, want)
        np.testing.assert_array_equal(got.nodes, want.nodes)
    with pytest.raises(ValueError):
        G.combine_mef(s, mefs["deg"], ["zf"], ["g"], CPU)


@pytest.mark.parametrize("comp,val,keep_ge", [(3, 0.0, True),
                                              (3, 0.1, False),
                                              (4, -0.05, True),
                                              (0, 0.3, True)])
def test_clip_and_areas(mefs, comp, val, keep_ge):
    import torch
    s = mefs["sphere"]
    tris = s.nodes[s.elements]
    got = G.clip_tris_halfspace(torch.from_numpy(tris), comp, val,
                                keep_ge).numpy()
    want = JG._clip_tris_halfspace(tris, comp, val, keep_ge)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(G.tri_areas(torch.from_numpy(got),
                                              3).numpy(),
                                  JG._tri_areas(want, 3))
    p = mefs["plane"]
    t2 = p.nodes[p.elements]
    got2 = G.clip_tris_halfspace(torch.from_numpy(t2), 2, 1.3,
                                 keep_ge).numpy()
    want2 = JG._clip_tris_halfspace(t2, 2, 1.3, keep_ge)
    np.testing.assert_array_equal(got2, want2)
    with np.errstate(all="ignore"), pytest.warns(DeprecationWarning):
        a2 = JG._tri_areas(want2, 2)
    np.testing.assert_array_equal(G.tri_areas(torch.from_numpy(got2),
                                              2).numpy(), a2)


@pytest.mark.parametrize("dedup", [True, False])
def test_tris_to_mef(mefs, dedup):
    import torch
    s = mefs["sphere"]
    tris = JG._clip_tris_halfspace(s.nodes[s.elements], 3, 0.05, True)
    # a -0.0 among the coordinates: rounds and dedups as 0.0
    tris[0, 0, 0] = -0.0
    got = G.tris_to_mef(torch.from_numpy(tris), s.names, "t", dedup=dedup)
    want = JG.tris_to_mef(tris, s.names, "t", dedup=dedup)
    same_mef(got, want)
    np.testing.assert_array_equal(got.nodes, want.nodes)


TRIMS = {
    "one": dict(comps=["zf"], signs=["+"], vals=[0.0]),
    "two": dict(comps=["zf", "g"], signs=["-", "gt"], vals=[0.2, -0.1]),
    "rxy": dict(comps=["zf"], signs=["+"], vals=[-0.1], rxy=0.2,
                sign_rxy="-"),
    "rem": dict(comps=["X"], signs=["+"], vals=[0.05],
                rem_comps=["g"]),
}


@pytest.mark.parametrize("case", sorted(TRIMS))
def test_trim_mef(mefs, case):
    kw = dict(TRIMS[case])
    args = [kw.pop(k) for k in ("comps", "signs", "vals")]
    for which in ("sphere", "deg"):
        m = mefs[which]
        same_mef(G.trim_mef(m, *args, CPU, **kw),
                 JG.trim_mef(jmef(m), *args, **kw))


def test_trim_mef_2d(mefs):
    p = mefs["plane"]
    got = G.trim_mef(p, ["f"], ["+"], [0.9], CPU)
    want = JG.trim_mef(jmef(p), ["f"], ["+"], [0.9])
    same_mef(got, want)


BINS = {
    "z6": (["zf"], [-0.3], [0.3], [6], {}),
    "zx": (["zf", "X"], [-0.3, -0.3], [0.3, 0.1], [5, 4], {}),
    "cond": (["Y"], [-0.1], [0.25], [7],
             dict(cond_comp="zf", cond_val=0.0, cond_sgn="+")),
    "xyz": (["X", "Y", "g"], [-0.3, -0.3, -0.4], [0.3, 0.3, 0.4],
            [4, 3, 5], dict(normalize=True, area_eps=1e-4)),
}


@pytest.mark.parametrize("case", sorted(BINS))
def test_bin_mef(mefs, case):
    comps, lo, hi, nb, kw = BINS[case]
    for which in ("sphere", "deg"):
        got = G.bin_mef(mefs[which], comps, lo, hi, nb, CPU, **kw)
        want = JG.bin_mef(jmef(mefs[which]), comps, lo, hi, nb, **kw)
        np.testing.assert_array_equal(got, want)


def test_bin_mef_vertex_at_bin_max():
    """A vertex exactly at binMax belongs to the last bin."""
    import torch
    tris = np.array([[[0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0]],
                     [[0.0, 0.0, 0.4], [1.0, 0.0, 0.4], [0.0, 1.0, 0.4]],
                     [[0.0, 0.0, 0.9], [1.0, 0.0, 1.0], [0.0, 1.0, 0.2]]])
    m = G.tris_to_mef(torch.from_numpy(tris), ["xf", "yf", "zf"],
                      dedup=False)
    jm = JG.tris_to_mef(tris, ["xf", "yf", "zf"], dedup=False)
    got = G.bin_mef(m, ["zf"], [0.0], [1.0], [4], CPU)
    np.testing.assert_array_equal(got, JG.bin_mef(jm, ["zf"], [0.0], [1.0],
                                                  [4]))
    assert got[-1] > 0.5


def test_bin_mef_2d(mefs):
    p = mefs["plane"]
    with np.errstate(all="ignore"), pytest.warns(DeprecationWarning):
        want = JG.bin_mef(jmef(p), ["f", "Y"], [0.0, 0.0], [3.0, 1.0],
                          [6, 3])
    np.testing.assert_array_equal(
        G.bin_mef(p, ["f", "Y"], [0.0, 0.0], [3.0, 1.0], [6, 3], CPU), want)


@pytest.mark.parametrize("comp,val", [("zf", 0.0), ("zf", 0.17),
                                      ("g", 0.05), ("X", -0.2)])
def test_iso_mef(mefs, comp, val):
    s = mefs["sphere"]
    same_mef(G.iso_mef(s, comp, val, CPU), JG.iso_mef(jmef(s), comp, val))
    # no crossing: an empty segment MEF
    same_mef(G.iso_mef(s, comp, 5.0, CPU), JG.iso_mef(jmef(s), comp, 5.0))


def test_slice_mef(mefs):
    s = mefs["sphere"]
    got = G.slice_mef(s, 2, [0.0, 0.15, -0.29], CPU)
    want = JG.slice_mef(jmef(s), 2, [0.0, 0.15, -0.29])
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        same_mef(a, b)
    p = mefs["plane"]
    for a, b in zip(G.slice_mef(p, 0, [0.5], CPU),
                    JG.slice_mef(jmef(p), 0, [0.5])):
        same_mef(a, b)


@pytest.mark.parametrize("n_iter", [1, 3])
def test_smooth_mef(mefs, n_iter):
    for which in ("noisy", "deg"):
        m = mefs[which]
        got = G.smooth_mef(m, ["zf", "g"], CPU, n_iter)
        want = JG.smooth_mef(jmef(m), ["zf", "g"], n_iter)
        same_mef(got, want)
        np.testing.assert_array_equal(got.nodes, want.nodes)


def _canon_chains(chains):
    out = []
    for c in chains:
        c = [int(x) for x in c]
        if len(c) > 2 and c[0] == c[-1]:
            ring = c[:-1]
            k = ring.index(min(ring))
            fwd = ring[k:] + ring[:k]
            bwd = [fwd[0]] + fwd[1:][::-1]
            out.append(("loop", tuple(min(fwd, bwd))))
        else:
            out.append(("open", tuple(min(c, c[::-1]))))
    return sorted(out)


def test_assemble_polylines_array_matches_walk():
    """The cases of tests/test_mef_tools.py's
    test_assemble_polylines_array_matches_walk: the port's chains equal the
    JAX package's (array path and walk), chain for chain."""
    rng = np.random.default_rng(1)
    for trial in range(60):
        segs, nid = [], 0
        for _ in range(rng.integers(0, 4)):          # open chains
            L = int(rng.integers(1, 6))
            ids = list(range(nid, nid + L + 1))
            nid += L + 1
            segs += [(ids[i], ids[i + 1]) for i in range(L)]
        for _ in range(rng.integers(0, 3)):          # loops
            L = int(rng.integers(3, 7))
            ids = list(range(nid, nid + L))
            nid += L
            segs += [(ids[i], ids[(i + 1) % L]) for i in range(L)]
        if not segs:
            continue
        segs = np.array(segs)[rng.permutation(len(segs))]
        flip = rng.random(len(segs)) < 0.5
        segs[flip] = segs[flip][:, ::-1]
        mef = MEF("t", ["X", "Y"], np.zeros((nid, 2)), segs.astype(np.int32))
        got = G.assemble_polylines(mef)
        want = JG.assemble_polylines(jmef(mef))
        assert [c.tolist() for c in got] == [c.tolist() for c in want]
        walk = G._assemble_polylines_walk(mef)
        assert [c.tolist() for c in walk] == [
            c.tolist() for c in JG._assemble_polylines_walk(jmef(mef))]
        assert _canon_chains(got) == _canon_chains(walk)


def test_assemble_polylines_junction(mefs):
    """A junction node (degree 3) takes the greedy walk in both."""
    s = mefs["segs"]
    e = np.concatenate([s.elements, [[3, 8]]]).astype(np.int32)
    m = MEF("j", s.names, s.nodes, e)
    got = G.assemble_polylines(m)
    want = JG.assemble_polylines(jmef(m))
    assert [c.tolist() for c in got] == [c.tolist() for c in want]
    assert [c.tolist() for c in G.assemble_polylines(s)] == [
        c.tolist() for c in JG.assemble_polylines(jmef(s))]


def test_element_areas_segments(mefs):
    import torch
    s = mefs["segs"]
    got = G.element_areas(torch.from_numpy(s.nodes),
                          torch.from_numpy(s.elements.astype(np.int64)), 2)
    np.testing.assert_array_equal(got.numpy(), jmef(s).triangle_areas())


# -- the verbs through both CLIs ----------------------------------------------
@pytest.fixture(scope="module")
def files(mefs, tmp_path_factory):
    d = tmp_path_factory.mktemp("mef_cli")
    out = {"dir": d}
    for k, m in mefs.items():
        out[k] = str(d / f"{k}.mef")
        write_mef(out[k], m)
    return out


@pytest.fixture
def both(files, monkeypatch, capsys):
    """run(tool, args, outs) runs the port (device=cpu) and the JAX CLI in
    directories port/ and jax/; returns their stdout and directories."""
    d = files["dir"]

    def run(tool, args):
        res = {}
        for who, main, extra in (("port", cli.main, ["device=cpu"]),
                                 ("jax", jax_cli.main, [])):
            wd = d / f"{who}_{tool}"
            wd.mkdir(exist_ok=True)
            monkeypatch.chdir(wd)
            capsys.readouterr()
            assert main([tool, *args, *extra]) == 0
            res[who] = (capsys.readouterr().out, wd)
        return res
    return run


# verb -> (args, outputs compared byte for byte)
BYTE_EQUAL = {
    "mergeMEF": (["infile1={sphere}", "infile2={segs}"], []),
    "mergeMEF_same": (["infile1={sphere}", "infile2={noisy}"],
                      ["merged.mef"]),
    "surfMEFtoDAT": (["infile={sphere}"], ["surf.dat"]),
    "surfMEFtoDAT_segs": (["infile={segs}", "outfile=s.dat"], ["s.dat"]),
    "decimateMEF": (["infile={sphere}"], ["decimated.mef"]),
    "decimateMEF_opts": (["infile={noisy}", "face_target=300",
                          "placement_policy=1", "weighting_policy=2",
                          "meshing_penalty=2", "compactness_ratio=0.1",
                          "outfile=d.mef"], ["d.mef"]),
    "combineMEF": (["infile1={sphere}", "infile2={noisy}", "comps1=zf",
                    "comps2=g 3"], ["combined.mef"]),
    "multMEF": (["infile1={sphere}", "infile2={noisy}", "comps=zf 4"],
                ["mult.mef"]),
    "scaleMEF": (["infile={plane}", "comps=f 0", "factors=2.5 -1"],
                 ["scaled.mef"]),
    "checkIso": (["infile={deg}"], []),
    "checkIso_sphere": (["infile={sphere}"], []),
}


def _args(args, files):
    return [a.format(**{k: v for k, v in files.items() if k != "dir"})
            for a in args]


@pytest.mark.parametrize("case", sorted(BYTE_EQUAL))
def test_verbs_byte_equal(both, files, case):
    args, outs = BYTE_EQUAL[case]
    tool = case.split("_")[0]
    if case == "mergeMEF":
        # different component lists: both refuse
        for main in (cli.main, jax_cli.main):
            with pytest.raises(ValueError, match="component lists differ"):
                main([tool, *_args(args, files), "device=cpu"]
                     if main is cli.main else [tool, *_args(args, files)])
        return
    res = both(tool, _args(args, files))
    assert res["port"][0] == res["jax"][0]
    for name in outs:
        assert filecmp.cmp(res["port"][1] / name, res["jax"][1] / name,
                           shallow=False), name


def test_surf_dat_to_mef(both, files):
    """surfMEFtoDAT then surfDATtoMEF: both CLIs write the same bytes."""
    res = both("surfMEFtoDAT", [f"infile={files['noisy']}",
                                "outfile=n.dat"])
    dat = str(res["jax"][1] / "n.dat")
    res = both("surfDATtoMEF", [f"infile={dat}", "outfile=n.mef"])
    assert filecmp.cmp(res["port"][1] / "n.mef", res["jax"][1] / "n.mef",
                       shallow=False)


# verb -> (args, output MEFs held to same_mef)
COMPUTED = {
    "isoMEF": (["infile={sphere}", "comp=3", "isoVal=0.1"],
               ["iso_zf_0.1.mef"]),
    "sliceMEF": (["infile={sphere}", "dir=2", "locs=0 0.15",
                  "write_tec=1", "outfile_base=sl"],
                 ["sl_0.mef", "sl_0.15.mef"]),
    "smoothMEF": (["infile={noisy}", "niter=2"], ["smoothed.mef"]),
    "trimMEFgen": (["infile={sphere}", "comps=zf g", "signs=+ -",
                    "vals=0.0 0.2", "RXY=0.25", "sign_RXY=-",
                    "remComps=g", "do_area_stats=1"], ["trimmed.mef"]),
    "trimMEFgen_deg": (["infile={deg}", "comps=3", "vals=0.05",
                        "do_area_stats=1", "outfile=t.mef"], ["t.mef"]),
}


@pytest.mark.parametrize("case", sorted(COMPUTED))
def test_verbs_computed(both, files, case):
    args, outs = COMPUTED[case]
    res = both(case.split("_")[0], _args(args, files))
    assert res["port"][0] == res["jax"][0]
    for name in outs:
        same_mef(read_mef(str(res["port"][1] / name)),
                 read_mef(str(res["jax"][1] / name)))
    if case == "sliceMEF":
        for name in ("sl_0.dat", "sl_0.15.dat"):
            assert filecmp.cmp(res["port"][1] / name, res["jax"][1] / name,
                               shallow=False)


BIN_CLI = {
    "one": ["binComps=zf", "binMin=-0.3", "binMax=0.3", "nBins=6",
            "dumpBins=1"],
    "fab": ["binComps=zf X", "binMin=-0.3 -0.3", "binMax=0.3 0.1",
            "nBins=5 4", "dumpFab=1", "fabFileBase=bins"],
    "cond": ["binComps=Y", "binMin=-0.1", "binMax=0.25", "nBins=7",
             "condComp=zf", "condVal=0.0", "condSgn=-", "normalize=1"],
    "nocond": ["binComps=3", "binMin=-0.3", "binMax=0.3", "nBins=3",
               "condComp=g", "condApply=0", "areaEps=0.01"],
}


@pytest.mark.parametrize("case", sorted(BIN_CLI))
def test_bin_mef_cli(both, files, case):
    res = both("binMEF", [f"infile={files['sphere']}", *BIN_CLI[case]])
    assert res["port"][0] == res["jax"][0]
    assert "binMEF done" in res["port"][0]
    if case == "fab":
        assert filecmp.cmp(res["port"][1] / "bins.fab",
                           res["jax"][1] / "bins.fab", shallow=False)


@pytest.fixture(scope="module")
def plt2d(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("plt2d") / "plt")
    write_synthetic_plotfile(path, n_cell=32, n_levels=2, ndim=2)
    return path


@pytest.mark.parametrize("iso", ["temp 1000", "progress 0.5"])
def test_isosurface_write_lines(both, plt2d, iso):
    """isosurface writeLines=1 on a DIM=2 plotfile: the polylines' text
    equals the JAX CLI's byte for byte."""
    comp, val = iso.split()
    res = both("isosurface", [f"infile={plt2d}", f"isoCompName={comp}",
                              f"isoVal={val}", "writeLines=1",
                              "outfile_base=c"])
    assert "_lines.dat" in res["port"][0]
    assert filecmp.cmp(res["port"][1] / "c_lines.dat",
                       res["jax"][1] / "c_lines.dat", shallow=False)
    assert filecmp.cmp(res["port"][1] / "c.mef", res["jax"][1] / "c.mef",
                       shallow=False)


def test_verbs_refuse_missing_card(files, monkeypatch):
    """device=cuda without a card raises before any work, also for the
    host-only verbs."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool, args in (("mergeMEF", ["infile1={sphere}", "infile2={noisy}"]),
                       ("decimateMEF", ["infile={sphere}"]),
                       ("surfMEFtoDAT", ["infile={sphere}"]),
                       ("checkIso", ["infile={sphere}"]),
                       ("binMEF", ["infile={sphere}", "binComps=zf",
                                   "binMin=0", "binMax=1", "nBins=2"])):
        with pytest.raises(RuntimeError, match="not available"):
            cli.main([tool, *_args(args, files), "device=cuda"])
