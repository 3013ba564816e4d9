"""Parity of the port's plotfile tools with the JAX package's.

Each verb runs through both CLIs on the same synthetic plotfiles
(``write_synthetic_plotfile`` at n_cell=16, 2 levels, refine_frac 0.5 /
0.25, DIM=2), the port with ``device=cpu``.  Tolerances:

  * subPlt, combinePlts, regridPlt, template and npz2plt copy values: the
    plotfiles are equal file for file, byte for byte (headers, box lists,
    min/max tables, FABs);
  * avgPlotfiles, slicePlot, avgToPlane and plt2npz mode=flat compute:
    equal box lists and values within 1e-12 of each component's largest
    (images and text byte for byte where the values agree bitwise);
  * amrToFE text and flt bytes equal; interp columns within 1e-12 of
    each column's largest, and its text byte for byte;
  * the fcompare/fextrema printouts equal, and the same refusals and
    exits.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.io.plotfile import PlotfileReader as JaxReader
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader

RTOL = 1e-12
NEW_VERBS = ["avgPlotfiles", "combinePlts", "subPlt", "regridPlt",
             "avgToPlane", "slicePlot", "amrToFE", "interp", "plt2npz",
             "npz2plt", "fcompare", "fextrema", "template", "buildDistance"]


@pytest.fixture(scope="module")
def plts(tmp_path_factory):
    d = tmp_path_factory.mktemp("plt_tools")
    out = {"dir": d}
    for key, kw in (("a", {}), ("b", dict(refine_frac=0.25)),
                    ("one", dict(n_levels=1)),
                    ("a2", dict(ndim=2)),
                    ("b2", dict(ndim=2, refine_frac=0.25)),
                    ("per", dict(is_periodic=(True, True, True)))):
        out[key] = str(d / key)
        write_synthetic_plotfile(out[key], n_cell=16,
                                 **{"n_levels": 2, **kw})
    return out


@pytest.fixture
def both(monkeypatch, plts):
    """run(tool, args, out_key, name[, extra]) runs the port (device=cpu)
    and the JAX CLI with the output key ``out_key`` set to <dir>/port_name
    and <dir>/jax_name; returns the two paths."""
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    d = plts["dir"]
    monkeypatch.chdir(d)

    def run(tool, args, out_key, name):
        paths = []
        for who, main, extra in (("port", cli.main, ["device=cpu"]),
                                 ("jax", jax_cli.main, [])):
            p = str(d / f"{who}_{name}")
            assert main([tool, *args, f"{out_key}={p}", *extra]) == 0
            paths.append(p)
        return paths
    return run


def same_tree(a: str, b: str) -> None:
    """Two plotfile directories equal file for file, byte for byte."""
    fa = sorted(os.path.relpath(os.path.join(r, f), a)
                for r, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(r, f), b)
                for r, _, fs in os.walk(b) for f in fs)
    assert fa == fb
    for f in fa:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


def close_plotfiles(a: str, b: str, rtol: float = RTOL) -> None:
    """Same header layout and box lists; each component's values within
    rtol of its largest."""
    ra, rb = PlotfileReader(a), JaxReader(b)
    assert ra.var_names == rb.var_names
    assert ra.meta.n_levels == rb.meta.n_levels
    assert ra.meta.ndim == rb.meta.ndim
    assert ra.meta.ref_ratio == rb.meta.ref_ratio
    for lev in range(ra.meta.n_levels):
        assert [repr(b) for b in ra.box_array(lev)] == \
            [repr(b) for b in rb.box_array(lev)]
        assert repr(ra.meta.prob_domain[lev]) == \
            repr(rb.meta.prob_domain[lev])
        for c in range(len(ra.var_names)):
            x = np.concatenate([f[c].ravel() for f in ra.read_level(lev)])
            y = np.concatenate([f[c].ravel() for f in rb.read_level(lev)])
            scale = max(float(np.abs(y).max()), 1e-300)
            np.testing.assert_allclose(x, y, rtol=0, atol=rtol * scale)


def same_bytes(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


# -- copy tools: bitwise -----------------------------------------------------
@pytest.mark.parametrize("case, args", [
    ("a", ["comps1=temp", "comps2=density"]),
    ("a", ["comps1=density"]),
    ("a2", ["comps1=temp progress"]),
    ("b", ["comps2=density temp"])])
def test_combine_plts(both, plts, case, args):
    p, j = both("combinePlts", [f"infile1={plts[case]}",
                                f"infile2={plts[case]}", *args],
                "outfile", f"comb_{case}_{len(args)}")
    same_tree(p, j)


def test_combine_plts_reference_keys(both, plts, tmp_path):
    """infiles= vars=: each variable from the first file that has it."""
    src = str(tmp_path / "src")
    cli.main(["template", f"infile={plts['a']}", "vars=density",
              f"outfile={src}", "device=cpu"])
    p, j = both("combinePlts", [f"infiles={src} {plts['a']}",
                                "vars=temp density progress"],
                "outfile", "comb_ref")
    same_tree(p, j)
    assert PlotfileReader(p).var_names == ["density", "temp", "progress"]


def test_combine_plts_refuses_other_hierarchies(plts):
    for main, extra in ((cli.main, ["device=cpu"]), (jax_cli.main, [])):
        with pytest.raises(ValueError, match="different hierarchies"):
            main(["combinePlts", f"infile1={plts['a']}",
                  f"infile2={plts['b']}", "outfile=x", *extra])


@pytest.mark.parametrize("case, args", [
    ("a", ["box=4 4 4 11 11 11", "comps=temp"]),
    ("a", ["box=0 2 3 9 15 12", "sComp=1", "nComp=2"]),
    ("b", ["box=6 6 6 9 9 9"]),
    ("a2", ["box=2 3 12 10", "comps=temp progress"])])
def test_sub_plt(both, plts, case, args):
    p, j = both("subPlt", [f"infile={plts[case]}", *args], "outfile",
                f"sub_{case}_{len(args)}_{args[0][4]}")
    same_tree(p, j)
    r = PlotfileReader(p)
    if args[0] == "box=4 4 4 11 11 11":
        np.testing.assert_allclose(r.meta.prob_lo, (0.25, 0.25, 0.25))
        np.testing.assert_allclose(r.meta.prob_hi, (0.75, 0.75, 0.75))


@pytest.mark.parametrize("case, mgs", [("a", 4), ("a", 32), ("b", 3),
                                       ("a2", 5), ("per", 6)])
def test_regrid_plt(both, plts, case, mgs):
    p, j = both("regridPlt", [f"infile={plts[case]}", f"max_grid_size={mgs}"],
                "outfile", f"rg_{case}_{mgs}")
    same_tree(p, j)
    r, src = PlotfileReader(p), PlotfileReader(plts[case])
    for lev in range(2):
        assert r.box_array(lev).total_cells() == \
            src.box_array(lev).total_cells()


@pytest.mark.parametrize("case, args", [("a", []), ("a", ["vars=progress"]),
                                        ("a2", [])])
def test_template(both, plts, case, args):
    p, j = both("template", [f"infile={plts[case]}", *args], "outfile",
                f"tmpl_{case}_{len(args)}")
    same_tree(p, j)


# -- plt2npz / npz2plt -------------------------------------------------------
@pytest.mark.parametrize("case, args", [
    ("a", ["vars=temp"]), ("a", []), ("a", ["mode=flat", "vars=temp"]),
    ("b", ["mode=flat", "interp=pc"]), ("a2", ["mode=flat"]), ("a2", [])])
def test_plt2npz(both, plts, case, args):
    p, j = both("plt2npz", [f"infile={plts[case]}", *args], "outfile",
                f"x_{case}_{'_'.join(a.split('=')[1] for a in args)}.npz")
    zp, zj = np.load(p), np.load(j)
    assert sorted(zp.files) == sorted(zj.files)
    for k in zj.files:
        assert zp[k].dtype == zj[k].dtype and zp[k].shape == zj[k].shape, k
        if k == "data":
            scale = float(np.abs(zj[k]).max())
            np.testing.assert_allclose(zp[k], zj[k], rtol=0,
                                       atol=RTOL * scale)
        else:
            np.testing.assert_array_equal(zp[k], zj[k])


@pytest.mark.parametrize("mgs", [16, 64])
def test_npz2plt_roundtrip(both, plts, mgs):
    npz = str(plts["dir"] / f"rt_{mgs}.npz")
    assert jax_cli.main(["plt2npz", f"infile={plts['a']}", f"outfile={npz}",
                         "mode=flat", "vars=temp density"]) == 0
    p, j = both("npz2plt", [f"infile={npz}", f"max_grid_size={mgs}"],
                "outfile", f"rt_{mgs}")
    same_tree(p, j)
    # the archive round-trips bitwise
    r = PlotfileReader(p)
    z = np.load(npz)
    dense = np.zeros_like(z["data"])
    for i, b in enumerate(r.box_array(0)):
        dense[(slice(None),) + tuple(slice(b.lo[d], b.hi[d] + 1)
                                     for d in range(3))] = r.read_box(0, i)
    np.testing.assert_array_equal(dense, z["data"])
    assert r.var_names == ["temp", "density"]


# -- fcompare / fextrema: equal printouts ------------------------------------
def _printouts(capsys, args):
    outs = []
    for main, extra in ((cli.main, ["device=cpu"]), (jax_cli.main, [])):
        assert main([*args, *extra]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    return outs[0]


@pytest.fixture(scope="module")
def perturbed(plts):
    """The 'a' plotfile with 2.5 added to temp in one level-0 box, and a
    copy drifted by 1e-9 relative (float64 FABs)."""
    from peleanalysis_tpu.amr.hierarchy import AmrState
    st = AmrState.from_plotfile(plts["a"], dtype=np.float64)
    data = list(st.data)
    data[0] = data[0].at[0, st.comp("temp")].add(2.5)
    pert = str(plts["dir"] / "plt_pert")
    st.with_data(st.names, data).to_plotfile(pert)
    drift = str(plts["dir"] / "plt_drift")
    st.with_data(st.names, [d * (1.0 + 1e-9) for d in st.data]).to_plotfile(
        drift, dtype=np.float64)
    return {"pert": pert, "drift": drift}


@pytest.mark.parametrize("which, vars_", [
    ("self", []), ("pert", ["vars=temp"]), ("pert", []), ("drift", []),
    ("self2", [])])
def test_fcompare(capsys, plts, perturbed, which, vars_):
    a = plts["a2"] if which == "self2" else plts["a"]
    b = {"self": a, "self2": a}.get(which) or perturbed[which]
    out = _printouts(capsys, ["fcompare", f"infile1={a}", f"infile2={b}",
                              *vars_])
    assert ("PLOTFILES AGREE" in out) == which.startswith("self")
    if which == "pert" and vars_:
        assert "2.50000000e+00" in out


@pytest.mark.parametrize("case, vars_", [("a", ["vars=temp"]), ("a", []),
                                         ("a2", []), ("b", ["vars=density"])])
def test_fextrema(capsys, plts, case, vars_):
    out = _printouts(capsys, ["fextrema", f"infile={plts[case]}", *vars_])
    if vars_ == ["vars=temp"]:
        assert 250 < float(out.split()[-2]) < 400


@pytest.mark.parametrize("tol, which", [("atol=1.0", "pert"),
                                        ("rtol=1e-12", "drift")])
def test_fcompare_tolerance_exit(capsys, plts, perturbed, tol, which):
    for main, extra in ((cli.main, ["device=cpu"]), (jax_cli.main, [])):
        with pytest.raises(SystemExit, match=tol.split("=")[0]):
            main(["fcompare", f"infile1={plts['a']}",
                  f"infile2={perturbed[which]}", "vars=temp", tol, *extra])
    capsys.readouterr()


def test_fcompare_refuses_other_boxarrays(plts):
    rg = str(plts["dir"] / "rg_for_fcompare")
    assert jax_cli.main(["regridPlt", f"infile={plts['a']}",
                         f"outfile={rg}", "max_grid_size=4"]) == 0
    for main, extra in ((cli.main, ["device=cpu"]), (jax_cli.main, [])):
        with pytest.raises(ValueError, match="BoxArrays"):
            main(["fcompare", f"infile1={plts['a']}", f"infile2={rg}",
                  *extra])


# -- slicePlot / avgToPlane --------------------------------------------------
def _pal(d):
    pal = np.zeros((256, 3), np.uint8)
    pal[:, 0] = np.arange(256)       # red ramp
    path = str(d / "ramp.pal")
    pal.tofile(path)
    return path


def _close_planes(a: str, b: str, ext: str, tol: float) -> None:
    """Two FAB or text planes within tol of the larger's largest value."""
    if ext == "fab":
        from peleanalysis_tpu_torch.io.fab import read_fab
        with open(a, "rb") as fa, open(b, "rb") as fb:
            (box_a, x), (box_b, y) = read_fab(fa), read_fab(fb)
        assert box_a == box_b
    else:
        x, y = np.loadtxt(a), np.loadtxt(b)
    assert x.shape == y.shape
    np.testing.assert_allclose(x, y, rtol=0, atol=tol * np.abs(y).max())


# float64 state: within 1e-12 (images byte for byte).  A float32 state's
# fill rounds apart from XLA's, which may contract a multiply-add: a slice
# within 1e-6 (a few float32 ulps), an average (a float32 sum of up to 32
# terms in another order) within 1e-5
PLANE_TOL = {("slicePlot", "float64"): RTOL, ("avgToPlane", "float64"): RTOL,
             ("slicePlot", "float32"): 1e-6, ("avgToPlane", "float32"): 1e-5}


@pytest.mark.parametrize("case, args, ext, dtype", [
    ("a", ["varname=temp", "slicedir=2", "sliceloc=16", "outtype=gray",
           "min=300", "max=1800"], "pgm", "float64"),
    ("a", ["varname=temp", "slicedir=2", "sliceloc=16", "outtype=image",
           "palette"], "ppm", "float64"),
    ("a", ["varname=temp", "slicedir=0", "sliceloc=3", "outtype=fab"],
     "fab", "float64"),
    ("a", ["varname=temp", "slicedir=0", "sliceloc=3", "outtype=fab"],
     "fab", "float32"),
    ("b", ["var=progress", "dir=1", "format=ppm"], "ppm", "float64"),
    ("a", ["var=density", "dir=2", "loc=0.3", "format=pgm"], "pgm",
     "float64"),
    ("a2", ["varname=temp", "slicedir=1", "sliceloc=40", "outtype=fab"],
     "fab", "float32")])
def test_slice_plot(both, plts, case, args, ext, dtype):
    args = [f"palette={_pal(plts['dir'])}" if a == "palette" else a
            for a in args]
    key = "file" if args[0].startswith("varname") else "infile"
    p, j = both("slicePlot", [f"{key}={plts[case]}", *args, f"dtype={dtype}"],
                "outfile",
                f"slice_{case}_{args[0]}_{args[1]}_{len(args)}_{dtype}.{ext}")
    if ext == "fab":
        _close_planes(p, j, ext, PLANE_TOL["slicePlot", dtype])
    else:
        same_bytes(p, j)


@pytest.mark.parametrize("case, args, ext, dtype", [
    ("a", ["vars=temp", "dir=2", "format=dat"], "dat", "float64"),
    ("a", ["vars=temp", "dir=2", "format=dat"], "dat", "float32"),
    ("a", ["vars=temp density", "dir=0", "format=ppm"], "ppm", "float64"),
    ("b", ["vars=progress", "dir=1"], "fab", "float64"),
    ("b", ["vars=progress", "dir=1"], "fab", "float32"),
    ("a2", ["vars=temp", "dir=2", "format=dat"], "dat", "float64")])
def test_avg_to_plane(both, plts, case, args, ext, dtype):
    p, j = both("avgToPlane", [f"infile={plts[case]}", *args,
                               f"dtype={dtype}"],
                "outfile_base", f"ap_{case}_{args[1]}_{dtype}")
    for n in args[0].split("=")[1].split():
        a, b = f"{p}_{n}.{ext}", f"{j}_{n}.{ext}"
        if ext == "ppm":
            same_bytes(a, b)
        else:
            _close_planes(a, b, ext, PLANE_TOL["avgToPlane", dtype])


# -- avgPlotfiles ------------------------------------------------------------
@pytest.mark.parametrize("files, args", [
    (("a", "a"), []),
    (("a", "b"), []),
    (("a", "b"), ["interp_type=2"]),
    (("a", "one"), []),
    (("one", "a", "b"), ["interp_type=2", "output_max_grid_size=8"]),
    (("a", "b"), ["vars=temp", "output_max_level=0"]),
    (("a2", "b2"), []),
    (("a2", "b2"), ["interp_type=2", "prefetch=0"])])
def test_avg_plotfiles(both, plts, files, args):
    p, j = both("avgPlotfiles", [
        f"infile={' '.join(plts[f] for f in files)}", *args], "outfile",
        f"avg_{'_'.join(files)}_{len(args)}_{args[0] if args else ''}")
    close_plotfiles(p, j)
    r = PlotfileReader(p)
    if files[0] == "a2":
        assert r.meta.ndim == 2


# -- amrToFE -----------------------------------------------------------------
@pytest.mark.parametrize("case, args", [
    ("a", ["vars=temp", "outType=tec"]),
    ("a", ["vars=temp", "outType=tec", "connect_cc=0"]),
    ("a", ["outType=flt"]),
    ("a", ["vars=temp density", "outType=flt", "connect_cc=0"]),
    ("b", ["sComp=1", "nComp=2", "box=2 2 2 12 9 13"]),
    ("a2", ["vars=temp", "outType=tec"]),
    ("a2", ["vars=temp", "outType=tec", "connect_cc=0"]),
    ("a2", ["vars=temp", "outType=flt"]),
    ("per", ["vars=temp", "nGrowPer=2"]),
    ("one", ["comps=progress", "finestLevel=0", "box=3 3 3 9 9 9"])])
def test_amr_to_fe(both, plts, case, args):
    p, j = both("amrToFE", [f"infile={plts[case]}", *args], "outfile",
                f"fe_{case}_{'_'.join(a.split('=')[1] for a in args)}")
    same_bytes(p, j)
    if "outType=flt" not in args:
        txt = open(p).read()
        et = "QUADRILATERAL" if case == "a2" else "BRICK"
        assert f"ET={et}" in txt


def test_amr_to_fe_corner_counts(both, plts):
    p, _ = both("amrToFE", [f"infile={plts['a']}", "vars=temp",
                            "connect_cc=0"], "outfile", "fe_corner_counts")
    import re
    m = re.search(r"N=(\d+) E=(\d+)", open(p).read().splitlines()[1])
    assert int(m.group(2)) == 16 ** 3 - 8 ** 3
    assert int(m.group(1)) <= 17 ** 3


# -- interp ------------------------------------------------------------------
@pytest.fixture(scope="module")
def interp_case(plts):
    d = plts["dir"]
    plt = str(d / "plt_interp")
    write_synthetic_plotfile(
        plt, n_cell=16, n_levels=2,
        fields={"temp": lambda x, y, z: 2.0 * x + 3.0 * y - z,
                "progress": lambda x, y, z: x * x + y * y})
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.05, 1.05, (60, 3))
    pts[:15] = rng.uniform(0.3, 0.7, (15, 3))      # inside the fine level
    path = str(d / "pts.xyz")
    np.savetxt(path, pts, header="x y z")
    return plt, path, pts


@pytest.mark.parametrize("fmt, dtype", [("dat", "float32"),
                                        ("csv", "float32"),
                                        ("dat", "float64")])
def test_interp(both, interp_case, fmt, dtype):
    plt, pts_file, pts = interp_case
    p, j = both("interp", [f"infile={plt}", "vars=temp progress",
                           f"points={pts_file}", f"fmt={fmt}",
                           f"dtype={dtype}"], "out", f"samp_{fmt}_{dtype}")
    lp, lj = open(p).read().splitlines(), open(j).read().splitlines()
    assert lp[0] == lj[0] and len(lp) == len(lj) == 61
    sep = "," if fmt == "csv" else None
    x = np.array([[float(v) for v in ln.split(sep)] for ln in lp[1:]])
    y = np.array([[float(v) for v in ln.split(sep)] for ln in lj[1:]])
    np.testing.assert_array_equal(x[:, :3], pts)
    assert (np.abs(x - y) <= RTOL * np.abs(y).max(axis=0)).all()
    # the native formatter writes Python's "%.17g" text of the same values
    sep = "," if fmt == "csv" else " "
    assert lp[1:] == [sep.join(f"{v:.17g}" for v in row) for row in x]


# -- CLI surface -------------------------------------------------------------
def test_doctor_reports_without_a_card(capsys):
    assert cli.main(["doctor", "probe_timeout=60"]) == 0
    out = capsys.readouterr().out
    assert "peleanalysis_tpu_torch doctor" in out
    assert "torch:" in out and "numpy:" in out and "native lib: OK" in out
    if not torch.cuda.is_available():
        assert "cuda:      not available" in out


@pytest.mark.parametrize("verb", NEW_VERBS)
def test_new_verbs_default_to_the_card(plts, verb):
    """device= defaults to cuda: without a card the verb raises before it
    reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device=cpu"):
        cli.main([verb, f"infile={plts['a']}", f"infile1={plts['a']}",
                  f"infile2={plts['a']}", "box=0 0 0 1 1 1", "vars=temp",
                  "points=none", "isoFile=none", "outfile=none"])
