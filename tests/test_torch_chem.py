"""Parity of the port's chemistry tools with the JAX package's, on the CPU.

Each of the seven verbs (plotXtoY, plotYtoX, plotTransportCoeff,
plotTYtoLe, plotQPD, sCO2, buildPMF) runs through
``peleanalysis_tpu_torch.cli.main([...], device=cpu)`` and
``peleanalysis_tpu.cli.main([...])`` on the same synthetic plotfiles: a
3-level one (16^3 base) and a sparse 2-level one whose finest level takes
the clustered parts (``amr.cluster.level_parts``).  Tolerances:

  * plotfiles: the Header files equal, box lists equal, values within
    1e-12 relative (the conversions add their species sums in numpy's
    order and are bitwise in practice; transport takes ``T ** 1.5`` and
    NASA7 powers through another libm);
  * plotQPD: edge lines equal as tokens (species, order), values within
    1e-10 relative, the NormVal printout within 1e-10 (the kinetics' cell
    sums run in another order, its logs and exps through another libm);
  * sCO2: ``mean.dat``/``mcmt.dat`` values and ``bins2d_*.npy`` within
    1e-12 (the flatten's upsample and the slab sums round apart), with
    NaN, +-inf and huge adv cells binned as numpy bins them;
  * buildPMF: both files byte for byte.
The mechanism, thermo, transport and QPD edge functions are held to JAX's
directly.
"""
import contextlib
import glob
import io
import os

import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu.chem import mechanism as jm
from peleanalysis_tpu.chem import qpd as jq
from peleanalysis_tpu.io.plotfile import PlotfileReader as JaxReader
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch.amr.cluster import needs_clustering
from peleanalysis_tpu_torch.chem import mechanism as pm
from peleanalysis_tpu_torch.chem import qpd as pq
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.testing import (fraction_fields, nasa7_lines,
                                            synthetic_mechanism,
                                            write_scattered_plotfile)
from peleanalysis_tpu_torch.tools.sco2 import trunc_bins

RTOL = 1e-12
QPD_RTOL = 1e-10
SPECIES = ["H2", "H", "O", "O2", "OH", "H2O", "HO2", "CH3", "CH4", "CO",
           "CO2", "N2"]
VERBS = ["plotXtoY", "plotYtoX", "plotTransportCoeff", "plotTYtoLe",
         "plotQPD", "sCO2", "buildPMF"]


def _r2(x, y, z):
    return (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2


def chem_fields(prefix="X", temp="temp"):
    f = fraction_fields(SPECIES, prefix)
    f[temp] = lambda x, y, z: 600.0 + 1400.0 * np.exp(-_r2(x, y, z) / 0.05)
    f["density"] = lambda x, y, z: 1.0 / (1.0 + 4.0 * np.exp(
        -_r2(x, y, z) / 0.05))
    return f


def adv0(x, y, z):
    """adv_0 in [0, 1] with bands of NaN, +-inf and +-1e30 cells."""
    v = np.clip(x + 0.3 * np.sin(7 * y), 0.0, 1.0)
    band = y < 0.2
    for (lo, hi), bad in (((0.40, 0.45), np.nan), ((0.60, 0.65), np.inf),
                          ((0.70, 0.75), -np.inf), ((0.80, 0.85), 1e30),
                          ((0.20, 0.25), -1e30)):
        v = np.where(band & (x > lo) & (x < hi), bad, v)
    return v


SCO2_FIELDS = {
    "adv_0": adv0,
    "adv_1": lambda x, y, z: np.clip(1.1 * y - 0.05, 0.0, 1.0),
    "Var1": lambda x, y, z: 2.0 + np.sin(3 * x) * np.cos(2 * z),
    "Var2": lambda x, y, z: x,
    "Var3": lambda x, y, z: y * z,
    "vfrac": lambda x, y, z: 0.5 + 0.5 * np.cos(x * y)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("chem")
    out = {"dir": d}
    for key, fields in (("X", chem_fields("X")),
                        ("Y", chem_fields("Y", "Temp"))):
        out[key] = str(d / f"plt_{key}")
        write_synthetic_plotfile(out[key], n_cell=16, n_levels=3,
                                 max_grid_size=8, fields=fields)
        out[key + "_sparse"] = str(d / f"sparse_{key}")
        meta, _, _ = write_scattered_plotfile(
            out[key + "_sparse"], n0=48, ratio=4, n_clusters=4, fine_box=16,
            fields=fields)
        assert needs_clustering(meta.bas[-1])
    out["sco2"] = str(d / "plt_sco2")
    write_synthetic_plotfile(out["sco2"], n_cell=16, n_levels=3,
                             max_grid_size=8, fields=SCO2_FIELDS)
    out["rates"] = str(d / "plt_rates")
    write_synthetic_plotfile(out["rates"], n_cell=8, n_levels=2, fields={
        f"rate_{i}": (lambda x, y, z, i=i: (i + 1.0) * (1.0 + x * y - z))
        for i in range(3)})
    out["mech"] = str(d / "mech.inp")
    with open(out["mech"], "w") as f:
        f.write(synthetic_mechanism(SPECIES, 24, seed=3, first=[
            "CH4 + OH => CH3 + H2O   1.0E08 1.6 3120."]))
    out["bare"] = str(d / "bare.inp")
    with open(out["bare"], "w") as f:
        f.write("CH4 + OH <=> CH3 + H2O\nCO + OH <=> CO2 + H\n"
                "CO + O2 <=> CO2 + O\n")
    out["therm"] = str(d / "therm.dat")
    with open(out["therm"], "w") as f:
        f.write("THERMO\n   300.000  1000.000  5000.000\n" + "\n".join(
            nasa7_lines(s, [3.6 + 0.1 * k, 4e-4, -1e-7, 1e-11, -4e-16,
                            -1000.0, 3.0],
                        [3.3 + 0.1 * k, 1e-3, -2e-7, 2e-11, -1e-15, -900.0,
                         2.0], (1000.0, 1200.0)[k % 2])
            for k, s in enumerate(SPECIES)) + "\nEND\n")
    return out


@pytest.fixture
def both(data, monkeypatch):
    """run(tool, args, name, out_key) runs the JAX CLI and the port
    (device=cpu) with ``out_key`` set to <dir>/jax_<name> and
    <dir>/port_<name> (no output key when None), in the data directory;
    returns {who: (output path, stdout)}."""
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.chdir(data["dir"])

    def run(tool, args, name, out_key="outfile"):
        res = {}
        for who, main, extra in (("jax", jax_cli.main, []),
                                 ("port", cli.main, ["device=cpu"])):
            path = str(data["dir"] / f"{who}_{name}")
            out = [f"{out_key}={path}"] if out_key else []
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main([tool, *args, *out, *extra]) == 0
            res[who] = (path, buf.getvalue())
        return res
    return run


def close_plotfiles(port: str, jax: str, rtol: float = RTOL) -> None:
    """The Header files equal, the box lists equal, every value within
    rtol of JAX's (relative)."""
    with open(os.path.join(port, "Header")) as a, \
            open(os.path.join(jax, "Header")) as b:
        assert a.read() == b.read()
    ra, rb = PlotfileReader(port), JaxReader(jax)
    for lev in range(ra.meta.n_levels):
        assert [repr(b) for b in ra.box_array(lev)] == \
            [repr(b) for b in rb.box_array(lev)]
        for fa, fb in zip(ra.read_level(lev), rb.read_level(lev)):
            np.testing.assert_allclose(fa, fb, rtol=rtol, atol=1e-300)


# -- mechanism, thermo, transport, edges ---------------------------------------
def test_conversions_match_numpy():
    mp, mj = pm.Mechanism(SPECIES), jm.Mechanism(SPECIES)
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 1.0, (len(SPECIES), 6, 5))
    X[:, 0, 0] = 0.0                      # an empty cell: the 1e-300 guard
    Xt = torch.from_numpy(X)
    for f in ("x_to_y", "y_to_x", "mean_weight_from_y"):
        np.testing.assert_array_equal(getattr(mp, f)(Xt).numpy(),
                                      getattr(mj, f)(X))
    Y = mp.x_to_y(Xt)
    np.testing.assert_allclose(mp.y_to_x(Y)[:, 1:].numpy(),
                               X[:, 1:] / X[:, 1:].sum(axis=0), rtol=RTOL)


def test_thermo_and_t_from_h_match_numpy(data):
    th_p = pm.parse_chemkin_thermo(data["therm"])
    th_j = jm.parse_chemkin_thermo(data["therm"])
    mp, mj = pm.Mechanism(SPECIES, th_p), jm.Mechanism(SPECIES, th_j)
    rng = np.random.default_rng(1)
    T = rng.uniform(300.0, 2500.0, 64)
    Y = mj.x_to_y(rng.uniform(0.1, 1.0, (len(SPECIES), 64)))
    Tt, Yt = torch.from_numpy(T), torch.from_numpy(Y)
    for f in ("cp_mass", "h_mass"):
        np.testing.assert_allclose(getattr(mp, f)(Tt, Yt).numpy(),
                                   getattr(mj, f)(T, Y), rtol=RTOL)
    # Newton's inversion of h, on thermo continuous at T-mid
    mp.thermo = {s: pm.Nasa7(200.0, 1000.0, 6000.0, t.lo, t.lo)
                 for s, t in th_p.items()}
    mj.thermo = {s: jm.Nasa7(200.0, 1000.0, 6000.0, t.lo, t.lo)
                 for s, t in th_j.items()}
    h = mj.h_mass(T, Y)
    T2 = mp.T_from_h(torch.from_numpy(h), Yt).numpy()
    np.testing.assert_allclose(T2, mj.T_from_h(h, Y), rtol=RTOL)
    np.testing.assert_allclose(T2, T, rtol=1e-8)


def test_transport_matches_numpy():
    tp = pm.SimpleTransport(mu_ref=2e-4, prandtl=0.8, lewis=1.3)
    tj = jm.SimpleTransport(mu_ref=2e-4, prandtl=0.8, lewis=1.3)
    T = np.linspace(300.0, 2500.0, 50)
    cp = np.linspace(1e7, 1.5e7, 50)
    rho = np.linspace(1e-4, 1e-3, 50)
    Tt, cpt, rhot = (torch.from_numpy(a) for a in (T, cp, rho))
    np.testing.assert_allclose(tp.viscosity(Tt).numpy(), tj.viscosity(T),
                               rtol=RTOL)
    np.testing.assert_allclose(tp.diffusivity(Tt, rhot, cpt).numpy(),
                               tj.diffusivity(T, rho, cp), rtol=RTOL)


@pytest.mark.parametrize("elt", ["C", "H", "O"])
def test_qpd_edges_match(data, elt):
    from peleanalysis_tpu.chem.kinetics import parse_chemkin
    _, krxns, _ = parse_chemkin(data["mech"])
    eqs = [r.label for r in krxns]
    ep = pq.get_edges([pq.parse_reaction(e) for e in eqs], elt)
    ej = jq.get_edges([jq.parse_reaction(e) for e in eqs], elt)
    assert [(e.sp1, e.sp2, e.rwl) for e in ep] == \
        [(e.sp1, e.sp2, e.rwl) for e in ej]
    rates = np.random.default_rng(2).normal(size=len(eqs))
    assert pq.edge_fluxes(ep, rates) == jq.edge_fluxes(ej, rates)


def test_trunc_bins_match_numpy_casts():
    """numpy's astype(int) then clip, NaN/+-inf/huge included (x86 turns
    them into INT64_MIN, so bin 0)."""
    v = np.array([0.0, 0.1, 0.4999, 0.5, 0.99, 1.0, 1.5, -0.01, -0.5, -1.0,
                  -3.0, np.nan, np.inf, -np.inf, 1e30, -1e30, 2.0 ** 63,
                  2.0 ** 62, 1e18, np.nextafter(1.0 / 7.0, 0.0)])
    with np.errstate(invalid="ignore"):
        for nb in (2, 8, 64):
            want = np.clip(((nb - 1) * v).astype(int), 0, nb - 1)
            got = trunc_bins(torch.from_numpy(v), nb).numpy()
            np.testing.assert_array_equal(got, want)


# -- the verbs -------------------------------------------------------------------
def test_tools_are_the_jax_clis():
    assert set(cli.TOOLS) == set(jax_cli.TOOLS) and len(cli.TOOLS) == 56


@pytest.mark.parametrize("verb", VERBS)
def test_verbs_ask_for_the_card(data, verb):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=cuda is valid here")
    with pytest.raises(RuntimeError, match="not available"):
        cli.main([verb, f"infile={data['X']}", f"mech_file={data['mech']}",
                  "comps=0 1 2 3 4 5", "planeCoord=0"])


@pytest.mark.parametrize("case", ["X", "X_sparse"])
def test_plot_x_to_y(both, data, case):
    r = both("plotXtoY", [f"infile={data[case]}"], f"xy_{case}")
    close_plotfiles(r["port"][0], r["jax"][0])
    assert r["port"][1] == r["jax"][1]
    # mass fractions sum to 1
    ra = PlotfileReader(r["port"][0])
    for lev in range(ra.meta.n_levels):
        for fab in ra.read_level(lev):
            np.testing.assert_allclose(fab[:len(SPECIES)].sum(axis=0), 1.0,
                                       rtol=RTOL)


@pytest.mark.parametrize("case", ["Y", "Y_sparse"])
def test_plot_y_to_x(both, data, case):
    r = both("plotYtoX", [f"infile={data[case]}", "finestLevel=1"],
             f"yx_{case}")
    close_plotfiles(r["port"][0], r["jax"][0])


def test_x_to_y_to_x_round_trip(data, tmp_path):
    y, x = str(tmp_path / "y"), str(tmp_path / "x")
    assert cli.main(["plotXtoY", f"infile={data['X']}", f"outfile={y}",
                     "device=cpu"]) == 0
    assert cli.main(["plotYtoX", f"infile={y}", f"outfile={x}",
                     "device=cpu"]) == 0
    ra, rb = PlotfileReader(x), PlotfileReader(data["X"])
    assert ra.var_names == [f"X({s})" for s in SPECIES] + ["temp"]
    for lev in range(ra.meta.n_levels):
        for fa, fb in zip(ra.read_level(lev),
                          rb.read_level(lev, list(range(len(SPECIES) + 1)))):
            np.testing.assert_allclose(fa, fb, rtol=RTOL)


@pytest.mark.parametrize("tool, case, args", [
    ("plotTransportCoeff", "X", []),
    ("plotTransportCoeff", "Y_sparse", ["mu_ref=2e-4", "prandtl=0.75"]),
    ("plotTransportCoeff", "Y", ["thermo"]),
    ("plotTYtoLe", "X_sparse", []),
    ("plotTYtoLe", "Y", ["lewis=1.4", "thermo"])])
def test_transport_verbs(both, data, tool, case, args):
    args = [f"thermo_file={data['therm']}" if a == "thermo" else a
            for a in args]
    r = both(tool, [f"infile={data[case]}", *args],
             f"{tool}_{case}_{len(args)}")
    close_plotfiles(r["port"][0], r["jax"][0])


def test_lewis_one(data, tmp_path):
    out = str(tmp_path / "le")
    assert cli.main(["plotTYtoLe", f"infile={data['Y']}", f"outfile={out}",
                     f"thermo_file={data['therm']}", "device=cpu"]) == 0
    ra = PlotfileReader(out)
    for lev in range(ra.meta.n_levels):
        for fab in ra.read_level(lev):
            np.testing.assert_allclose(fab, 1.0, rtol=1e-14)


def _edges(text: str):
    lines = text.splitlines()
    rows = [ln.split() for ln in lines[2:]]
    return lines[:2], [r[:2] for r in rows], np.array(
        [[float(v) for v in r[2:]] for r in rows])


def _normval(said: str) -> float:
    return float(said.split("NormVal: ")[1].split()[0])


def close_qpd(r) -> None:
    """Edge files: header lines and edge tokens equal, values within
    QPD_RTOL; printouts equal but for their numbers, NormVal within
    QPD_RTOL."""
    (pp, ps), (jp, js) = r["port"], r["jax"]
    hp, ep, vp = _edges(open(pp).read())
    hj, ej, vj = _edges(open(jp).read())
    assert hp[1] == hj[1] and ep == ej
    np.testing.assert_allclose(vp, vj, rtol=QPD_RTOL, atol=0)
    np.testing.assert_allclose(_normval(ps), _normval(js), rtol=QPD_RTOL)
    def words(said, path):
        return [[w for w in ln.split() if not w[0].isdigit()
                 and not w[1:2].isdigit()]
                for ln in said.replace(path, "OUT").splitlines()]
    assert words(ps, pp) == words(js, jp)


@pytest.mark.parametrize("case, args", [
    ("X", ["QPDatom=C"]),
    ("X_sparse", ["QPDatom=C", "fuelSpec=CH4"]),
    ("X", ["QPDatom=H", "dump_edges=1", "fuelSpec=H2O"]),
    ("X", ["QPDatom=O", "densityUnits=cgs", "scaleNorm=2.5",
           "finestLevel=1"])])
def test_plot_qpd_kinetics(both, data, case, args):
    r = both("plotQPD", [f"mech_file={data['mech']}",
                         f"infile={data[case]}", *args],
             f"qpd_{case}_{len(args)}", "QPDfileName")
    close_qpd(r)
    assert "NormVal" in r["port"][1]


def test_plot_qpd_rate_base(both, data):
    r = both("plotQPD", [f"mech_file={data['bare']}",
                         f"infile={data['rates']}", "rateBase=rate"],
             "qpd_rates", "QPDfileName")
    close_qpd(r)


def test_plot_qpd_edges_only(both, data):
    r = both("plotQPD", [f"mech_file={data['bare']}", "trace_element=C",
                         "dump_edges=1"], "qpd_edges", "outfile")
    assert open(r["port"][0]).read() == open(r["jax"][0]).read()
    assert r["port"][1].replace(r["port"][0], "") == \
        r["jax"][1].replace(r["jax"][0], "")


def test_plot_qpd_uniform_field_closed_form(data, tmp_path):
    """Uniform fields: each reaction's integral is Q x V_domain (the valid
    cells tile the domain across levels), so CO->CO2 over CH4->CH3 is
    q2 / q1 exactly as tests/test_kinetics.py has it."""
    sp = ["CH4", "CH3", "H2O", "OH", "O2", "CO", "CO2", "H"]
    Xv = np.array([0.1, 0.01, 0.05, 0.02, 0.2, 0.1, 0.02, 0.5])
    fields = {f"X({s})": (lambda x, y, z, v=v: v + 0 * x)
              for s, v in zip(sp, Xv)}
    fields["temp"] = lambda x, y, z: 1000.0 + 0 * x
    fields["density"] = lambda x, y, z: 0.5 + 0 * x
    plt = str(tmp_path / "plt")
    write_synthetic_plotfile(plt, n_cell=8, n_levels=2, fields=fields)
    mf = str(tmp_path / "c.inp")
    with open(mf, "w") as f:
        f.write("SPECIES\n" + " ".join(sp) + "\nEND\nREACTIONS\n"
                "CH4 + OH => CH3 + H2O    1.0E12  0.0  0.\n"
                "CO + OH => CO2 + H       2.0E12  0.0  0.\nEND\n")
    out = str(tmp_path / "qpd.dat")
    assert cli.main(["plotQPD", f"mech_file={mf}", f"infile={plt}",
                     "QPDatom=C", f"QPDfileName={out}", "device=cpu"]) == 0
    W = np.array([pm.molecular_weight(s) for s in sp])
    C = Xv * 0.5e-3 / (Xv @ W)
    _, edges, vals = _edges(open(out).read())
    got = dict(zip(map(tuple, edges), vals[:, 0]))
    np.testing.assert_allclose(got[("CH4", "CH3")], 1.0, rtol=QPD_RTOL)
    np.testing.assert_allclose(got[("CO", "CO2")], 2.0 * C[5] / C[0],
                               rtol=QPD_RTOL)


@pytest.mark.parametrize("plane, args", [
    (0, ["nBins=8", "nBinPlanes=5"]),
    (1, ["nBins=16", "nBinPlanes=7", "finestLevel=1"]),
    (2, ["nBins=8", "nBinPlanes=64"])])
def test_sco2(both, data, plane, args):
    r = both("sCO2", [f"infile={data['sco2']}",
                      "comps=adv_0 adv_1 Var1 Var2 Var3 vfrac",
                      f"planeCoord={plane}", *args],
             f"sco2_{plane}", "output_dir")
    (pd, ps), (jd, js) = r["port"], r["jax"]
    assert ps.replace(pd, "") == js.replace(jd, "")
    for f in ("mean.dat", "mcmt.dat"):
        a, b = np.loadtxt(f"{pd}/{f}"), np.loadtxt(f"{jd}/{f}")
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL)
    names = sorted(os.path.basename(p) for p in glob.glob(f"{jd}/bins2d_*"))
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(f"{pd}/bins2d_*"))
    for n in names:
        a, b = np.load(f"{pd}/{n}"), np.load(f"{jd}/{n}")
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
        assert (b != 0).any()


def test_sco2_comps_by_index(both, data):
    names = PlotfileReader(data["sco2"]).var_names
    comps = " ".join(str(names.index(n)) for n in SCO2_FIELDS)
    r = both("sCO2", [f"infile={data['sco2']}", f"comps={comps}",
                      "planeCoord=2", "nBins=4"], "sco2_idx", "output_dir")
    for f in ("mean.dat", "mcmt.dat"):
        np.testing.assert_allclose(np.loadtxt(f"{r['port'][0]}/{f}"),
                                   np.loadtxt(f"{r['jax'][0]}/{f}"),
                                   rtol=RTOL)


@pytest.mark.parametrize("header, fortran", [(True, True), (False, False)])
def test_build_pmf(both, data, header, fortran):
    x = np.linspace(0.0, 1.0, 41)
    tbl = np.column_stack([x, 300 + 1500 * x ** 2, np.exp(-x), x / 3])
    src = str(data["dir"] / f"flame_{header}.dat")
    with open(src, "w") as f:
        if header:
            f.write('VARIABLES = "X" "T" "Y(H2)" "Y(O2)"\n')
            f.write("ZONE I=41\n")
        np.savetxt(f, tbl)
    r = both("buildPMF", [f"infile={src}"], f"pmf_{header}.dat")
    assert open(r["port"][0], "rb").read() == open(r["jax"][0], "rb").read()
    if fortran:
        f90 = {}
        for who, main, dev in (("jax", jax_cli.main, []),
                               ("port", cli.main, ["device=cpu"])):
            path = str(data["dir"] / f"{who}_{header}.f90")
            with contextlib.redirect_stdout(io.StringIO()):
                assert main(["buildPMF", f"infile={src}",
                             f"outfile={path}.dat", f"fortran={path}",
                             *dev]) == 0
            f90[who] = open(path, "rb").read()
        assert f90["port"] == f90["jax"] and b"pmf_N = 41" in f90["port"]


def test_synthetic_mechanism_is_atom_balanced(tmp_path):
    """The mechanism generator behind the tests and the chip smoke run:
    every reaction balanced, every form present, the first line kept."""
    from peleanalysis_tpu_torch.chem.kinetics import Kinetics, parse_chemkin
    drm19 = ("H2 H O O2 OH H2O HO2 CH2 CH2(S) CH3 CH4 CO CO2 HCO CH2O CH3O "
             "C2H4 C2H5 C2H6 N2 AR").split()
    path = str(tmp_path / "m.inp")
    with open(path, "w") as f:
        f.write(synthetic_mechanism(drm19, 84, first=[
            "CH4 + OH => CH3 + H2O   1.0E08 1.6 3120."]))
    sp, rxns, th = parse_chemkin(path)
    assert sp == drm19 and len(rxns) == 84 and set(th) == set(drm19)
    assert rxns[0].label == "CH4 + OH => CH3 + H2O"
    for r in rxns:
        count = {}
        for side, sgn in ((r.reactants, -1), (r.products, 1)):
            for s, c in side.items():
                for e, n in pm.parse_formula(s).items():
                    count[e] = count.get(e, 0) + sgn * c * n
        assert not any(count.values()), r.label
    kin = Kinetics(sp, rxns, th)
    assert all(v.sum() > 0 for v in (
        kin.troe_mask, kin.sri_mask, kin.tb_mask, kin.rev_arrh,
        kin.kf_sign < 0, kin.rev_mask == 0, kin.troe_has_t2,
        kin.fo_mask - kin.troe_mask - kin.sri_mask))
