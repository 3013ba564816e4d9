"""Parity of the port's HIT tools with the JAX package's:
``turbulenceSpectra`` (``energy_spectrum`` and ``turbulence_stats``, float64
within 1e-10 of the largest shell: the FFTs and the shell sums round in
another order, about 1e-15 of it) and the four ``turbulence_post`` verbs
on the ``hit_run`` fields of tests/test_turbulence_post.py at 16^3
(``tseries.csv`` and ``_slice.dat`` values within 1e-12 relative, the
augmented plotfile's five new components within 1e-12 of the vorticity's
scale), with that file's analytic checks repeated on the port."""
import numpy as np
import pytest
import torch

from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu.tools.turbulence_spectra import \
    energy_spectrum as jax_spectrum
from peleanalysis_tpu.tools.turbulence_spectra import \
    turbulence_stats as jax_stats
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader
from peleanalysis_tpu_torch.testing import hit_fields
from peleanalysis_tpu_torch.tools.turbulence_spectra import (
    energy_spectrum, turbulence_stats)

FIELDS = {
    "x_velocity": lambda x, y, z: np.sin(2 * np.pi * y),
    "y_velocity": lambda x, y, z: np.sin(2 * np.pi * z),
    "z_velocity": lambda x, y, z: np.sin(2 * np.pi * x),
    "temp": lambda x, y, z: 300.0 + 10 * np.cos(2 * np.pi * x),
    "density": lambda x, y, z: 1.0 + 0 * x,
}
IC = "urms0, lambda0, tau, T0, Mach, c_s0\n1.0, 0.5, 0.2, 300.0, 0.1, 340.0\n"


def _close_spectrum(got, want):
    (kg, eg), (kw, ew) = got, want
    np.testing.assert_array_equal(kg, kw)
    np.testing.assert_allclose(eg, np.asarray(ew), rtol=0,
                               atol=1e-10 * float(np.abs(ew).max()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape, lengths", [
    ((16, 16, 16), (1.0, 1.0, 1.0)), ((12, 16, 20), (2.0, 1.0, 0.5)),
    ((16, 24), (1.0, 3.0))])
def test_energy_spectrum_and_stats_parity(shape, lengths):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    vel = [rng.standard_normal(shape) + 0.3 for _ in range(len(shape))]
    w = vel[2] if len(shape) == 3 else None
    want = jax_spectrum(vel[0], vel[1], w, lengths)
    got = energy_spectrum(_t(vel[0]), _t(vel[1]),
                          None if w is None else _t(w), lengths)
    _close_spectrum(got, want)
    s_want = jax_stats(vel[0], vel[1], w)
    s_got = turbulence_stats(_t(vel[0]), _t(vel[1]),
                             None if w is None else _t(w))
    assert s_got.keys() == s_want.keys()
    for k in s_want:
        np.testing.assert_allclose(s_got[k], s_want[k], rtol=1e-12)


def test_single_mode_parseval():
    """tests/test_stats.py:231-260 on the port: one Fourier mode k = 4
    holds all the energy, and sum(E) = 0.5 <u'^2> = 0.25."""
    n = 32
    x = (np.arange(n) + 0.5) / n
    X = np.meshgrid(x, x, x, indexing="ij")[0]
    u = np.sin(2 * np.pi * 4 * X)
    z = np.zeros_like(u)
    k, E = energy_spectrum(_t(u), _t(z), _t(z))
    assert np.argmax(E) == 4
    assert E[4] / E.sum() > 0.99
    np.testing.assert_allclose(E.sum(), 0.25, rtol=1e-12)
    _close_spectrum((k, E), jax_spectrum(u, z, z))
    st = turbulence_stats(_t(u), _t(z), _t(z))
    np.testing.assert_allclose(st["urms"], np.sqrt(0.5), rtol=1e-12)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two copies of the hit_run directory (the tools write into it), and
    a two-level periodic plotfile of the same fields."""
    out = {}
    for who in ("port", "jax"):
        root = str(tmp_path_factory.mktemp(f"hit_{who}"))
        for i, t in enumerate([0.0, 0.1]):
            write_synthetic_plotfile(f"{root}/plt{i:05d}", n_cell=16,
                                     n_levels=1, fields=FIELDS, time=t,
                                     is_periodic=(True, True, True))
        with open(f"{root}/ic.txt", "w") as f:
            f.write(IC)
        out[who] = root
    two = str(tmp_path_factory.mktemp("hit2") / "plt2")
    write_synthetic_plotfile(two, n_cell=16, n_levels=2, max_grid_size=8,
                             fields=FIELDS, is_periodic=(True, True, True))
    out["two_level"] = two
    return out


@pytest.fixture
def clis(monkeypatch):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    return {"port": lambda a: cli.main([*a, "device=cpu"]),
            "jax": jax_cli.main}


def test_port_hit_fields_are_the_tests():
    x = np.linspace(0, 1, 7)
    for name, fn in hit_fields().items():
        np.testing.assert_array_equal(fn(x, x[::-1], x * x),
                                      FIELDS[name](x, x[::-1], x * x))


def _csv(path):
    lines = open(path).read().splitlines()
    return lines[0], np.array([[float(v) for v in ln.split(",")]
                               for ln in lines[1:]])


def test_tseries(runs, clis):
    for who in ("port", "jax"):
        assert clis[who](["turbulenceTseries", f"root_dir={runs[who]}"]) == 0
    hp, vp = _csv(f"{runs['port']}/tseries.csv")
    hj, vj = _csv(f"{runs['jax']}/tseries.csv")
    assert hp == hj and vp.shape == vj.shape == (2, 7)
    # divu_sq is rounding noise around 0 on both sides
    np.testing.assert_allclose(vp[:, :6], vj[:, :6], rtol=1e-12)
    assert (np.abs(vp[:, 6]) < 1e-12).all()
    # the analytic checks of tests/test_turbulence_post.py:36-55
    vals = dict(zip(["tau"] + hp.split(",")[1:], vp[0]))
    assert abs(vals["kin_energy_avg_adim"] - 0.5) < 1e-6
    assert abs(vals["urms_computed"] - np.sqrt(0.5)) < 1e-6
    kh = 2 * np.pi / 16
    w2 = 3 * (2 * np.pi) ** 2 * 0.5 * (np.sin(kh) / kh) ** 2
    assert abs(vals["magvort_sq_avg_adim"] - w2 / 4) / (w2 / 4) < 1e-6
    assert vals["divu_sq_avg_adim"] < 1e-12
    assert abs(vals["temp_var_sq_avg_adim"] - 50.0 / 1.44) < 1e-3


def _slice_file(path):
    head, rows = [], []
    for ln in open(path).read().splitlines():
        if ln.startswith("#") or not ln:
            head.append(ln)
        else:
            rows.append([float(v) for v in ln.split()])
    return head, rows


def test_slice(runs, clis):
    for who in ("port", "jax"):
        assert clis[who](["turbulenceSlice", f"root_dir={runs[who]}",
                          "plotfile=plt00001"]) == 0
    hp, rp = _slice_file(f"{runs['port']}/plt00001_slice.dat")
    hj, rj = _slice_file(f"{runs['jax']}/plt00001_slice.dat")
    assert hp == hj and len(rp) == len(rj) == 16 + 16
    prof_p, prof_j = np.array(rp[:16]), np.array(rj[:16])
    np.testing.assert_allclose(prof_p[:, [0, 2, 3, 4]],
                               prof_j[:, [0, 2, 3, 4]], rtol=1e-12)
    # divu_adim: rounding noise around 0 on both sides
    assert np.abs(prof_p[:, 1]).max() < 1e-12
    np.testing.assert_allclose(np.array(rp[16:]), np.array(rj[16:]),
                               rtol=1e-12)


NEW = ["x_vorticity", "y_vorticity", "z_vorticity", "magvort", "divu"]


@pytest.mark.parametrize("case", ["hit", "two_level"])
def test_augment_plotfile(runs, clis, tmp_path, case):
    src = f"{runs['port']}/plt00001" if case == "hit" else runs["two_level"]
    out = {}
    for who in ("port", "jax"):
        out[who] = str(tmp_path / f"{who}_aug")
        assert clis[who](["augmentPlotfile", f"infile={src}",
                          f"outfile={out[who]}"]) == 0
    rp, rj = PlotfileReader(out["port"]), PlotfileReader(out["jax"])
    assert rp.var_names == rj.var_names == list(FIELDS) + NEW
    for lev in range(rj.meta.n_levels):
        for fp, fj in zip(rp.read_level(lev), rj.read_level(lev)):
            # the loaded components pass through unchanged
            np.testing.assert_array_equal(fp[:5], fj[:5])
            scale = float(np.abs(fj[5:9]).max())
            np.testing.assert_allclose(fp[5:], fj[5:], rtol=0,
                                       atol=1e-12 * scale)
    if case == "hit":
        # the curl of the unit sines, attenuated by sin(kh)/kh
        f = np.concatenate([b.reshape(b.shape[0], -1)
                            for b in rp.read_level(0)], axis=1)
        kh = 2 * np.pi / 16
        w2 = 3 * (2 * np.pi) ** 2 * 0.5 * (np.sin(kh) / kh) ** 2
        np.testing.assert_allclose((f[8] ** 2).mean(), w2, rtol=1e-12)
        assert np.abs(f[9]).max() < 1e-12


def test_varfield_average(runs, clis, capsys):
    vals = {}
    for who in ("port", "jax"):
        assert clis[who](["varfieldAverage",
                          f"plotfile={runs[who]}/plt00001", "var=temp"]) == 0
        vals[who] = capsys.readouterr().out
    assert vals["port"] == vals["jax"]
    from peleanalysis_tpu_torch.tools.turbulence_post import varfield_average
    avg = varfield_average(f"{runs['port']}/plt00001", "temp", "cpu")
    assert abs(avg - 300.0) < 1e-9


@pytest.mark.parametrize("case", ["hit", "two_level"])
def test_spectra_cli(runs, clis, tmp_path, monkeypatch, case):
    files = (f"{runs['port']}/plt00000 {runs['port']}/plt00001"
             if case == "hit" else runs["two_level"])
    monkeypatch.chdir(tmp_path)
    for who in ("port", "jax"):
        assert clis[who](["turbulenceSpectra", f"infile={files}",
                          f"outfile_base={who}", "prefetch=0"]) == 0
    with open("port_stats.dat") as fp, open("jax_stats.dat") as fj:
        assert fp.read() == fj.read()
    tags = ["plt00000", "plt00001"] if case == "hit" else ["plt2"]
    for tag in tags:
        got = np.loadtxt(f"port_{tag}_spectrum.dat")
        want = np.loadtxt(f"jax_{tag}_spectrum.dat")
        _close_spectrum((got[:, 0], got[:, 1]), (want[:, 0], want[:, 1]))
        if case == "hit":
            # Parseval: all the energy 0.75 in shell 1
            assert abs(got[1, 1] - 0.75) < 1e-6
            assert got[1, 1] / got[:, 1].sum() > 1 - 1e-9
