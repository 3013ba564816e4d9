"""Parity of the port's chemical kinetics (``peleanalysis_tpu_torch/chem/
kinetics.py``) with the JAX package's (``peleanalysis_tpu/chem/
kinetics.py``, its numpy path), on the CPU.

  * the CHEMKIN parser gives the same species, reactions and NASA7 data on
    every mechanism text of ``tests/test_kinetics.py`` and on a richer one;
  * every constant array of ``Kinetics`` is bitwise equal to JAX's;
  * ``qf_qr`` and ``qf_qr_from_state`` in float64 equal JAX's within 1e-12
    relative (log and exp are not correctly rounded in either library, and
    the products sum in another order) on random states covering
    Lindemann, Troe (also a zero parameter) and SRI falloff, REV
    overrides, negative-A duplicates, third-body efficiencies, zero
    concentrations and T on both sides of every T-mid;
  * the chunked sums equal the unchunked sum within 1e-12.
"""
import dataclasses

import numpy as np
import pytest
import torch

from peleanalysis_tpu.chem import kinetics as jk
from peleanalysis_tpu.chem import mechanism as jm
from peleanalysis_tpu_torch.chem import kinetics as pk
from peleanalysis_tpu_torch.chem import mechanism as pm

RTOL = 1e-12

# the mechanism texts of tests/test_kinetics.py
MECHS = {
    "basic": """
ELEMENTS
H O N
END
SPECIES
H O2 OH O HO2 H2O N2
END
REACTIONS CAL/MOLE
H + O2 => OH + O          2.0E14 0.0  16000.
H + O2 + M => HO2 + M     6.0E17 -0.8 0.
  H2O/6.0/ N2/1.0/
OH + OH (+M) => H2O + O (+M)  1.0E13 0.0 0.
  LOW / 1.0E16 0.0 0.0 /
  TROE / 0.6 100.0 1000.0 /
END
""",
    "units_aux": """
REACTIONS KCAL/MOLE
A1 + B1 <=> C1          1.0E10 0.5 16.0
  REV / 2.0E9 0.0 10.0 /
A1 + B1 => C1           3.0E10 0.0 5.0
DUPLICATE
""",
    "bare": "CH4 + OH <=> CH3 + H2O\nCO + OH <=> CO2 + H\n",
    "troe_zero": """
REACTIONS
OH + OH (+M) => H2O + O   1.0E13 0.0 0.
  LOW / 1.0E16 0.0 0.0 /
  TROE / 0.6 0.0 1000.0 /
""",
    "negative_a": """
REACTIONS
OH + HO2 => H2O + O2     1.0E13  0.0  0.
DUPLICATE
OH + HO2 => H2O + O2    -2.0E12  0.0  0.
DUPLICATE
""",
    "species_end_d_exp": """
SPECIES H O2 HO2 H2O N2 END
REACTIONS
H + O2 + M => HO2 + M     6.0D17 -0.8 0.
  H2O/6.0D0/ N2/1.5d0/
""",
    "lindemann": """
SPECIES
A2 B2 P2
END
REACTIONS
A2 + B2 (+M) => P2 (+M)   1.0E13 0.0 0.0
  LOW / 1.0E16 0.0 0.0 /
END
""",
}


def nasa_lines(name, hi, lo, tmid="1000.00"):
    """One species' four fixed-column NASA7 lines (blank tmid: the THERMO
    header's default)."""
    l1 = (f"{name:<18}{'':6}{'C   1H   4':20}G{200.0:10.3f}{3500.0:10.3f}"
          f"{tmid:>8}").ljust(79) + "1"

    def f(v):
        return f"{v:15.8E}"
    l2 = "".join(f(v) for v in hi[:5]).ljust(79) + "2"
    l3 = "".join(f(v) for v in list(hi[5:]) + list(lo[:3])).ljust(79) + "3"
    l4 = "".join(f(v) for v in lo[3:]).ljust(79) + "4"
    return "\n".join([l1, l2, l3, l4])


SPECIES = ["H2", "H", "O", "O2", "OH", "H2O", "HO2", "CH4", "CH3", "CO",
           "CO2", "N2"]
TMIDS = [1000.0, 1000.0, 1200.0, 1000.0, 900.0, 1000.0, 1100.0, 1000.0,
         1000.0, 1300.0, 1000.0, 1000.0]


def species_thermo(k: int):
    """(hi, lo) NASA7 coefficients of species k: cp/R of 2.5-5, a gentle
    T dependence, formation enthalpies within +-3e4 K, so every rate and
    equilibrium constant stays finite over 300-2500 K."""
    lo = [2.5 + 0.2 * k, 1.0e-3, -3.0e-7, 2.0e-11, -1.0e-15,
          -2500.0 * (k - 6), 2.0 + 0.5 * k]
    hi = [2.7 + 0.2 * k, 6.0e-4, -1.5e-7, 1.0e-11, -5.0e-16,
          -2600.0 * (k - 6), 3.0 + 0.5 * k]
    return hi, lo


THERMO_BLOCK = "THERMO ALL\n   300.000  1000.000  5000.000\n" + "\n".join(
    nasa_lines(s, *species_thermo(k), tmid=("" if s == "O2"
                                             else f"{TMIDS[k]:.2f}"))
    for k, s in enumerate(SPECIES)) + "\nEND\n"

# every feature the evaluator has, with thermo for the equilibrium
# reverses: irreversible, equilibrium-reversible, REV, third body with
# efficiencies, Lindemann, Troe (3 and 4 parameters, one zero), SRI (3
# and 5 parameters), a falloff with a named partner, negative-A duplicates
RICH = ("ELEMENTS\nH O C N\nEND\nSPECIES\n" + " ".join(SPECIES) + "\nEND\n"
        + THERMO_BLOCK + """
REACTIONS
H + O2 => OH + O               3.5E15 -0.41 16600.
O + H2 <=> H + OH              5.0E04  2.67  6290.
OH + H2 <=> H + H2O            2.2E08  1.51  3430.
  REV / 6.0E08 1.2 18000. /
H + O2 + M <=> HO2 + M         6.2E19 -1.42 0.
  H2O/11.0/ H2/2.0/ CO2/3.8/ N2/0.7/
H + H + M <=> H2 + M           1.0E18 -1.0 0.
CH3 + H (+M) <=> CH4 (+M)      1.3E16 -0.63 383.
  LOW / 2.5E33 -4.76 2440. /
  TROE / 0.783 74.0 2941.0 6964.0 /
  H2O/6.0/ CO2/2.0/
OH + OH (+M) <=> H2O + O (+M)  1.0E13 0.0 0.
  LOW / 1.0E16 0.0 0.0 /
  TROE / 0.6 0.0 1000.0 /
CO + O (+M) <=> CO2 (+M)       1.8E10 0.0 2385.
  LOW / 6.0E14 0.0 3000. /
H + OH (+M) <=> H2O (+M)       1.0E14 -0.2 0.
  LOW / 2.0E20 -1.5 0. /
  SRI / 0.45 797.0 979.0 /
CH3 + OH (+M) <=> CH4 + O (+M) 1.0E12 0.0 100.
  LOW / 1.0E18 0.0 0. /
  SRI / 0.5 200.0 0.0 1.2 0.3 /
HO2 + H (+H2O) <=> H2 + O2 (+H2O) 1.0E13 0.0 0.
  LOW / 5.0E18 0.0 0. /
OH + HO2 => H2O + O2           1.0E13  0.0  0.
DUPLICATE
OH + HO2 => H2O + O2          -2.0E12  0.0  0.
DUPLICATE
CO + OH <=> CO2 + H            4.7E07 1.23 70.
CH4 + OH => CH3 + H2O          1.0E08 1.6 3120.
END
""")


def _write(tmp_path, text, name="mech.inp"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _nasa_dict(th):
    return {s: (t.t_low, t.t_mid, t.t_high, t.lo.tolist(), t.hi.tolist())
            for s, t in th.items()}


def _parsed(mod, path):
    sp, rxns, th = mod.parse_chemkin(path)
    return sp, [dataclasses.asdict(r) for r in rxns], _nasa_dict(th)


@pytest.mark.parametrize("name", sorted(MECHS) + ["rich"])
def test_parse_chemkin_parity(tmp_path, name):
    path = _write(tmp_path, RICH if name == "rich" else MECHS[name])
    assert _parsed(pk, path) == _parsed(jk, path)


def test_parse_chemkin_thermo_blank_tmid_parity(tmp_path):
    path = _write(tmp_path, THERMO_BLOCK, "therm.dat")
    got = _nasa_dict(pm.parse_chemkin_thermo(path))
    assert got == _nasa_dict(jm.parse_chemkin_thermo(path))
    # the blank T-mid takes the header's default
    assert got["O2"][1] == 1000.0 and got["CO"][1] == 1300.0


def test_unsupported_aux_keyword_raises(tmp_path):
    path = _write(tmp_path, "REACTIONS\nA + B => C  1e10 0 0\n"
                  "PLOG / 1.0 1e10 0 0 /\n")
    for mod in (pk, jk):
        with pytest.raises(ValueError, match="unsupported"):
            mod.parse_chemkin(path)


def test_formula_parity():
    for name in ("NC7H16", "N-C4H10", "IC8H18", "NH3", "NO2", "HCN",
                 "CH2(S)", "C2H5OH", "NEOC5H12", "AR", "HOCN", "CH2CHO"):
        assert pm.parse_formula(name) == jm.parse_formula(name)
        assert pm.molecular_weight(name) == jm.molecular_weight(name)


# -- constants -----------------------------------------------------------------
CONSTANTS = ("nuf", "nur", "lnA", "kf_sign", "rev_sign", "beta", "EaR",
             "rev_mask", "rev_arrh", "rev_lnA", "rev_beta", "rev_EaR",
             "alpha", "tb_mask", "fo_mask", "low_lnA", "low_beta",
             "low_EaR", "troe_mask", "troe", "troe_has_t2", "sri_mask",
             "sri", "nu_net", "nu_sum", "W", "_th_lo", "_th_hi",
             "_th_tmid", "_have_thermo")


def _kinetics_pair(path):
    out = []
    for mod in (jk, pk):
        sp, rxns, th = mod.parse_chemkin(path)
        out.append(mod.Kinetics(sp, rxns, th))
    return out


@pytest.mark.parametrize("name", ["basic", "troe_zero", "negative_a",
                                  "species_end_d_exp", "lindemann", "rich"])
def test_kinetics_constants_bitwise(tmp_path, name):
    j, p = _kinetics_pair(_write(tmp_path, RICH if name == "rich"
                                 else MECHS[name]))
    for attr in CONSTANTS:
        a, b = getattr(j, attr), getattr(p, attr)
        assert a.dtype == b.dtype and a.shape == b.shape, attr
        assert a.tobytes() == b.tobytes(), attr
    assert p.species == j.species and p.n_reactions == j.n_reactions


def test_missing_thermo_raises():
    for mod in (jk, pk):
        rxn = mod.parse_kinetic_reaction("A3 <=> B3   1.0E13 0.0 0.0")
        with pytest.raises(ValueError, match="NASA7 thermo"):
            mod.Kinetics(["A3", "B3"], [rxn])


# -- evaluation ----------------------------------------------------------------
def _states(n, ns, seed, zero_frac=0.1):
    """T across 300-2500 K (every T-mid inside), mole fractions with some
    exact zeros, densities of a flame in g/cm^3."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(300.0, 2500.0, n)
    T[:8] = [899.0, 901.0, 999.5, 1000.5, 1199.0, 1201.0, 1299.9, 1300.1]
    X = rng.uniform(0.0, 1.0, (n, ns)) ** 3
    X[rng.random((n, ns)) < zero_frac] = 0.0
    X /= np.maximum(X.sum(axis=1, keepdims=True), 1e-300)
    rho = rng.uniform(1e-4, 1.2e-3, n)
    return T, X, rho


def _close(got: torch.Tensor, want: np.ndarray, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-300)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qf_qr_from_state_parity(tmp_path, seed):
    j, p = _kinetics_pair(_write(tmp_path, RICH))
    T, X, rho = _states(512, len(j.species), seed)
    Qf, Qr = j.qf_qr_from_state(T, rho, X)
    Pf, Pr = p.qf_qr_from_state(torch.from_numpy(T), torch.from_numpy(rho),
                                torch.from_numpy(X))
    assert Pf.dtype == torch.float64 and Pf.shape == Qf.shape
    _close(Pf, Qf)
    _close(Pr, Qr)
    # every form was exercised: reverses, falloffs, negative duplicates
    assert (Qr != 0).any(axis=0).sum() >= 10 and (Qf < 0).any()


@pytest.mark.parametrize("name", ["basic", "troe_zero", "negative_a",
                                  "lindemann", "rich"])
def test_qf_qr_parity(tmp_path, name):
    j, p = _kinetics_pair(_write(tmp_path, RICH if name == "rich"
                                 else MECHS[name]))
    rng = np.random.default_rng(3)
    T = rng.uniform(300.0, 2500.0, 256)
    C = np.abs(rng.normal(1e-6, 5e-7, (256, len(j.species))))
    C[::7, 0] = 0.0
    Qf, Qr = j.qf_qr(T, C)
    Pf, Pr = p.qf_qr(torch.from_numpy(T), torch.from_numpy(C))
    _close(Pf, Qf)
    _close(Pr, Qr)


def test_zero_concentrations_take_the_float64_floor(tmp_path):
    """One reactant at zero concentration: ln C is ln 1e-300 in float64
    (a float32 floor would give ln 1e-30, 621 larger), so the rate is tiny
    but not zero, exactly as JAX's."""
    j, p = _kinetics_pair(_write(tmp_path, MECHS["basic"]))
    C = np.full((4, 7), 1e-6)
    C[:, 0] = 0.0                       # H: reactant of reactions 0 and 1
    T = np.array([900.0, 1200.0, 1800.0, 2400.0])
    Qf, Qr = j.qf_qr(T, C)
    Pf, Pr = p.qf_qr(torch.from_numpy(T), torch.from_numpy(C))
    _close(Pf, Qf)
    _close(Pr, Qr)
    assert (Qf[:, 0] > 0).all() and (Qf[:, 0] < 1e-250).all()
    Pz, _ = p.qf_qr(torch.from_numpy(T), torch.zeros(4, 7,
                                                     dtype=torch.float64))
    assert torch.isfinite(Pz).all() and Pz.max() == 0.0


def test_float32_concentrations_take_the_float32_floor(tmp_path):
    j, p = _kinetics_pair(_write(tmp_path, MECHS["basic"]))
    C = np.full((3, 7), 1e-6, dtype=np.float32)
    C[:, 0] = 0.0
    T = np.array([900.0, 1500.0, 2400.0], dtype=np.float32)
    Qf, Qr = j.qf_qr(T, C)
    Pf, Pr = p.qf_qr(torch.from_numpy(T), torch.from_numpy(C))
    # float32 inputs promote to the float64 constants in both
    _close(Pf, Qf)
    _close(Pr, Qr)


def test_g_RT_matches_nasa7_oracle(tmp_path):
    _, p = _kinetics_pair(_write(tmp_path, RICH))
    T = np.array([300.0, 899.0, 901.0, 1000.0, 1299.0, 1301.0, 2500.0])
    g = p._g_RT(torch.from_numpy(T)).numpy()
    for k, s in enumerate(p.species):
        th = p.thermo[s]
        np.testing.assert_allclose(g[:, k], th.h_RT(T) - th.s_R(T),
                                   rtol=1e-13)


def test_nasa7_tensor_polynomials_match_numpy():
    hi, lo = species_thermo(3)
    th = pm.Nasa7(200.0, 1000.0, 3500.0, np.array(lo), np.array(hi))
    T = np.array([300.0, 999.0, 1000.0, 1001.0, 2500.0])
    Tt = torch.from_numpy(T)
    for f in ("cp_R", "h_RT", "s_R"):
        np.testing.assert_allclose(getattr(th, f + "_tensor")(Tt).numpy(),
                                   getattr(th, f)(T), rtol=1e-14)


@pytest.mark.parametrize("chunk", [1, 37, 512, 100000])
def test_chunked_sums_equal_the_unchunked_sum(tmp_path, chunk):
    j, p = _kinetics_pair(_write(tmp_path, RICH))
    T, X, rho = _states(700, len(j.species), 5)
    Qf, Qr = j.qf_qr_from_state(T, rho, X)
    args = [torch.from_numpy(a) for a in (T, rho, X)]
    sf, sr = p.qf_qr_sums(*args, chunk=chunk)
    _close(sf, Qf.sum(axis=0))
    _close(sr, Qr.sum(axis=0))
    w = np.random.default_rng(6).uniform(0.5, 2.0, len(T))
    sf, sr = p.qf_qr_sums(*args, weights=torch.from_numpy(w), chunk=chunk)
    _close(sf, (Qf * w[:, None]).sum(axis=0))
    _close(sr, (Qr * w[:, None]).sum(axis=0))
    sf, _ = p.qf_qr_sums(*args, weights=0.125, chunk=chunk)
    _close(sf, Qf.sum(axis=0) * 0.125)


def test_chunk_size_follows_the_mechanism(tmp_path):
    _, p = _kinetics_pair(_write(tmp_path, RICH))
    per_cell = 8 * (24 * p.n_reactions + 12 * len(p.species) + 8)
    for dev in ("cuda", "cpu"):
        assert p.chunk_cells(dev) == pk.CHUNK_BYTES[dev] // per_cell
