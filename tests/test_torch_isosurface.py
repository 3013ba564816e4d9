"""Parity of the port's isosurface (the enum marching-cubes engine, DIM=2
marching squares and the ``isosurface`` CLI) with the JAX package's on
identical inputs.

Tolerances:
  * node count and elements: identical (node ids come from the same
    exclusive cumsum in the same order, triangles in the same order);
  * node rows: 1e-12 of each column's largest value in float64 and 1e-5 in
    float32 (the same interpolation; the JAX package's compiled arithmetic
    may round a product differently);
  * file outputs: the Tecplot text byte for byte, the XDMF descriptor byte
    for byte and its binary blob within the node tolerance; the printed
    area to its 10 digits.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from peleanalysis_tpu import cli as jax_cli
from peleanalysis_tpu import config as jax_config
from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.geom import marching_cubes as jmc
from peleanalysis_tpu.geom.marching_squares import \
    extract_isolines as jax_isolines
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.geom import marching_cubes as pmc
from peleanalysis_tpu_torch.geom.marching_squares import extract_isolines
from peleanalysis_tpu_torch.io.mef import read_mef

TORCH = {np.float64: torch.float64, np.float32: torch.float32}
NODE_TOL = {np.float64: 1e-12, np.float32: 1e-5}


def port_state(jds: JaxDense, device="cpu") -> DenseAmrState:
    """The port's state built from the JAX state's own arrays and boxes."""
    meta = jds.meta
    dt = np.asarray(jds.data[0]).dtype
    return DenseAmrState.from_numpy(
        [(g.domain.lo, g.domain.hi) for g in meta.geoms],
        meta.geoms[0].prob_lo, meta.geoms[0].prob_hi,
        meta.geoms[0].is_periodic, meta.ref_ratio,
        [[(b.lo, b.hi) for b in ba] for ba in meta.bas], jds.names,
        [np.asarray(d) for d in jds.data], device, TORCH[dt.type])


def blob(x, y, z):
    """A Gaussian blob centred on the x-periodic seam (tests/test_isosurface
    .py:207)."""
    return np.exp(-(((x + 0.5) % 1.0 - 0.5) ** 2 + (y - 0.5) ** 2
                    + (z - 0.5) ** 2) / 0.15 ** 2)


# name -> (plotfile kwargs, iso comp, iso value, extra comps, closed surface)
CASES = {
    "1level": (dict(n_cell=32, n_levels=1), "temp", 1000.0, (), True),
    "2level": (dict(n_cell=32, n_levels=2), "progress", 0.05, ("temp",),
               True),
    "3level_extras": (dict(n_cell=32, n_levels=3, max_grid_size=16), "temp",
                      900.0, ("density", "progress"), True),
    "periodic": (dict(n_cell=32, n_levels=2, fields={"blob": blob},
                      is_periodic=(True, True, True)), "blob", 0.3, (),
                 False),
    "empty": (dict(n_cell=32, n_levels=2), "temp", 1e9, ("density",), True),
}


@pytest.fixture(scope="module")
def plotfiles(tmp_path_factory):
    out = {}
    for name, (kw, *_) in CASES.items():
        path = str(tmp_path_factory.mktemp(name) / "plt")
        write_synthetic_plotfile(path, **kw)
        out[name] = path
    return out


def edge_incidence(mef):
    """How many triangles border each edge (degenerate triangles left out);
    a closed watertight surface has 2 everywhere."""
    e = mef.elements
    good = (e[:, 0] != e[:, 1]) & (e[:, 1] != e[:, 2]) & (e[:, 0] != e[:, 2])
    e = e[good]
    edges = np.sort(np.concatenate([e[:, [0, 1]], e[:, [1, 2]],
                                    e[:, [2, 0]]]), axis=1)
    return np.unique(edges, axis=0, return_counts=True)[1]


def assert_same_surface(got, want, tol):
    assert got.names == want.names
    assert got.nodes.dtype == np.float64 and got.elements.dtype == np.int32
    assert got.nodes.shape == want.nodes.shape
    np.testing.assert_array_equal(got.elements, want.elements)
    for c in range(want.nodes.shape[1]):
        scale = float(np.abs(want.nodes[:, c]).max(initial=0.0))
        np.testing.assert_allclose(got.nodes[:, c], want.nodes[:, c], rtol=0,
                                   atol=tol * scale)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_enum_engine_parity(plotfiles, case, dt):
    kw, iso_name, iso_val, extras, closed = CASES[case]
    jds = JaxDense.from_batched(AmrState.from_plotfile(plotfiles[case],
                                                       dtype=dt))
    want = jmc.extract_isosurface(jds, iso_name, iso_val, extras,
                                  classify="enum")
    got = pmc.extract_isosurface(port_state(jds), iso_name, iso_val, extras)
    assert_same_surface(got, want, NODE_TOL[dt])
    if case == "empty":
        assert got.n_nodes == 0 and got.n_elts == 0
        return
    assert got.n_elts > 100
    np.testing.assert_array_equal(got.field(iso_name),
                                  np.float64(dt(iso_val)))
    if closed:
        assert (edge_incidence(got) == 2).all()


def test_repeat_extraction_reuses_state_inputs(plotfiles):
    """A second extraction on one state (another iso value, then the first
    again) reuses the cached per-state inputs and gives the same MEF."""
    jds = JaxDense.from_batched(AmrState.from_plotfile(plotfiles["2level"],
                                                       dtype=np.float64))
    pds = port_state(jds)
    first = pmc.extract_isosurface(pds, "temp", 1000.0)
    cached = dict(pds._iso_cache)
    other = pmc.extract_isosurface(pds, "temp", 800.0)
    again = pmc.extract_isosurface(pds, "temp", 1000.0)
    assert other.n_nodes != first.n_nodes
    assert all(pds._iso_cache[k] is v for k, v in cached.items())
    np.testing.assert_array_equal(again.nodes, first.nodes)
    np.testing.assert_array_equal(again.elements, first.elements)


# -- helpers against their JAX counterparts -----------------------------------
def _random_mask(shape, seed):
    return np.random.default_rng(seed).random(shape) < 0.3


@pytest.mark.parametrize("a", [0, 1, 2])
def test_volume_mask_helpers_match_jax(a):
    act = _random_mask((5, 6, 7), a)
    np.testing.assert_array_equal(
        pmc._dilate_active(torch.from_numpy(act), a).numpy(),
        np.asarray(jmc._dilate_active(jnp.asarray(act), a)))
    # a level-0 edge volume of a fully periodic 7^3 domain: grown 9^3, 8
    # slots along the edge axis; fold along every dim
    m = _random_mask(tuple(8 if d == a else 9 for d in range(3)), 10 + a)
    spans = ((True, 7),) * 3
    np.testing.assert_array_equal(
        pmc._fold_edge_mask(torch.from_numpy(m.copy()), spans).numpy(),
        np.asarray(jmc._fold_edge_mask(jnp.asarray(m), a, spans)))
    r = np.arange(m.size, dtype=np.int32).reshape(m.shape)
    got = torch.from_numpy(r.copy())
    pmc._fold_rank_vol(got, spans)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmc._fold_rank_vol(jnp.asarray(r), a, spans)))
    # coarsen onto a coarse volume from an odd fine origin
    fine = _random_mask((9, 10, 11), 20 + a)
    want, wslc = jmc._coarsen_edge_mask(jnp.asarray(fine), a, 2, (3, -1, 4),
                                        (8, 7, 9), (1, -1, 1))
    got, gslc = pmc._coarsen_edge_mask(torch.from_numpy(fine), 2, (3, -1, 4),
                                       (8, 7, 9), (1, -1, 1))
    assert gslc == wslc
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_classify_matches_jax():
    f = np.random.default_rng(3).random((6, 7, 8))
    want = np.asarray(jmc._classify(jnp.asarray(f), 0.5))
    got = pmc._classify(torch.from_numpy(f) < 0.5)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# -- DIM=2: marching squares --------------------------------------------------
def test_isolines_2d_parity(tmp_path):
    path = str(tmp_path / "plt2d")
    write_synthetic_plotfile(path, n_cell=32, n_levels=2, ndim=2,
                             is_periodic=(False, False))
    jds = JaxDense.from_batched(AmrState.from_plotfile(path,
                                                       dtype=np.float64))
    want = jax_isolines(jds, "progress", 0.5, extra_names=("temp",))
    got = extract_isolines(port_state(jds), "progress", 0.5,
                           extra_names=("temp",))
    assert got.names == ["X", "Y", "progress", "temp"] and got.n_elts > 20
    assert_same_surface(got, want, NODE_TOL[np.float64])
    assert (np.bincount(got.elements.ravel()) == 2).all()   # closed loop


# -- the two CLIs on one plotfile ---------------------------------------------
CLI_CASES = {
    "3level_mef_area": ("3level_extras", ["isoVal=1000", "comps=density",
                                          "surfFormat=MEF", "computeArea=1"]),
    "2level_dat_scomp": ("2level", ["isoCompName=progress", "isoVal=0.05",
                                    "sComp=0", "nComp=2", "surfFormat=DAT"]),
    "1level_xdmf": ("1level", ["isoVal=1000", "comps=2", "surfFormat=XDMF",
                               "computeArea=1"]),
    "periodic_dat": ("periodic", ["isoCompName=blob", "isoVal=0.3",
                                  "is_per=1 1 1", "surfFormat=DAT"]),
    "2d_mef": (None, ["isoCompName=progress", "isoVal=0.5", "comps=temp",
                      "surfFormat=MEF", "computeArea=1"]),
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_isosurface_cli_parity(plotfiles, name, tmp_path, monkeypatch,
                               capsys):
    case, keys = CLI_CASES[name]
    if case is None:
        plt = str(tmp_path / "plt2d")
        write_synthetic_plotfile(plt, n_cell=32, n_levels=2, ndim=2,
                                 is_periodic=(False, False))
    else:
        plt = plotfiles[case]
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    # both CLIs set a process-wide compute dtype: restore it afterwards
    monkeypatch.setattr(jax_config, "compute_dtype", jax_config.compute_dtype)
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    printed = {}
    for who, main, extra in (("port", cli.main, ["device=cpu"]),
                             ("jax", jax_cli.main, [])):
        base = str(tmp_path / who)
        assert main(["isosurface", f"infile={plt}", *keys,
                     f"outfile_base={base}", *extra]) == 0
        printed[who] = [ln for ln in capsys.readouterr().out.splitlines()
                        if ln.startswith("Total area")]
    assert printed["port"] == printed["jax"]
    if "computeArea=1" in keys:
        assert len(printed["port"]) == 1
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    if "surfFormat=MEF" in keys:
        got, want = read_mef(port + ".mef"), read_mef(ref + ".mef")
        assert got.n_elts > 20
        assert_same_surface(got, want, NODE_TOL[np.float64])
    elif "surfFormat=DAT" in keys:
        with open(port + ".dat", "rb") as a, open(ref + ".dat", "rb") as b:
            assert a.read() == b.read()
    else:
        with open(port + ".xmf") as a, open(ref + ".xmf") as b:
            assert a.read().replace(port, ref) == b.read()
        blob_p = np.fromfile(port + ".mesh", np.uint8)
        blob_j = np.fromfile(ref + ".mesh", np.uint8)
        assert blob_p.size == blob_j.size
        n_conn = 3 * _xmf_n_elements(ref + ".xmf")
        np.testing.assert_array_equal(blob_p[:4 * n_conn],
                                      blob_j[:4 * n_conn])
        vp = blob_p[4 * n_conn:].view("<f8")
        vj = blob_j[4 * n_conn:].view("<f8")
        np.testing.assert_allclose(vp, vj, rtol=NODE_TOL[np.float64], atol=0)


def _xmf_n_elements(xmf: str) -> int:
    with open(xmf) as f:
        text = f.read()
    return int(text.split('NumberOfElements="')[1].split('"')[0])


@pytest.mark.parametrize("key", [
    "engine=device", "engine=fused", "engine=numpy",
    "shape_bucket=8", "cluster_batch=1", "ndevices=2"])
def test_unported_options_raise(plotfiles, tmp_path, key):
    """The unported engines and keys raise; ndevices=2 (ported) writes the
    ndevices=1 run's MEF byte for byte."""
    argv = ["isosurface", f"infile={plotfiles['1level']}", "device=cpu"]
    if key == "ndevices=2":
        assert cli.main([*argv, key, f"outfile_base={tmp_path / 'out'}"]) == 0
        assert cli.main([*argv, f"outfile_base={tmp_path / 'ref'}"]) == 0
        assert (tmp_path / "out.mef").read_bytes() == \
            (tmp_path / "ref.mef").read_bytes()
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1"):
        cli.main([*argv, key, f"outfile_base={tmp_path / 'out'}"])
    assert not list(tmp_path.iterdir())


def test_unported_library_paths_raise(plotfiles, tmp_path):
    jds = JaxDense.from_batched(AmrState.from_plotfile(plotfiles["1level"],
                                                       dtype=np.float64))
    pds = port_state(jds)
    # defer=True is ported (DeferredSurface); with want_eids it is refused,
    # as in the JAX engine
    eager = pmc.extract_isosurface(pds, "temp", 1000.0)
    surf = pmc.extract_isosurface(pds, "temp", 1000.0, defer=True)
    np.testing.assert_array_equal(surf.to_mef().nodes, eager.nodes)
    np.testing.assert_array_equal(surf.to_mef().elements, eager.elements)
    with pytest.raises(ValueError, match="want_eids"):
        pmc.extract_isosurface_enum(pds, "temp", 1000.0, defer=True,
                                    want_eids=True)
    with pytest.raises(NotImplementedError, match="item 2"):
        pmc.extract_isosurface(pds, "temp", 1000.0, classify="device")
    plt = str(tmp_path / "plt2d")
    write_synthetic_plotfile(plt, n_cell=16, n_levels=1, ndim=2,
                             is_periodic=(False, False))
    # writeLines=1 (DIM=2) is ported: it writes the contour's polylines
    # (held to the JAX CLI's bytes in test_torch_mef_tools.py)
    assert cli.main(["isosurface", f"infile={plt}", "isoCompName=progress",
                     "isoVal=0.5", "writeLines=1", "device=cpu",
                     f"outfile_base={tmp_path / 'out'}"]) == 0
    with open(tmp_path / "out_lines.dat") as f:
        assert f.readline().startswith("VARIABLES")
        assert f.readline().startswith('ZONE T="line0"')
