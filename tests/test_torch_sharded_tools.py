"""``ndevices=N`` in the port's grad, curvature, isosurface and partStream
on the CPU (N shards on the CPU): every output file byte for byte the
``ndevices=1`` run's, for N in {2, 3, 8} (3 divides no extent), X slabs
and ``mesh_shape=4 2`` / ``2 2 2`` blocks, periodic and reflecting
boundaries, a fine level of X extent 18 (``tests/test_halo.py``'s
``odd_state``), the sparse path with boundary and periodic clusters, and a
pipeline with a sharded stage; and each tool's ``ndevices=8`` CLI run
against the JAX tool's within the JAX tests' tolerances."""
import os

import numpy as np
import pytest

from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.box import Box, BoxArray
from peleanalysis_tpu_torch.amr.geometry import Geometry
from peleanalysis_tpu_torch.io.mef import read_mef
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader, write_plotfile
from peleanalysis_tpu_torch.testing import (make_level_data,
                                            write_synthetic_plotfile)

D = "device=cpu"
# not symmetric about any cut, crossing the periodic faces
FIELDS = {
    "temp": lambda x, y, z: 1000 + 500 * np.sin(2 * np.pi * x + 0.3)
    * np.cos(2 * np.pi * y - 0.2) + 300 * np.sin(2 * np.pi * z + 0.1),
    "density": lambda x, y, z: x + 2 * y + 3 * z,
    "x_velocity": lambda x, y, z: 1.0 + 0.3 * np.sin(2 * np.pi * y),
    "y_velocity": lambda x, y, z: 0.5 * np.cos(2 * np.pi * x) + 0.2,
    "z_velocity": lambda x, y, z: 0.3 * np.sin(2 * np.pi * (x + y)),
}


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def plotfiles(tmp_path_factory):
    d = tmp_path_factory.mktemp("pltshard")
    out = {"3level": str(d / "plt3"), "periodic": str(d / "pltper"),
           "odd": str(d / "pltodd")}
    write_synthetic_plotfile(out["3level"], n_cell=16, n_levels=3,
                             max_grid_size=8, fields=FIELDS)
    # level 1 spans the domain: the periodic seams fold on both levels
    write_synthetic_plotfile(out["periodic"], n_cell=16, n_levels=2,
                             max_grid_size=8, fields=FIELDS,
                             is_periodic=(True,) * 3, refine_frac=1.0)
    # tests/test_halo.py odd_state: a fine level of X extent 18
    dom0 = Box((0, 0, 0), (15, 15, 15))
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2)]
    bas = [BoxArray([dom0]), BoxArray([Box((5, 4, 6), (22, 21, 23))])]
    names, data = make_level_data(geoms, bas, FIELDS)
    write_plotfile(out["odd"], names, 0.0, geoms, [2], bas, data)
    return out


def tree_bytes(root):
    if os.path.isfile(root):
        return {"": open(root, "rb").read()}
    out = {}
    for dp, _, fns in os.walk(root):
        for fn in fns:
            p = os.path.join(dp, fn)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    assert out, root
    return out


TOOLS = {
    "grad": (["gradVar=temp", "Aux_Variables=density"], "outfile", ""),
    "fluxMatch": (["gradVar=temp", "fluxMatch=1"], "outfile", ""),
    "curvature": (["progressName=temp", "do_gaussCurv=1",
                   "Aux_Variables=density"], "outfile", ""),
    "isosurface": (["isoVal=1000", "comps=density"], "outfile_base",
                   ".mef"),
}


def run(tool, plt, layout, name, extra=()):
    keys, out, ext = TOOLS[tool]
    verb = "grad" if tool == "fluxMatch" else tool
    assert cli.main([verb, f"infile={plt}", *keys, *extra, D,
                     f"{out}={name}", *layout.split()]) == 0
    return tree_bytes(name + ext)


LAYOUTS = ["ndevices=2", "ndevices=3", "ndevices=8",
           "ndevices=8 mesh_shape=4 2", "ndevices=8 mesh_shape=2 2 2"]


@pytest.mark.parametrize("tool", list(TOOLS))
def test_sharded_equals_one_device(plotfiles, tool):
    ref = run(tool, plotfiles["3level"], "ndevices=1", "ref")
    for i, layout in enumerate(LAYOUTS):
        assert run(tool, plotfiles["3level"], layout, f"n{i}") == ref, layout


@pytest.mark.parametrize("tool", list(TOOLS))
@pytest.mark.parametrize("case", ["periodic", "reflect", "odd"])
def test_sharded_boundaries(plotfiles, tool, case):
    plt = plotfiles["odd" if case == "odd" else "periodic"]
    extra = {"periodic": ["is_per=1 1 1"],
             "reflect": ["is_per=0 0 0", "sym_dir=1 0 1"],
             "odd": []}[case]
    if tool == "isosurface" and case == "reflect":
        extra = ["is_per=0 1 1"]
    ref = run(tool, plt, "ndevices=1", "ref", extra)
    for i, layout in enumerate(["ndevices=3", "ndevices=8 mesh_shape=2 2 2"]):
        assert run(tool, plt, layout, f"n{i}", extra) == ref, layout


def test_part_stream_sharded(plotfiles):
    def lines(layout, name):
        assert cli.main(["partStream", f"infile={plotfiles['3level']}",
                         "seedRakeL=0.2 0.3 0.4", "seedRakeR=0.8 0.6 0.5",
                         "seedRakeNum=30", "Nsteps=41", "hRK=0.5", D,
                         f"outFile={name}.dat", f"streamFile={name}_sd",
                         *layout.split()]) == 0
        return tree_bytes(name + ".dat"), tree_bytes(name + "_sd")
    ref = lines("ndevices=1", "ref")
    for n in (2, 3, 8):
        assert lines(f"ndevices={n}", f"n{n}") == ref, n


@pytest.fixture(scope="module")
def sparse_plotfile(tmp_path_factory):
    """Three scattered finest clusters on a 144^3 index space over a 36^3
    level 0 (ratio 4), as ``tests/test_cluster_shard.py`` places them:
    against the hi-x face, against the hi-z face and in the lo-x/lo-z
    corner, so they meet the periodic faces when ``is_per=1 1 1``."""
    path = str(tmp_path_factory.mktemp("pltshsp") / "plt")
    dom0 = Box((0, 0, 0), (35, 35, 35))
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(4)]
    bas = [BoxArray([dom0]),
           BoxArray([Box((128, 8, 8), (143, 23, 23)),
                     Box((8, 104, 128), (23, 119, 143)),
                     Box((0, 64, 0), (15, 79, 15))])]
    names, data = make_level_data(geoms, bas, {
        "blob": lambda x, y, z: np.sin(4 * np.pi * x)
        * np.cos(4 * np.pi * y) + z})
    write_plotfile(path, names, 0.0, geoms, [4], bas, data)
    return path


@pytest.mark.parametrize("is_per", ["0 0 0", "1 1 1"])
def test_sharded_sparse_clusters(sparse_plotfile, capsys, is_per):
    common = [f"infile={sparse_plotfile}", f"is_per={is_per}", D]
    for verb, keys, out, ext in (
            ("grad", ["gradVar=blob"], "outfile", ""),
            ("curvature", ["progressName=blob"], "outfile", ""),
            ("isosurface", ["isoCompName=blob", "isoVal=0.5"],
             "outfile_base", ".mef")):
        files = []
        for name, nd in (("one", "1"), ("two", "2"), ("three", "3")):
            assert cli.main([verb, *common, *keys, f"{out}={verb}_{name}",
                             f"ndevices={nd}"]) == 0
            files.append(tree_bytes(f"{verb}_{name}{ext}"))
        assert files[1] == files[0] and files[2] == files[0], verb
    assert "clustered path" in capsys.readouterr().out


def test_pipeline_with_a_sharded_stage(plotfiles):
    plt = plotfiles["3level"]
    grad = ["grad", f"infile={plt}", "gradVar=temp", D]
    curv = ["curvature", "infile=g", "progressName=||gradtemp||", D,
            "outfile=k"]
    assert cli.main([*grad, "outfile=g_ref"]) == 0
    assert cli.main(["curvature", "infile=g_ref", "progressName=||gradtemp||",
                     D, "outfile=k_ref"]) == 0
    assert cli.main(["pipeline", *grad, "outfile=g", "ndevices=3", "--",
                     *curv, "ndevices=2"]) == 0
    assert tree_bytes("g") == tree_bytes("g_ref")
    assert tree_bytes("k") == tree_bytes("k_ref")


# -- against the JAX tools at ndevices=8 (its eight virtual host devices) ----
@pytest.fixture(scope="module")
def jax_inputs(tmp_path_factory):
    """The JAX tests' inputs: ``tests/test_halo.py``'s odd_state (grad,
    isosurface) and ``tests/test_curvature.py``'s 32^3 2-level synthetic
    plotfile (curvature)."""
    d = tmp_path_factory.mktemp("pltshj")
    out = {"odd": str(d / "odd"), "syn": str(d / "syn")}
    dom0 = Box((0, 0, 0), (15, 15, 15))
    geom0 = Geometry(dom0, (0., 0., 0.), (1., 1., 1.), (False,) * 3)
    geoms = [geom0, geom0.refine(2)]
    bas = [BoxArray([dom0]), BoxArray([Box((5, 4, 6), (22, 21, 23))])]
    names, data = make_level_data(geoms, bas, {
        "temp": lambda x, y, z: 300 + 1500 * np.exp(
            -((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2) / 0.15 ** 2)})
    write_plotfile(out["odd"], names, 0.0, geoms, [2], bas, data)
    write_synthetic_plotfile(out["syn"], n_cell=32, n_levels=2)
    return out


def _fabs(path):
    r = PlotfileReader(path)
    return r.var_names, [f for lev in range(r.meta.n_levels)
                         for f in r.read_level(lev)]


@pytest.mark.parametrize("verb", ["grad", "grad64", "curvature",
                                  "isosurface"])
def test_matches_jax_at_8(jax_inputs, verb):
    """The JAX tests' tolerances: grad rtol 5e-6, atol 1e-4
    (``tests/test_halo.py:141-143``, where both sides run the same XLA
    ops), here in float64; the float32 CLI within the port's float32
    parity tolerance (``tests/test_torch_grad.py`` TOL: rtol 1e-5 and 1e-5
    of the largest value), since a float32 difference of temperatures near
    300 K carries the two packages' op orders as ~1e-3 in a small
    gradient; curvature within 5e-7 of the largest value, NaN where JAX
    has NaN (``tests/test_curvature.py:239-244``); the isosurface's
    element and node counts, its sorted nodes within 1e-9."""
    from peleanalysis_tpu import config as jax_config
    from peleanalysis_tpu.cli import main as jax_cli
    jax_dtype = jax_config.compute_dtype
    plt = jax_inputs["syn" if verb == "curvature" else "odd"]
    keys, out, ext = {
        "grad": (["gradVar=temp"], "outfile", ""),
        "grad64": (["gradVar=temp", "dtype=float64"], "outfile", ""),
        "curvature": (["progressName=temp", "do_gaussCurv=1"], "outfile", ""),
        "isosurface": (["isoCompName=temp", "isoVal=1000"], "outfile_base",
                       ".mef")}[verb]
    argv = [verb.replace("64", ""), f"infile={plt}", *keys, "ndevices=8"]
    try:
        assert cli.main(argv + [D, f"{out}=port"]) == 0
        assert jax_cli(argv + [f"{out}=jax"]) == 0
    finally:
        jax_config.compute_dtype = jax_dtype
    if verb == "isosurface":
        p, j = read_mef("port.mef"), read_mef("jax.mef")
        assert p.n_elts == j.n_elts > 0 and p.n_nodes == j.n_nodes
        np.testing.assert_allclose(np.sort(p.nodes, axis=0),
                                   np.sort(j.nodes, axis=0), rtol=0,
                                   atol=1e-9)
        return
    pn, pf = _fabs("port")
    jn, jf = _fabs("jax")
    assert pn == jn
    for a, b in zip(pf, jf):
        if verb == "grad64":
            np.testing.assert_allclose(a, b, rtol=5e-6, atol=1e-4)
            continue
        if verb == "grad":
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(b).max()))
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(b)
        scale = max(float(np.abs(b[ok]).max(initial=0.0)), 1e-30)
        assert np.abs(a[ok] - b[ok]).max(initial=0.0) / scale < 5e-7
