"""The port's migrating march (``parallel/particles.py``) on the CPU: the
resident march's lines bit for bit over 1-D and 2-D block grids, the JAX
package's ``migrate_march`` within 1e-12 on its own test inputs
(``tests/test_migrate.py``: the drifting vortex), real migration, the JAX
capacity errors, and partStream ``ndevices=8`` against the JAX CLI's."""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from peleanalysis_tpu.parallel.particles import migrate_march as jax_migrate
from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch import config as port_config
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.parallel.mesh import make_mesh
from peleanalysis_tpu_torch.parallel.particles import (
    AXIS, migrate_march, trace_streamlines_migrating)
from peleanalysis_tpu_torch.stream.march_kernels import (march_torch,
                                                         prepare_field)
from peleanalysis_tpu_torch.stream.trace import trace_streamlines
from peleanalysis_tpu_torch.testing import write_synthetic_plotfile


def _vortex_field(shape, plo, dx):
    """Swirling velocity with x drift so particles cross slab boundaries
    (the JAX test's field)."""
    x = plo[0] + (np.arange(shape[0]) + 0.5) * dx[0]
    y = plo[1] + (np.arange(shape[1]) + 0.5) * dx[1]
    z = plo[2] + (np.arange(shape[2]) + 0.5) * dx[2]
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    u = 1.0 + 0.3 * np.sin(2 * np.pi * Y)
    v = 0.5 * np.cos(2 * np.pi * X) + 0.2
    w = 0.3 * np.sin(2 * np.pi * (X + Y))
    return np.stack([u, v, w])


def _resident(vec, plo, dx, h, seeds, n_steps, dirs):
    pos, _ = march_torch(prepare_field(torch.from_numpy(vec)), plo, dx, h,
                         torch.from_numpy(seeds), n_steps,
                         torch.from_numpy(dirs))
    return pos.transpose(0, 1).numpy()


def _senders(paths, plo, dx, core, n):
    """Blocks (along x) that a moving line left after some step."""
    blk = np.clip(np.floor((paths[..., 0] - plo[0]) / dx[0] / core), 0,
                  n - 1)
    moved = (blk[:, 1:] != blk[:, :-1])
    return set(blk[:, :-1][moved].astype(int).tolist())


@pytest.fixture(scope="module")
def vortex():
    shape = (96, 24, 24)
    plo = np.zeros(3)
    dx = np.array([1.0 / 96, 1.0 / 24, 1.0 / 24])
    rng = np.random.default_rng(0)
    seeds = np.stack([rng.uniform(0.15, 0.85, 60),
                      rng.uniform(0.2, 0.8, 60),
                      rng.uniform(0.2, 0.8, 60)], axis=1)
    dirs = np.where(np.arange(60) % 2 == 0, 1.0, -1.0)
    return (_vortex_field(shape, plo, dx).astype(np.float64), plo, dx,
            0.9 * dx[0], seeds, 40, dirs)


def test_migrate_matches_resident_and_jax(vortex):
    vec, plo, dx, h, seeds, n_steps, dirs = vortex
    mesh = make_mesh(8, "cpu", axis_names=(AXIS,))
    paths, counts = migrate_march(torch.from_numpy(vec), plo, dx, h, seeds,
                                  n_steps, dirs, mesh)
    np.testing.assert_array_equal(
        paths, _resident(vec, plo, dx, h, seeds, n_steps, dirs))
    # the lines really moved between blocks: seeds in 4+ blocks, and 4+
    # blocks sent lines to a neighbour
    assert (counts > 0).sum() >= 4
    assert len(_senders(paths, plo, dx, -(-96 // 8), 8)) >= 4
    jmesh = JaxMesh(np.array(jax.devices()[:8]), ("parts",))
    want, jcounts = jax_migrate(vec, plo, dx, h, seeds, n_steps, dirs, jmesh)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_allclose(paths, want, rtol=0, atol=1e-12)


def test_migrate_2d_block_grid_matches_resident():
    """4 x 2 blocks: a corner-crossing line hops x then y in one step."""
    shape = (64, 32, 8)
    xg = (np.arange(shape[0]) + 0.5) / shape[0]
    yg = (np.arange(shape[1]) + 0.5) / shape[1]
    vec = np.zeros((3,) + shape)
    vec[0] = 1.0
    vec[1] = 0.8 * np.cos(2 * np.pi * xg)[:, None, None] + 0.4
    vec[2] = 0.2 * np.sin(2 * np.pi * yg)[None, :, None]
    plo = np.zeros(3)
    dxm = np.array([1.0 / s for s in shape])
    rng = np.random.default_rng(5)
    seeds = np.stack([rng.uniform(0.15, 0.6, 24),
                      rng.uniform(0.2, 0.8, 24),
                      rng.uniform(0.3, 0.7, 24)], axis=1)
    dirs = np.where(np.arange(24) % 2 == 0, 1.0, -1.0)
    mesh = make_mesh(8, "cpu", axis_names=("bx", "by"), shape=(4, 2))
    paths, counts = migrate_march(torch.from_numpy(vec), plo, dxm,
                                  0.9 * dxm[0], seeds, 14, dirs, mesh)
    assert counts.sum() == 24
    np.testing.assert_array_equal(
        paths, _resident(vec, plo, dxm, 0.9 * dxm[0], seeds, 14, dirs))


def test_capacity_errors_match_jax():
    shape = (96, 8, 8)
    plo = np.zeros(3)
    dx = np.array([1.0 / 96, 1.0 / 8, 1.0 / 8])
    vec = np.zeros((3,) + shape)
    vec[0] = 1.0        # uniform +x drift: every line migrates together
    seeds = np.stack([np.full(32, 0.124), np.full(32, 0.5),
                      np.full(32, 0.5)], axis=1)
    mesh = make_mesh(8, "cpu", axis_names=(AXIS,))
    jmesh = JaxMesh(np.array(jax.devices()[:8]), ("parts",))
    args = (plo, dx, 0.9 * dx[0], seeds, 30, np.ones(32))
    for run, m, v in ((migrate_march, mesh, torch.from_numpy(vec)),
                      (jax_migrate, jmesh, vec)):
        with pytest.raises(RuntimeError, match="overflow"):
            run(v, *args, m, capacity=33, send_capacity=4)
        with pytest.raises(ValueError, match="capacity 16 < max initial"):
            run(v, *args, m, capacity=16)


@pytest.fixture(scope="module")
def vel_plotfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pltmig") / "plt00000")
    fields = {
        "x_velocity": lambda x, y, z: 1.0 + 0.3 * np.sin(2 * np.pi * y),
        "y_velocity": lambda x, y, z: 0.5 * np.cos(2 * np.pi * x) + 0.2,
        "z_velocity": lambda x, y, z: 0.3 * np.sin(2 * np.pi * (x + y)),
        "temp": lambda x, y, z: 300 + 1500 * np.exp(
            -((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) / 0.05),
    }
    write_synthetic_plotfile(path, n_cell=32, n_levels=2, fields=fields)
    return path


def test_trace_streamlines_migrating_matches_resident(vel_plotfile):
    ds = DenseAmrState.from_plotfile(vel_plotfile, "cpu",
                                     dtype=torch.float64)
    rng = np.random.default_rng(1)
    seeds = np.stack([rng.uniform(0.2, 0.8, 24) for _ in range(3)], axis=1)
    ref = trace_streamlines(ds, seeds, 21, 0.5, sample_names=("temp",))
    got = trace_streamlines_migrating(
        ds, seeds, 21, 0.5, make_mesh(8, "cpu", axis_names=(AXIS,)),
        sample_names=("temp",))
    np.testing.assert_array_equal(got, ref)


def _lines(path):
    rows = []
    for ln in open(path):
        try:
            rows.append([float(v) for v in ln.split()])
        except ValueError:
            pass
    return np.array([r for r in rows if len(r) == 3])


def test_part_stream_cli_ndevices_8_matches_jax(vel_plotfile, tmp_path,
                                                monkeypatch):
    from peleanalysis_tpu.cli import main as jax_cli
    monkeypatch.setenv("PELE_JAX_CACHE", "0")
    monkeypatch.setattr(port_config, "compute_dtype",
                        port_config.compute_dtype)
    monkeypatch.chdir(tmp_path)
    base = ["partStream", f"infile={vel_plotfile}", "seedRakeL=0.3 0.4 0.45",
            "seedRakeR=0.7 0.6 0.55", "seedRakeNum=16", "Nsteps=21",
            "hRK=0.5", "ndevices=8"]
    assert cli.main(base + ["outFile=port.dat", "device=cpu"]) == 0
    assert jax_cli(base + ["outFile=jax.dat"]) == 0
    a, b = _lines("port.dat"), _lines("jax.dat")
    assert a.shape == b.shape and a.shape[0] > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
