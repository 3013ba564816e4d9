"""Parity of the port's gradient plain version and stencils with the JAX
package (``ops/stencil.py`` and the Pallas ``grad_mag_pallas`` run in
interpret mode).  The CUDA kernel itself runs only on the card; its
comparison with ``grad_mag_torch`` is a phase of ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peleanalysis_tpu.ops import stencil as jst
from peleanalysis_tpu.ops.pallas_kernels import HAVE_PALLAS, grad_mag_pallas
from peleanalysis_tpu_torch import telemetry
from peleanalysis_tpu_torch.ops import grad_kernels as gk
from peleanalysis_tpu_torch.ops import stencil as tst

SHAPE = (13, 18, 21)          # deliberately unaligned interior
DX = (0.1, 0.2, 0.3)          # anisotropic
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _grown(np_dtype, seed=0, ghosts=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=tuple(s + 2 * ghosts for s in SHAPE)).astype(np_dtype)


@pytest.mark.parametrize("with_mag", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_grad_mag_torch_matches_stencil(dt, with_mag):
    np_dtype, t_dtype = DTYPES[dt]
    g = _grown(np_dtype)
    got = gk.grad_mag_torch(torch.from_numpy(g), DX, with_mag).numpy()
    gx, gy, gz = jst.centered_gradient(jnp.asarray(g)[None], DX, 1)
    assert got.shape == ((4 if with_mag else 3),) + SHAPE
    assert got.dtype == np_dtype
    # exact: same operations in the same order ((a - b) / (dtype)(2 dx))
    for d, want in enumerate((gx, gy, gz)):
        np.testing.assert_array_equal(got[d], np.asarray(want)[0])
    if with_mag:
        # the oracle: the dtype's ((gx*gx + gy*gy) + gz*gz), its square
        # root taken in float64 (numpy's is correctly rounded) and rounded
        # to the dtype.  1 ulp: PyTorch's vectorized CPU sqrt is not always
        # correctly rounded (XLA's and the card's are).  The JAX side's
        # distance is reported, not asserted: the port is held to the
        # oracle, not to the reference's rounding.
        g3 = got[:3]
        oracle = np.sqrt(((g3[0] * g3[0] + g3[1] * g3[1]) + g3[2] * g3[2])
                         .astype(np.float64)).astype(np_dtype)
        jax_ulp = int(_ulp_distance(
            np.asarray(jst.magnitude(gx, gy, gz))[0], oracle).max())
        port_ulp = _ulp_distance(got[3], oracle)
        assert port_ulp.max() <= 1, (
            f"port magnitude {int(port_ulp.max())} ulp from the correctly "
            f"rounded oracle at {int((port_ulp > 1).sum())} cells; the JAX "
            f"magnitude is {jax_ulp} ulp from it")


def _ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Units in the last place between two arrays of finite non-negative
    floats of one dtype."""
    ity = np.int32 if a.dtype == np.float32 else np.int64
    return np.abs(a.view(ity).astype(np.int64) - b.view(ity).astype(np.int64))


@pytest.mark.skipif(not HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("with_mag", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_grad_mag_torch_matches_pallas_interpret(dt, with_mag):
    np_dtype, _ = DTYPES[dt]
    g = _grown(np_dtype, seed=1)
    got = gk.grad_mag_torch(torch.from_numpy(g), DX, with_mag).numpy()
    want = np.asarray(grad_mag_pallas(jnp.asarray(g), DX, interpret=True))
    # 2e-6: the Pallas kernel multiplies by a float32 reciprocal of 2 dx
    # where the port divides by 2 dx
    np.testing.assert_allclose(got, want[: got.shape[0]], rtol=2e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_grad_mag_dispatcher_cpu_takes_plain_version(dt):
    np_dtype, _ = DTYPES[dt]
    g = torch.from_numpy(_grown(np_dtype, seed=2))
    before = telemetry.counter("kernel.grad_mag")
    got = gk.grad_mag(g[None], DX)          # leading channel axis accepted
    # no kernel launch on the CPU
    assert telemetry.counter("kernel.grad_mag") == before
    torch.testing.assert_close(got, gk.grad_mag_torch(g, DX), rtol=0, atol=0)


@pytest.mark.parametrize("bad, err", [
    (lambda g: g.to(torch.float16), TypeError),
    (lambda g: g.transpose(0, 2), ValueError),           # not contiguous
    (lambda g: g[None, None], ValueError),                # ndim 5
    (lambda g: torch.stack([g, g]), ValueError),          # 2 channels
    (lambda g: g[:2].contiguous(), ValueError),           # no interior cell
])
def test_grad_mag_dispatcher_rejects(bad, err):
    g = torch.from_numpy(_grown(np.float32))
    with pytest.raises(err):
        gk.grad_mag(bad(g), DX)


def test_grad_mag_build_needs_no_import_time_toolkit():
    # the library path is a pure function of source + flags; nothing is
    # compiled or loaded until a CUDA tensor reaches the dispatcher
    p = gk.library_path()
    assert p.parent == gk.BUILD_DIR and p.name.startswith("libgrad_mag_")
    assert gk._LIB is None
    assert "--fmad=false" in gk.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in gk.NVCC_FLAGS


@pytest.mark.parametrize("shrink", [1, 2])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_stencils_match_jax(dt, shrink):
    np_dtype, _ = DTYPES[dt]
    g = _grown(np_dtype, seed=3, ghosts=2)[None]
    vec = [_grown(np_dtype, seed=4 + d, ghosts=2) for d in range(3)]
    tg = torch.from_numpy(g)
    jg = jnp.asarray(g)
    # exact: each is the same slice arithmetic in the same order
    for a, b in zip(tst.centered_gradient(tg, DX, shrink),
                    jst.centered_gradient(jg, DX, shrink)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    H = tst.hessian(tg, DX, shrink)
    Hj = jst.hessian(jg, DX, shrink)
    for i in range(3):
        for j in range(3):
            np.testing.assert_array_equal(H[i][j].numpy(),
                                          np.asarray(Hj[i][j]))
    np.testing.assert_array_equal(tst.laplacian(tg, DX, shrink).numpy(),
                                  np.asarray(jst.laplacian(jg, DX, shrink)))
    np.testing.assert_array_equal(
        tst.divergence([torch.from_numpy(v) for v in vec], DX, shrink).numpy(),
        np.asarray(jst.divergence([jnp.asarray(v) for v in vec], DX, shrink)))
    np.testing.assert_array_equal(tst.interior(tg, shrink).numpy(),
                                  np.asarray(jst.interior(jg, shrink)))
