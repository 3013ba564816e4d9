"""Parity of the port's streamline march and ``trace_streamlines`` with the
JAX package's on identical inputs (CPU: the march's plain version).

Tolerances:
  * float64 march: 1e-12 of the domain extent (the same operations; the
    JAX einsum may sum the 8 corners in another order);
  * float32 march: 1e-5 of the extent, as the JAX package holds its Pallas
    march to its XLA march;
  * trace_streamlines of a float32 state: both packages march and sample
    the float32 fields in float64, so only the fields can differ, by an ulp
    or so where the JAX package's compiled fill contracts a multiply-add.
    Lines agree to 5e-8 of the extent (4 float32 ulps of the unit vector
    over the ~0.16 path length) and sampled fields to 2.5e-7 of their
    largest value (4 float32 ulps);
  * the lossy packing: one int16 delta step (h/32000) per station between
    the seed and the point, one uint16 step of the line's range (1/65535)
    for sampled fields;
  * ``alive`` flags: identical.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peleanalysis_tpu.amr.dense import DenseAmrState as JaxDense
from peleanalysis_tpu.amr.hierarchy import AmrState
from peleanalysis_tpu.stream.pallas_march import march_pallas
from peleanalysis_tpu.stream.trace import _trace_level
from peleanalysis_tpu.stream.trace import \
    trace_streamlines as jax_trace_streamlines
from peleanalysis_tpu.testing import write_synthetic_plotfile
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.stream import march_kernels as mk
from peleanalysis_tpu_torch.stream.trace import (assign_seeds_to_levels,
                                                 trace_streamlines)

TORCH = {np.float64: torch.float64, np.float32: torch.float32}
EXTENT_TOL = {np.float64: 1e-12, np.float32: 1e-5}
# trace_streamlines: (lines over the extent, sampled fields over their scale)
TRACE_TOL = {np.float64: (1e-12, 1e-12), np.float32: (5e-8, 2.5e-7)}


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


# -- the march ----------------------------------------------------------------
def _rotating_case():
    """tests/test_stream.py:397: interior lines in a swirling field."""
    rng = np.random.default_rng(1)
    S = (24, 20, 90)
    X, Y, Z = np.meshgrid(*[np.linspace(0, 1, s) for s in S], indexing="ij")
    vec = np.stack([-(Y - 0.5) + 0.05 * np.sin(6 * Z),
                    (X - 0.5) + 0.05 * np.cos(5 * Z),
                    0.1 * np.sin(4 * X)])
    dx = np.array([1 / 23, 1 / 19, 1 / 89])
    seeds = np.stack([0.35 + 0.3 * rng.random(8) for _ in range(3)], 1)
    dirs = np.where(rng.random(8) > 0.5, 1.0, -1.0)
    return vec, np.zeros(3), dx, float(0.5 * dx.min()), seeds, dirs, 7


def _boundary_case():
    """tests/test_stream.py:431: strong outward drift, lines exit and
    freeze at every face."""
    S = (16, 18, 88)
    X, Y, Z = np.meshgrid(*[np.linspace(0, 1, s) for s in S], indexing="ij")
    vec = np.stack([X - 0.45, Y - 0.55, Z - 0.5])
    dx = np.array([1 / 15, 1 / 17, 1 / 87])
    corners = [0.03, 0.5, 0.97]
    seeds = np.array([[a, b, c] for a in corners for b in corners
                      for c in corners][:24])
    dirs = np.where(np.arange(24) % 2 == 0, 1.0, -1.0)
    return vec, np.zeros(3), dx, float(0.5 * dx.min()), seeds, dirs, 60


CASES = {"rotating": _rotating_case, "boundary": _boundary_case}


def _port_march(vec, plo, dx, h, seeds, dirs, n, state_dt, field_dt=None,
                fn=mk.march_torch):
    td = TORCH[state_dt]
    field = mk.prepare_field(torch.from_numpy(vec).to(td),
                             field_dt or td)
    return fn(field, plo, dx, h, torch.from_numpy(seeds).to(td), n,
              torch.from_numpy(dirs).to(td))


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_march_torch_matches_trace_level(case, dt):
    vec, plo, dx, h, seeds, dirs, n = CASES[case]()
    want, want_ok = _trace_level(
        jnp.asarray(vec, dt), jnp.asarray(vec, dt), jnp.asarray(plo, dt),
        jnp.asarray(dx, dt), h, jnp.asarray(seeds, dt), n,
        jnp.asarray(dirs, dt)[:, None])
    got, ok = _port_march(vec, plo, dx, h, seeds, dirs, n, dt)
    assert got.dtype == TORCH[dt] and got.shape == (n + 1, len(seeds), 3)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=EXTENT_TOL[dt])
    if case == "boundary":   # lines do freeze, and the frozen stay put
        assert not ok.numpy().all() and ok.numpy().any()
        assert torch.isfinite(got).all()


def test_march_torch_matches_pallas_interpret():
    vec, plo, dx, h, seeds, dirs, n = _rotating_case()
    want = march_pallas(jnp.asarray(vec, jnp.float32), plo, dx, h,
                        jnp.asarray(seeds), n, jnp.asarray(dirs), L=8,
                        interpret=True)
    got, _ = _port_march(vec, plo, dx, h, seeds, dirs, n, np.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_field_matches_jax_bf16_march(case, dt):
    """bfloat16 field storage: the JAX gather widens bf16 to float32 and
    marches in the state dtype, as the port does."""
    vec, plo, dx, h, seeds, dirs, n = CASES[case]()
    want, want_ok = _trace_level(
        jnp.asarray(vec, jnp.float32).astype(jnp.bfloat16), None,
        jnp.asarray(plo, dt), jnp.asarray(dx, dt), h,
        jnp.asarray(seeds, dt), n, jnp.asarray(dirs, dt)[:, None])
    # the port rounds the float32 field to bfloat16 as JAX's astype does
    got, ok = _port_march(vec.astype(np.float32), plo, dx, h,
                          seeds.astype(dt), dirs, n, dt,
                          field_dt=torch.bfloat16)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=EXTENT_TOL[dt])


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_field_f64_positions_match_trace_level(case):
    """A float32 state's march: the JAX package (x64 on) gathers the
    float32 field and marches float64 seeds in float64, as the port does."""
    vec, plo, dx, h, seeds, dirs, n = CASES[case]()
    want, want_ok = _trace_level(
        jnp.asarray(vec, jnp.float32), None, jnp.asarray(plo),
        jnp.asarray(dx), h, jnp.asarray(seeds), n,
        jnp.asarray(dirs)[:, None])
    assert want.dtype == jnp.float64
    got, ok = _port_march(vec.astype(np.float32), plo, dx, h, seeds, dirs, n,
                          np.float64, field_dt=torch.float32)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=EXTENT_TOL[np.float64])


VARIANTS = {"f64": (torch.float64, torch.float64),
            "f32": (torch.float32, torch.float32),
            "f32_f64": (torch.float32, torch.float64),
            "bf16_f64": (torch.bfloat16, torch.float64),
            "bf16_f32": (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("dtype, C", [(torch.float64, 3), (torch.float32, 4),
                                      (torch.bfloat16, 4)])
def test_prepare_field_layout(dtype, C):
    """A float32 or bfloat16 cell is padded with a zero 4th component, a
    float64 cell is not; values round as ``.to(dtype)`` rounds them."""
    vec = torch.from_numpy(_rotating_case()[0])
    field = mk.prepare_field(vec, dtype)
    assert field.shape == vec.shape[1:] + (C,) and field.dtype == dtype
    assert field.is_contiguous() and mk.COMPONENTS[dtype] == C
    assert torch.equal(field[..., :3], vec.permute(1, 2, 3, 0).to(dtype))
    assert not field[..., 3:].any()


def _unpadded_march(field3, plo, dx, h, seeds, n_steps, dirs):
    """The plain march as it read the ``[SX, SY, SZ, 3]`` field before the
    kernel's field was padded."""
    dt = seeds.dtype
    SX, SY, SZ, _ = field3.shape
    flat = field3.reshape(-1, 3)
    plo_t, dx_t = torch.tensor(plo, dtype=dt), torch.tensor(dx, dtype=dt)
    hi = torch.tensor([SX - 2, SY - 2, SZ - 2], dtype=dt)
    corner = torch.tensor([(o[0] * SY + o[1]) * SZ + o[2]
                           for o in mk.CORNER_OFFSETS_S])
    tiny = torch.full((), torch.finfo(dt).tiny, dtype=dt)
    h_half, h_t, h_sixth = (torch.full((), v, dtype=dt)
                            for v in (0.5 * h, h, h / 6.0))
    dirs = dirs[:, None]

    def unit_vec(x):
        xc = (x - plo_t) / dx_t - 0.5
        b = torch.floor(xc)
        ok = ((b >= 0) & (b <= hi)).all(dim=1)
        b = torch.minimum(torch.clamp(b, min=0), hi)
        t = torch.clamp(xc - b, 0.0, 1.0)
        bi = b.long()
        c = flat[((bi[:, 0] * SY + bi[:, 1]) * SZ + bi[:, 2])[:, None]
                 + corner[None, :]].to(dt)
        w1 = [[1 - t[:, d], t[:, d]] for d in range(3)]
        v = None
        for ci, (ox, oy, oz) in enumerate(mk.CORNER_OFFSETS_S):
            term = c[:, ci] * ((w1[0][ox] * w1[1][oy]) * w1[2][oz])[:, None]
            v = term if v is None else v + term
        n = torch.sqrt((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1])
                       + v[:, 2] * v[:, 2])
        return dirs * v / torch.maximum(n, tiny)[:, None], ok

    x, alive = seeds, torch.ones(seeds.shape[0], dtype=torch.bool)
    out = [seeds]
    for _ in range(n_steps):
        k1, ok1 = unit_vec(x)
        k2, ok2 = unit_vec(x + h_half * k1)
        k3, ok3 = unit_vec(x + h_half * k2)
        k4, ok4 = unit_vec(x + h_t * k3)
        xn = x + h_sixth * (((k1 + 2 * k2) + 2 * k3) + k4)
        alive = alive & ok1 & ok2 & ok3 & ok4
        x = torch.where(alive[:, None], xn, x)
        out.append(x)
    return torch.stack(out), alive


@pytest.mark.parametrize("var", sorted(VARIANTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_march_torch_on_new_layout_equals_unpadded_march(case, var):
    """``march_torch`` over ``prepare_field``'s layout equals the march over
    the unpadded field bitwise, and ignores whatever the pad holds."""
    vec, plo, dx, h, seeds, dirs, n = CASES[case]()
    fdt, sdt = VARIANTS[var]
    vec = torch.from_numpy(vec).to(sdt)
    s, d = torch.from_numpy(seeds).to(sdt), torch.from_numpy(dirs).to(sdt)
    field = mk.prepare_field(vec, fdt)
    got, ok = mk.march_torch(field, plo, dx, h, s, n, d)
    want, want_ok = _unpadded_march(
        vec.permute(1, 2, 3, 0).to(fdt).contiguous(), plo, dx, h, s, n, d)
    assert torch.equal(got, want) and torch.equal(ok, want_ok)
    if field.shape[3] == 4:
        field[..., 3] = float("nan")
        again, again_ok = mk.march_torch(field, plo, dx, h, s, n, d)
        assert torch.equal(again, got) and torch.equal(again_ok, ok)


@pytest.mark.parametrize("shape", [(24, 20, 90), (4000, 20, 1500)])
def test_order_key_is_a_locality_permutation(shape):
    """The lines sorted by ``order_key``: a permutation that puts the two
    directions apart and neighbouring seeds together; marching in that
    order and writing each line at its own index (as the kernel does)
    gives the march in seed order bitwise."""
    vec, plo, dx, h, seeds, dirs, n = _rotating_case()
    dx = tuple(1.0 / (s - 1) for s in shape)
    rng = np.random.default_rng(3)
    # seeds on a ring in random order, in both directions
    a = rng.random(200) * 2 * np.pi
    ring = np.stack([0.5 + 0.2 * np.cos(a), 0.5 + 0.2 * np.sin(a),
                     np.full_like(a, 0.5)], 1)
    s = torch.from_numpy(np.concatenate([ring, ring]))
    d = torch.cat([torch.ones(200), -torch.ones(200)]).to(torch.float64)
    before = mk.KEY_LAUNCHES
    key = mk.order_key(shape, plo, dx, s, d)
    assert mk.KEY_LAUNCHES == before        # no kernel launch on the CPU
    assert key.dtype == torch.int32 and torch.equal(
        key, mk.order_key_torch(shape, plo, dx, s, d))
    assert (key >= 0).all() and torch.equal(key >> 30, (d < 0).int())
    assert (key & ((1 << 30) - 1)).max() < 1 << 30
    order = torch.argsort(key)
    assert torch.equal(torch.sort(order).values, torch.arange(400))
    assert torch.equal(s[order][torch.argsort(order)], s)
    assert (d[order][:200] > 0).all()                 # + lines first
    if shape[0] < 1000:
        def step(p):       # mean distance between consecutive + lines
            return float((p[1:200] - p[:199]).norm(dim=1).mean())
        assert step(s[order]) < 0.5 * step(s)
    if shape[0] < 1000:
        field = mk.prepare_field(torch.from_numpy(vec))
        want, want_ok = mk.march_torch(field, plo, dx, h, s, n, d)
        pos, ok = mk.march_torch(field, plo, dx, h, s[order], n, d[order])
        got, got_ok = torch.empty_like(pos), torch.empty_like(ok)
        got[:, order], got_ok[order] = pos, ok
        assert torch.equal(got, want) and torch.equal(got_ok, want_ok)


@pytest.mark.parametrize("bad", ["seeds", "dirs"])
def test_order_key_takes_float64_only(bad):
    """Only the float64 march is ordered: the key refuses float32
    positions or directions on every device."""
    vec, plo, dx, h, seeds, dirs, n = _rotating_case()
    args = dict(seeds=torch.from_numpy(seeds), dirs=torch.from_numpy(dirs))
    args[bad] = args[bad].to(torch.float32)
    with pytest.raises(TypeError):
        mk.order_key(vec.shape[1:], plo, dx, args["seeds"], args["dirs"])


def test_march_dispatcher_cpu_takes_plain_version():
    vec, plo, dx, h, seeds, dirs, n = _rotating_case()
    before = mk.LAUNCHES
    got, ok = _port_march(vec, plo, dx, h, seeds, dirs, n, np.float64,
                          fn=mk.march)
    assert mk.LAUNCHES == before            # no kernel launch on the CPU
    want, want_ok = _port_march(vec, plo, dx, h, seeds, dirs, n, np.float64)
    assert torch.equal(got, want) and torch.equal(ok, want_ok)


@pytest.mark.parametrize("bad, err", [
    (dict(field=lambda f: f.to(torch.float16)), TypeError),
    (dict(seeds=lambda s: s.to(torch.float32),                # dtype mix
          dirs=lambda d: d.to(torch.float32)), TypeError),
    (dict(field=lambda f: f.transpose(0, 1)), ValueError),    # layout
    (dict(field=lambda f: f[..., :2]), ValueError),
    (dict(seeds=lambda s: s[:, :2]), ValueError),
    (dict(dirs=lambda d: d[:-1]), ValueError),
    (dict(dirs=lambda d: d.to(torch.float32)), ValueError),
    # a float32 field's cells are padded to 4 components
    (dict(field=lambda f: f.to(torch.float32)), ValueError),
    # off the 16-byte boundary of the kernel's vector loads
    (dict(field=lambda f: torch.empty(f.numel() + 1, dtype=f.dtype)[1:]
          .view(f.shape)), ValueError),
    # 2**31 elements or more: beyond the kernel's 32-bit offsets
    (dict(field=lambda f: torch.empty((1024, 1024, 683, 3),
                                      dtype=torch.float64, device="meta")),
     ValueError),
])
def test_march_dispatcher_rejects(bad, err):
    vec, plo, dx, h, seeds, dirs, n = _rotating_case()
    args = dict(field=mk.prepare_field(torch.from_numpy(vec)),
                seeds=torch.from_numpy(seeds), dirs=torch.from_numpy(dirs))
    for k, f in bad.items():
        args[k] = f(args[k])
    with pytest.raises(err):
        mk.march(args["field"], plo, dx, h, args["seeds"], n, args["dirs"])


def test_march_build_needs_no_import_time_toolkit():
    p = mk.library_path()
    assert p.name.startswith("libstream_march_") and p.suffix == ".so"
    assert mk._LIB is None
    assert set(mk._ENTRY.values()) == {
        "stream_march_f64", "stream_march_f32", "stream_march_f32_f64",
        "stream_march_bf16_f64", "stream_march_bf16_f32"}
    assert mk._KEY == "stream_march_key_f64"
    assert mk.ORDERED == {(torch.float64, torch.float64)}


# -- trace_streamlines ---------------------------------------------------------
@pytest.fixture(scope="module")
def plotfiles(tmp_path_factory):
    out = {}
    for n_levels in (2, 3):
        path = str(tmp_path_factory.mktemp(f"plt{n_levels}") / "plt")
        write_synthetic_plotfile(path, n_cell=16, n_levels=n_levels,
                                 max_grid_size=8)
        out[n_levels] = path
    return out


def _states(path, dt):
    jds = JaxDense.from_batched(AmrState.from_plotfile(path, dtype=dt))
    return jds, port_state(jds)


def _seeds(n=24, seed=5):
    rng = np.random.default_rng(seed)
    return 0.5 + 0.6 * (rng.random((n, 3)) - 0.5)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n_levels", [2, 3])
@pytest.mark.parametrize("trace_field", ["progress", None])
def test_trace_streamlines_parity(plotfiles, trace_field, n_levels, dt):
    jds, pds = _states(plotfiles[n_levels], dt)
    seeds = _seeds()
    kw = dict(n_rk_steps=21, h_rk=0.5, trace_field=trace_field,
              sample_names=("temp", "density"))
    want = jax_trace_streamlines(jds, seeds, **kw)
    got = trace_streamlines(pds, seeds, **kw)
    # seeds spread over every level
    assert set(assign_seeds_to_levels(pds, seeds)) == set(range(n_levels))
    assert got.shape == want.shape == (len(seeds), 21, 5)
    pos_tol, val_tol = TRACE_TOL[dt]
    np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=0,
                               atol=pos_tol)
    for c in (3, 4):
        scale = np.abs(want[..., c]).max()
        np.testing.assert_allclose(got[..., c], want[..., c], rtol=0,
                                   atol=val_tol * scale)


def test_trace_engines_agree_on_cpu(plotfiles):
    _, pds = _states(plotfiles[2], np.float64)
    seeds = _seeds(8)
    kw = dict(n_rk_steps=11, h_rk=0.5, trace_field="progress")
    auto = trace_streamlines(pds, seeds, **kw)
    # every name but "cuda" marches a CPU state through the plain version
    for name in ("torch", "xla", "pallas"):
        np.testing.assert_array_equal(
            trace_streamlines(pds, seeds, march_engine=name, **kw), auto)
    with pytest.raises(ValueError, match="device=cuda"):
        trace_streamlines(pds, seeds, march_engine="cuda", **kw)
    # a CUDA state never takes the plain version: "torch" is refused before
    # any tensor is touched
    on_card = copy.copy(pds)
    on_card.device = torch.device("cuda")
    with pytest.raises(ValueError, match="device=cpu"):
        trace_streamlines(on_card, seeds, march_engine="torch", **kw)
    with pytest.raises(ValueError, match="march_engine"):
        trace_streamlines(pds, seeds, march_engine="fused", **kw)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("march_dtype", ["bfloat16", None])
def test_compressed_packing_matches_jax(plotfiles, march_dtype, dt):
    jds, pds = _states(plotfiles[3], dt)
    seeds = _seeds(32, seed=9)
    h_rk, n_half = 0.5, 10
    kw = dict(n_rk_steps=2 * n_half + 1, h_rk=h_rk, trace_field="progress",
              sample_names=("temp",), march_dtype=march_dtype,
              fetch_compress=True)
    want = jax_trace_streamlines(jds, seeds, **kw)
    got = trace_streamlines(pds, seeds, **kw)
    h_phys = h_rk * pds.meta.geoms[-1].dx[0]
    # reconstruction walks out from the exact seed station: station j may
    # differ by |j - n_half| delta steps where a rounding fell the other way
    steps = np.abs(np.arange(2 * n_half + 1) - n_half)[None, :, None]
    pos_tol, val_tol = TRACE_TOL[dt]
    bound = steps * h_phys / 32000.0 + pos_tol + 1e-7   # seed in float32
    assert (np.abs(got[..., :3] - want[..., :3]) <= bound).all()
    rng = want[..., 3].max(axis=1) - want[..., 3].min(axis=1)
    err = np.abs(got[..., 3] - want[..., 3]).max(axis=1)
    scale = np.abs(want[..., 3]).max()
    assert (err <= rng / 65535.0 + val_tol * scale + 1e-4).all()


def test_default_packing_follows_march_dtype(plotfiles):
    """bfloat16 marches pack lossily by default; full precision does not."""
    _, pds = _states(plotfiles[2], np.float64)
    seeds = _seeds(8)
    kw = dict(n_rk_steps=11, h_rk=0.5, trace_field="progress")
    exact = trace_streamlines(pds, seeds, **kw)
    np.testing.assert_array_equal(
        exact, trace_streamlines(pds, seeds, fetch_compress=False, **kw))
    lossy = trace_streamlines(pds, seeds, march_dtype="bfloat16", **kw)
    np.testing.assert_array_equal(
        lossy, trace_streamlines(pds, seeds, march_dtype="bfloat16",
                                 fetch_compress=True, **kw))


def test_defer_raises(plotfiles):
    _, pds = _states(plotfiles[2], np.float64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        trace_streamlines(pds, _seeds(4), 11, 0.5, trace_field="progress",
                          defer=True)
