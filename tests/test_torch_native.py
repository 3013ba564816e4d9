"""The port's native host code (``peleanalysis_tpu_torch/native``: the
parallel FAB loader and the snprintf text formatter, built with g++ as on
the card's host) against the JAX package's ``peleanalysis_tpu/native``:
the loader bitwise, the formatter byte for byte on values that trip text
writers (NaN of both signs, +-inf, +-0, subnormals, 1e+-300, int64
extremes)."""
import io
import os
import time

import numpy as np
import pytest

from peleanalysis_tpu import native as jax_native
from peleanalysis_tpu.io.plotfile import PlotfileReader as JaxReader
from peleanalysis_tpu_torch import native
from peleanalysis_tpu_torch.io.plotfile import PlotfileReader, write_plotfile
from peleanalysis_tpu_torch.ops.cuda_build import BUILD_DIR
from peleanalysis_tpu_torch.testing import make_amr_hierarchy, make_level_data


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's native library, loaded in this process.  Its build
    writes the library in place, so a test process that loads it while
    another builds it can find half a file: wait for the other build."""
    deadline = time.monotonic() + 120
    while True:
        try:
            return jax_native.get_lib()
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(1.0)


def hazard_floats(rng, n: int) -> np.ndarray:
    """n float64 values: every value that trips a text writer, then
    random values over 600 decades."""
    special = np.array([
        np.nan, np.copysign(np.nan, -1.0), np.inf, -np.inf, 0.0, -0.0,
        5e-324, -5e-324, 1e-310, -2.2250738585072014e-308, 1e-300, -1e300,
        1.7976931348623157e308, 0.1, 1.0 / 3.0, -123456789.0, 1e16, 1e-5,
        0.5, 100.0, 1e21])
    rnd = rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300, n)
    rnd[: len(special)] = special
    return rnd


def hazard_ints(rng, n: int) -> np.ndarray:
    info = np.iinfo(np.int64)
    out = rng.integers(info.min, info.max, n, dtype=np.int64)
    out[:6] = [info.min, info.max, 0, -1, 1, info.min + 1]
    return out


# -- build --------------------------------------------------------------------
def test_library_builds_under_the_port_build_dir():
    path = native.library_path()
    assert path.parent == BUILD_DIR and path.name.startswith("libpele_native_")
    assert native.get_lib()._name == str(path) and path.exists()
    assert "peleanalysis_tpu_torch" in str(BUILD_DIR)
    assert native.CXX_FLAGS == ("-O3", "-shared", "-fPIC", "-std=c++17",
                                "-pthread")


def test_build_failure_raises(monkeypatch, tmp_path):
    """No pure-Python fallback: a failed build reaches the caller."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS
                        + ("-DPELE_BROKEN", "-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.savetxt_fast(io.BytesIO(), np.ones((3, 2)), fmt="%.9g")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.tecplot_zones(np.ones((2, 3, 4)))
    assert not list(tmp_path.glob("*.so"))


# -- formatter ----------------------------------------------------------------
@pytest.mark.parametrize("what", ["tecplot_zones", "g9", "g12", "g17",
                                  "i_rows"])
def test_formatter_matches_jax(jax_lib, what):
    """Byte-equal to the JAX package's native functions, above fmt.cpp's
    256-line threading cut-off; NaN of either sign prints as glibc prints
    it."""
    rng = np.random.default_rng(7)
    if what == "tecplot_zones":
        lines = hazard_floats(rng, 300 * 7 * 5).reshape(300, 7, 5)
        got, want = native.tecplot_zones(lines), jax_native.tecplot_zones(
            lines)
        assert got.count(b"ZONE T=") == 300
    elif what == "i_rows":
        rows = hazard_ints(rng, 400 * 3).reshape(400, 3)
        got, want = native.format_i_rows(rows), jax_native.format_i_rows(rows)
        assert b"-9223372036854775808" in got
    else:
        prec = int(what[1:])
        rows = hazard_floats(rng, 400 * 4).reshape(400, 4)
        got = native.format_g_rows(rows, prec)
        want = jax_native.format_g_rows(rows, prec)
        assert got.splitlines()[0].split() == [
            b"nan", b"-nan", b"inf", b"-inf"]
    assert got == want


@pytest.mark.parametrize("fmt", ["%.9g", "%.12g", "%.17g", "%d", "%e"])
@pytest.mark.parametrize("mode", ["binary", "text"])
def test_savetxt_fast_matches_jax(jax_lib, tmp_path, fmt, mode):
    """The port's savetxt_fast writes what the JAX package's writes, to a
    binary or a text file, in one or two columns; other formats (jpdf's
    %e) are np.savetxt's."""
    rng = np.random.default_rng(8)
    if fmt == "%d":
        arrs = [hazard_ints(rng, 600).reshape(300, 2), hazard_ints(rng, 9)]
    else:
        arrs = [hazard_floats(rng, 600).reshape(300, 2), hazard_floats(rng,
                                                                       30)]
    for k, arr in enumerate(arrs):
        paths = []
        for name, fn in (("p", native.savetxt_fast),
                         ("j", jax_native.savetxt_fast)):
            p = tmp_path / f"{name}{k}.txt"
            with open(p, "wb" if mode == "binary" else "w") as f:
                fn(f, arr, fmt=fmt)
            paths.append(p)
        assert paths[0].read_bytes() == paths[1].read_bytes()
        assert len(paths[0].read_bytes().splitlines()) == len(arr)


# -- loader -------------------------------------------------------------------
def write_case(path, fab_dtype, ndim: int, max_fabs_per_file: int = 3):
    geoms, bas, ratios = make_amr_hierarchy(16, 2, 2, 8, ndim)
    names, data = make_level_data(geoms, bas)
    rng = np.random.default_rng(ndim)
    # values whose float32 rounding is not exact, and signed zeros
    data = [[d + rng.standard_normal(d.shape) * 1e-3 for d in lev]
            for lev in data]
    data[0][0][0, :2] = -0.0
    write_plotfile(path, names, 0.25, geoms, ratios, bas, data,
                   dtype=fab_dtype, max_fabs_per_file=max_fabs_per_file)
    return names


@pytest.fixture
def load_spy(monkeypatch):
    """Counts load_fabs calls, the native path's mark."""
    calls = []
    real = native.load_fabs

    def spy(*a, **k):
        calls.append(len(a[0]))
        return real(*a, **k)
    monkeypatch.setattr(native, "load_fabs", spy)
    return calls


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint64)


@pytest.mark.parametrize("comps", [None, (2, 0)], ids=["all", "subset"])
@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("fab_dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_native_read_level_bitwise(tmp_path, load_spy, fab_dtype, ndim,
                                   comps):
    """read_level through load_fabs equals read_box and the JAX reader bit
    for bit, over several Cell_D files a level."""
    path = str(tmp_path / "plt")
    write_case(path, fab_dtype, ndim)
    r, jr = PlotfileReader(path), JaxReader(path)
    for lev in range(r.meta.n_levels):
        nbox = len(r.box_array(lev))
        files = {f for f, _ in r._index(lev)["fabs"]}
        assert len(files) == -(-nbox // 3) and len(files) > 1
        got = r.read_level(lev, comps)
        plain = [r.read_box(lev, i, comps) for i in range(nbox)]
        want = jr.read_level(lev, comps)
        assert len(got) == nbox
        for g, p, w, b in zip(got, plain, want, r.box_array(lev)):
            assert g.dtype == np.float64 and g.flags.c_contiguous
            assert g.shape == (r.meta.ncomp if comps is None else 2,) \
                + b.shape
            np.testing.assert_array_equal(_bits(g), _bits(p))
            np.testing.assert_array_equal(_bits(g), _bits(w))
    assert load_spy == [len(r.box_array(lev))
                        for lev in range(r.meta.n_levels)]


def _edit(path, old: bytes, new: bytes, count: int = 1):
    with open(path, "rb") as f:
        text = f.read()
    assert old in text
    with open(path, "wb") as f:
        f.write(text.replace(old, new, count))


def _rewrite_big_endian(lev_dir):
    from peleanalysis_tpu_torch.io.fab import read_fab_header
    for fn in sorted(os.listdir(lev_dir)):
        if "_D_" not in fn:
            continue
        p = os.path.join(lev_dir, fn)
        recs = []
        with open(p, "rb") as f:
            end = os.fstat(f.fileno()).st_size
            while f.tell() < end:
                box, ncomp, dt = read_fab_header(f)
                recs.append((box, ncomp, np.fromfile(
                    f, dtype=dt, count=box.size * ncomp)))
        with open(p, "wb") as f:
            for box, ncomp, payload in recs:
                f.write(b"FAB ((8, (64 11 52 0 1 12 0 1023)),"
                        b"(8, (1 2 3 4 5 6 7 8)))"
                        + repr(box).encode() + b" %d\n" % ncomp)
                payload.astype(">f8").tofile(f)


@pytest.mark.parametrize("case", ["ngrow", "big_endian"])
def test_read_level_per_box_cases(tmp_path, load_spy, case):
    """Grown FABs (ngrow > 0) and big-endian FABs take read_box, and give
    the JAX reader's values."""
    path = str(tmp_path / "plt")
    write_case(path, np.float64, 3)
    lev_dir = os.path.join(path, "Level_1")
    if case == "ngrow":
        # the loader would stride valid boxes through grown records
        h = os.path.join(lev_dir, "Cell_H")
        with open(h) as f:
            lines = f.readlines()
        assert lines[3] == "0\n"              # version, how, ncomp, ngrow
        lines[3] = "1\n"
        with open(h, "w") as f:
            f.writelines(lines)
    else:
        _rewrite_big_endian(lev_dir)
    r, jr = PlotfileReader(path), JaxReader(path)
    for got, want in zip(r.read_level(1, [1, 2]), jr.read_level(1, [1, 2])):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert load_spy == []
    r.read_level(0)
    assert len(load_spy) == 1          # the untouched level stays native


def test_read_level_box_mismatch_raises(tmp_path, load_spy):
    """A FAB whose header box differs in shape from its _H box takes
    read_box, which raises ValueError; it is found on any box, not only
    the first."""
    path = str(tmp_path / "plt")
    write_case(path, np.float64, 3)
    r = PlotfileReader(path)
    b = r.box_array(0)[-1]
    fname, off = r._index(0)["fabs"][-1]
    grown = repr(type(b)(b.lo, tuple(h + 1 for h in b.hi)))
    with open(os.path.join(path, "Level_0", fname), "rb") as f:
        f.seek(off)
        head = f.readline()
    _edit(os.path.join(path, "Level_0", fname), head,
          head.replace(repr(b).encode(), grown.encode()))
    with pytest.raises(ValueError, match="FAB/box mismatch at lev 0 box 7"):
        PlotfileReader(path).read_level(0)
    assert load_spy == []


def test_read_level_truncated_fab_raises(tmp_path, load_spy):
    """A record the loader cannot read raises; nothing falls back."""
    path = str(tmp_path / "plt")
    write_case(path, np.float32, 3)
    r = PlotfileReader(path)
    fname = r._index(1)["fabs"][-1][0]
    p = os.path.join(path, "Level_1", fname)
    os.truncate(p, os.path.getsize(p) - 4)
    with pytest.raises(OSError, match="could not be read"):
        r.read_level(1)
    assert load_spy == [len(r.box_array(1))]
    with pytest.raises(ValueError, match="out of range"):
        r.read_level(0, [r.meta.ncomp])


def test_load_fabs_checks_its_destinations():
    with pytest.raises(ValueError, match="C-contiguous float64"):
        native.load_fabs(["x"], [0], [[2, 2, 2]], [0], 8,
                         [np.empty((1, 2, 2, 2), np.float32)])
    with pytest.raises(ValueError, match="itemsize"):
        native.load_fabs(["x"], [0], [[2, 2, 2]], [0], 2,
                         [np.empty((1, 2, 2, 2))])
    assert 1 <= native.loader_threads() <= native.MAX_THREADS
