"""Smoke run of the PyTorch port on one NVIDIA GPU: build the CUDA kernels,
check each against its plain PyTorch version, drive the grad, curvature,
stream, sampleStreamlines and isosurface tools through their CLI on
synthetic 3-level hierarchies, and time the main path (grad, curvature,
isosurface).

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):
  1 device   - refuse to run without torch.cuda; print the card's name and
               power limit (nvidia-smi)
  2 build    - nvcc builds of peleanalysis_tpu_torch/csrc/grad_mag.cu and
               stream_march.cu, started together
  3 kernel   - grad_mag kernel vs grad_mag_torch on the card, float32 and
               float64, with and without the magnitude: gradients bitwise,
               magnitude within 1 ulp; median times over 20 runs
  3b march   - stream_march kernel vs march_torch on the card: float64,
               float32 (float32 and float64 positions) and bfloat16 fields,
               boundary-exit lines up to the production line count; median
               times
  4 main     - the repo's 3-level case (64^3 -> 120^3 finest patch) through
               `grad` and `curvature` (cli.main), cold then 3 warm runs;
               kernel launch counts, finiteness and the analytic gradient
  4b stream  - the repo case through `stream` (gradient mode and
               traceAlongV=1) and `sampleStreamlines`: launch counts,
               finiteness, and the analytic radial-line check
  5 prod     - a 3-level case with a 248^3 finest patch (19.5 M cells), one
               warm run of each tool, peak device memory and a per-layer
               split (read / device compute / write)
  5b stream  - the same case seeded from a 130k-node sphere MEF through
               `stream` and `sampleStreamlines`, with the same measurements,
               and the trace under torch.profiler (device-to-host copy and
               march kernel device times), float64 and bfloat16-packed
  6 cpu      - compute_grad_dense, compute_curvature_dense and
               trace_streamlines of the repo case on the card vs on the CPU
               (plain versions); every marchEngine name launches the march
               kernel on the card, and "torch" is refused there
  7 iso      - `isosurface` on the repo case at temp = 1000 K: a closed
               watertight sphere (Euler characteristic 2, area and radius
               bounds), every large tensor of the extraction on the card
  7b iso cpu - the same extraction on the card and on the CPU: identical
               elements, nodes within 1e-12 of each column's scale
  7c iso prod- the 19.5 M-cell case: warm CLI wall, read / extract / write,
               peak device memory, host waits per extraction and the
               extraction's device time by stage (torch.profiler)
  8 main path- grad, curvature and isosurface of one float32 state (the
               JAX bench's composite), median CUDA-event time of each, at
               the repo case and at production size
The line before the last is the kernel summary ({"kernels": [...]}); the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.amr.hierarchy import load_plotfile_fabs
from peleanalysis_tpu_torch.geom.marching_cubes import extract_isosurface
from peleanalysis_tpu_torch.io.mef import MEF, read_mef, write_mef
from peleanalysis_tpu_torch.io.stream_data import (StreamData,
                                                   compute_inside_nodes,
                                                   read_stream_data,
                                                   write_stream_data)
from peleanalysis_tpu_torch.ops import grad_kernels as gk
from peleanalysis_tpu_torch.stream import march_kernels as mk
from peleanalysis_tpu_torch.stream.trace import trace_streamlines
from peleanalysis_tpu_torch.testing import (cell_centers, default_fields,
                                            write_synthetic_plotfile)
from peleanalysis_tpu_torch.tools.curvature import compute_curvature_dense
from peleanalysis_tpu_torch.tools.grad import compute_grad_dense
from peleanalysis_tpu_torch.tools.stream import write_tecplot_lines

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO_CASE = dict(n_cell=64, n_levels=3, max_grid_size=32)     # bench.py:156
PROD_CASE = dict(n_cell=128, n_levels=3, max_grid_size=64)
LAUNCHES_PER_LEVEL = {"grad": 1, "curvature": 7}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, n=20, warmup=3) -> float:
    """Median device time of fn() over n runs, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two tensors of
    non-negative values."""
    ity = torch.int32 if a.dtype == torch.float32 else torch.int64
    return int((a.view(ity).long() - b.view(ity).long()).abs().max())


# -- phase 1 --------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda is not available: this smoke run "
                           "needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi})
    return smi


# -- phase 2 --------------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(2) as ex:
        paths = list(ex.map(lambda m: m.build(verbose=True), (gk, mk)))
    gk.load_library()
    mk.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(p, ROOT) for p in paths]})


# -- phase 3 --------------------------------------------------------------------
def phase_kernel(dev) -> dict:
    gen = torch.Generator().manual_seed(0)
    dx = (0.1, 0.2, 0.3)
    cases, worst, main_times = [], 0.0, {}
    for interior in ((13, 18, 21), (64, 64, 64), (120, 120, 120),
                     (248, 248, 248)):
        grown_shape = tuple(s + 2 for s in interior)
        for dtype in (torch.float32, torch.float64):
            g = torch.randn(grown_shape, generator=gen,
                            dtype=torch.float64).to(dev, dtype)
            for with_mag in (True, False):
                k = gk.grad_mag(g, dx, with_mag)
                p = gk.grad_mag_torch(g, dx, with_mag)
                torch.cuda.synchronize()
                if not torch.equal(k[:3], p[:3]):
                    raise AssertionError(f"gradient differs from plain at "
                                         f"{grown_shape} {dtype}")
                ulps = ulp_diff(k[3], p[3]) if with_mag else 0
                if ulps > 1:
                    raise AssertionError(f"magnitude {ulps} ulp off at "
                                         f"{grown_shape} {dtype}")
                err = float((k - p).abs().max())
                worst = max(worst, err)
                ms = cuda_ms(lambda: gk.grad_mag(g, dx, with_mag))
                plain_ms = cuda_ms(lambda: gk.grad_mag_torch(g, dx, with_mag))
                n = int(np.prod(interior))
                nbytes = g.element_size() * (g.numel() + k.shape[0] * n)
                case = {"grown": list(grown_shape), "dtype": str(dtype)[6:],
                        "with_mag": with_mag, "max_abs_err": err,
                        "mag_ulps": ulps, "ms": ms, "plain_ms": plain_ms,
                        "kernel_GBps": nbytes / ms / 1e6}
                cases.append(case)
                main_times[(grown_shape, dtype, with_mag)] = (ms, plain_ms)
    emit({"phase": "kernel_vs_plain", "tolerance": "gradients bitwise, "
          "magnitude <= 1 ulp", "cases": cases})
    ms, plain_ms = main_times[((122, 122, 122), torch.float32, True)]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


# -- phase 3b -------------------------------------------------------------------
# (field dtype, position dtype) of the march kernel's five variants
MARCH_VARIANTS = {"f64": (torch.float64, torch.float64),
                  "f32": (torch.float32, torch.float32),
                  "f32_f64": (torch.float32, torch.float64),
                  "bf16_f64": (torch.bfloat16, torch.float64),
                  "bf16_f32": (torch.bfloat16, torch.float32)}
# positions, as a fraction of the unit domain: the same operations in the
# same order, so only a differing rounding could separate them
MARCH_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def sphere_mef(n_theta: int, n_phi: int, r: float, c: float = 0.5):
    """Closed latitude-longitude triangulation of a sphere: 2 poles and
    n_theta-1 rings of n_phi nodes; 2 n_phi (n_theta-1) triangles."""
    th = np.pi * np.arange(1, n_theta) / n_theta
    ph = 2 * np.pi * np.arange(n_phi) / n_phi
    T, P = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                     np.cos(T)], -1).reshape(-1, 3)
    pos = c + r * np.concatenate([[[0.0, 0.0, 1.0]], ring, [[0.0, 0.0, -1.0]]])
    idx = 1 + np.arange((n_theta - 1) * n_phi).reshape(n_theta - 1, n_phi)
    nxt = np.roll(idx, -1, axis=1)
    south = len(pos) - 1
    tris = [np.stack([np.zeros(n_phi, int), idx[0], nxt[0]], 1)]
    for j in range(n_theta - 2):
        tris += [np.stack([idx[j], nxt[j], idx[j + 1]], 1).reshape(-1, 3),
                 np.stack([nxt[j], nxt[j + 1], idx[j + 1]], 1).reshape(-1, 3)]
    tris.append(np.stack([idx[-1], np.full(n_phi, south), nxt[-1]], 1))
    return pos, np.concatenate(tris).astype(np.int32)


def radial_gradient(shape, plo, dx, dev) -> torch.Tensor:
    """[SX, SY, SZ, 3] gradient of the Gaussian temp of
    testing.default_fields at the cell centres of a grid."""
    xs = [torch.arange(shape[d], dtype=torch.float64, device=dev) * dx[d]
          + plo[d] + 0.5 * dx[d] - 0.5 for d in range(3)]
    X, Y, Z = torch.meshgrid(*xs, indexing="ij")
    g = -1500.0 * 2.0 / 0.15 ** 2 * torch.exp(-(X * X + Y * Y + Z * Z)
                                             / 0.15 ** 2)
    return torch.stack([g * X, g * Y, g * Z], -1).contiguous()


def phase_march_kernel(dev) -> dict:
    """Kernel vs march_torch at three shapes: boundary-exit lines in a
    small outward-drift field, the repo case's finest level (grown 150^3,
    gradient 148^3, 4k lines) and the production finest level (gradient
    276^3, 130k sphere seeds in both directions, 25 steps)."""
    cases, worst, times = [], 0.0, {}
    gen = torch.Generator().manual_seed(0)
    xs = [torch.linspace(0, 1, s, dtype=torch.float64, device=dev)
          for s in (16, 18, 88)]
    X, Y, Z = torch.meshgrid(*xs, indexing="ij")

    def centred(n, dx):          # a cubic grid centred on the domain
        plo = (0.5 - 0.5 * n * dx,) * 3
        return radial_gradient((n,) * 3, plo, (dx,) * 3, dev), plo, (dx,) * 3

    shapes = {   # field, plo, dx, h, seeds, steps
        "boundary": (torch.stack([X - 0.45, Y - 0.55, Z - 0.5], -1)
                     .contiguous(), (0.0,) * 3, (1 / 15, 1 / 17, 1 / 87),
                     0.5 / 87, torch.rand((4096, 3), generator=gen,
                                          dtype=torch.float64), 60),
        "repo_finest": (*centred(148, 1 / 256), 0.5 / 256,
                        0.5 + 0.3 * (torch.rand((2048, 3), generator=gen,
                                                dtype=torch.float64) - 0.5),
                        25),
        "production": (*centred(276, 1 / 512), 0.5 / 512,
                       torch.from_numpy(sphere_mef(256, 510, 0.131)[0]), 25),
    }
    for name, (field64, plo, dx, h, seeds, n) in shapes.items():
        seeds = torch.cat([seeds, seeds]).to(dev)
        ns = seeds.shape[0] // 2
        dirs = torch.cat([torch.ones(ns), -torch.ones(ns)]).to(dev,
                                                              torch.float64)
        for var, (fdt, sdt) in MARCH_VARIANTS.items():
            field, s, d = field64.to(fdt), seeds.to(sdt), dirs.to(sdt)
            k, ka = mk.march(field, plo, dx, h, s, n, d)
            p, pa = mk.march_torch(field, plo, dx, h, s, n, d)
            torch.cuda.synchronize()
            err = float((k - p).abs().max())
            if not torch.equal(ka, pa) or not err <= MARCH_TOL[sdt]:
                raise AssertionError(f"march kernel differs from plain at "
                                     f"{name} {var}: err {err}, alive "
                                     f"equal {torch.equal(ka, pa)}")
            if not torch.isfinite(k).all():
                raise AssertionError(f"non-finite march at {name} {var}")
            worst = max(worst, err)
            case = {"shape": name, "variant": var, "lines": 2 * ns,
                    "steps": n, "max_abs_err": err,
                    "bitwise": bool(torch.equal(k, p)),
                    "alive": int(ka.sum())}
            if name == "production" and var != "bf16_f32":
                case["ms"] = cuda_ms(
                    lambda: mk.march(field, plo, dx, h, s, n, d), n=10)
                case["plain_ms"] = cuda_ms(
                    lambda: mk.march_torch(field, plo, dx, h, s, n, d),
                    n=5, warmup=1)
                times[var] = (case["ms"], case["plain_ms"])
            cases.append(case)
    emit({"phase": "march_kernel_vs_plain", "tolerance": "identical alive "
          "flags; positions within 1e-12 (float64 positions) or 1e-5 "
          "(float32 positions) of the unit domain", "cases": cases})
    ms, plain_ms = times["f64"]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


# -- phase 4 --------------------------------------------------------------------
def run_tool(tool: str, args, n_levels: int) -> float:
    """One CLI run; checks that every gradient went through the kernel."""
    before = gk.LAUNCHES
    t0 = time.perf_counter()
    rc = cli.main([tool, *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{tool} exited {rc}")
    launched = gk.LAUNCHES - before
    if launched != LAUNCHES_PER_LEVEL[tool] * n_levels:
        raise AssertionError(f"{tool}: {launched} kernel launches, expected "
                             f"{LAUNCHES_PER_LEVEL[tool] * n_levels}")
    return wall


def analytic_grad_check(out_path: str) -> dict:
    """||gradtemp|| on the finest level's valid cells vs the analytic
    gradient of the Gaussian temp of testing.default_fields.

    Tolerance, from the scheme's truncation error at the level's dx h
    (T = 300 + A exp(-r^2/w^2), M3 = max |d^3 T / dx^3| = A max_u
    |(12u - 8u^3) e^{-u^2}| / w^3):
      centered difference      M3 h^2 / 6
      quadratic c-f ghosts     3 dirs x (M3/6)(0.234 (2h)^3) / (2h)
                               (Lagrange remainder at offset 1/4 of the
                               coarse spacing 2h, divided by the stencil 2h)
      float32 rounding         eps32 max|T| / h
    per component; sqrt(3) times their sum bounds the magnitude."""
    ds = DenseAmrState.from_plotfile(out_path, "cpu", dtype=torch.float64)
    lev = ds.meta.n_levels - 1
    geom = ds.meta.geoms[lev]
    h = geom.dx[0]
    A, w, c = 1500.0, 0.15, 0.5
    u = np.linspace(0.0, 4.0, 400001)
    M3 = A * np.abs((12 * u - 8 * u ** 3) * np.exp(-u ** 2)).max() / w ** 3
    tol = np.sqrt(3.0) * (M3 * h ** 2 / 6
                          + 3 * (M3 / 6) * 0.234 * (2 * h) ** 3 / (2 * h)
                          + np.finfo(np.float32).eps * (300.0 + A) / h)
    x, y, z = np.meshgrid(*cell_centers(ds.lmeta[lev].bbox, geom),
                          indexing="ij")
    r2 = (x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2
    exact = A * np.exp(-r2 / w ** 2) * 2.0 * np.sqrt(r2) / w ** 2
    got = ds.data[lev][ds.comp("||gradtemp||")].numpy()
    valid = ds.valid_mask_np(lev)
    err = float(np.abs(got - exact)[valid].max())
    if not err <= tol:
        raise AssertionError(f"||gradtemp|| off the analytic gradient by "
                             f"{err} > {tol}")
    return {"max_err": err, "tol": float(tol),
            "max_exact": float(exact[valid].max())}


def check_outputs(grad_out: str, curv_out: str) -> dict:
    for path, names in ((grad_out, None), (curv_out, [
            "MeanCurvature_temp", "FlameNormalX_temp", "FlameNormalY_temp",
            "FlameNormalZ_temp"])):
        ds = DenseAmrState.from_plotfile(path, "cpu", names=names,
                                         dtype=torch.float64)
        for lev in range(ds.meta.n_levels):
            v = ds.data[lev][:, torch.from_numpy(ds.valid_mask_np(lev))]
            if not torch.isfinite(v).all():
                raise AssertionError(f"non-finite output on valid cells: "
                                     f"{path} level {lev}")
    return analytic_grad_check(grad_out)


def phase_main(tmp: str) -> int:
    plt = os.path.join(tmp, "plt_repo")
    fields = {"temp": default_fields()["temp"]}
    bas = write_synthetic_plotfile(plt, fields=fields, **REPO_CASE)[1]
    L = REPO_CASE["n_levels"]
    grad_args = [f"infile={plt}", "gradVar=temp"]
    curv_args = [f"infile={plt}", "progressName=temp"]
    # the main path's run: every count set to 0 just before, read just after
    gk.LAUNCHES = mk.LAUNCHES = 0
    cold = {"grad": run_tool("grad", grad_args, L),
            "curvature": run_tool("curvature", curv_args, L)}
    launches = gk.LAUNCHES
    if launches != (1 + 7) * L or mk.LAUNCHES:
        raise AssertionError(f"main path launched {launches} grad_mag and "
                             f"{mk.LAUNCHES} stream_march kernels")
    warm = {t: [run_tool(t, a, L) for _ in range(3)]
            for t, a in (("grad", grad_args), ("curvature", curv_args))}
    check = check_outputs(plt + "_gt", plt + "_K")
    emit({"phase": "main_repo_case", "case": REPO_CASE,
          "finest_patch": bas[-1].minimal_box().shape, "launches": launches,
          "cold_s": cold, "warm_s": warm,
          "warm_median_s": {t: statistics.median(v) for t, v in warm.items()},
          "analytic_grad": check})
    return launches


# -- phase 4b -------------------------------------------------------------------
STREAM_R = 0.131           # temp = 1000 K on testing.default_fields' Gaussian
STREAM_KEYS = ["nRKsteps=51", "hRK=0.5"]                       # bench.py:535


def write_seed_mef(path: str, n_theta: int, n_phi: int, extra=()) -> int:
    """A sphere MEF at STREAM_R, plus ``extra`` nodes in no element;
    returns the sphere's node count (its nodes come first)."""
    pos, tris = sphere_mef(n_theta, n_phi, STREAM_R)
    n = len(pos)
    if len(extra):
        pos = np.concatenate([pos, np.asarray(extra, dtype=np.float64)])
    write_mef(path, MEF("0", ["X", "Y", "Z"], pos, tris))
    return n


def run_tool_counted(tool: str, args, expect) -> float:
    """One CLI run; expect = (grad_mag launches, stream_march launches)."""
    g0, m0 = gk.LAUNCHES, mk.LAUNCHES
    t0 = time.perf_counter()
    rc = cli.main([tool, *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{tool} exited {rc}")
    got = (gk.LAUNCHES - g0, mk.LAUNCHES - m0)
    if got != tuple(expect):
        raise AssertionError(f"{tool}: (grad_mag, stream_march) launches "
                             f"{got}, expected {tuple(expect)}")
    return wall


def check_stream_data(path: str, n_lines: int, names) -> np.ndarray:
    sd = read_stream_data(path)
    if sd.names != list(names) or sd.n_lines != n_lines:
        raise AssertionError(f"{path}: {sd.names}, {sd.n_lines} lines")
    if not np.isfinite(sd.lines).all():
        raise AssertionError(f"{path}: non-finite line data")
    return sd.lines


def radial_line_check(lines: np.ndarray, h_phys: float, h: float,
                      fine_lo: float, fine_hi: float) -> dict:
    """Gradient-mode lines of the radial Gaussian temp stay on the ray
    through their seed, and consecutive stations are h_phys apart.

    The lines must stay on the finest level's valid cells (spacing h), so
    the traced vector is the centred gradient of exact samples,
    interpolated trilinearly.  With M3 the largest third partial
    derivative of temp over the lines' shell (maximised over 10^6 sampled
    points of the analytic expression), each component of the sampled
    vector is off the true gradient by at most h^2/6 M3 (centred
    difference) + 3 h^2/8 M3 (trilinear interpolation), the vector by
    e = sqrt(3) times that.  Its angle to the radial direction is then at
    most theta = e / (Gmin - e), Gmin the smallest |grad temp| on the
    shell; 1.1 theta covers the RK4 stages' points being up to h_phys off
    the station's ray.  A line's angular distance from its seed's ray
    grows by at most 1.1 theta / r_in per unit length, so at arclength s
    the line is at most (r_out / r_in) 1.1 theta s off the ray; a step's
    four unit vectors lie within 3 theta of each other, so each step is
    h_phys within 4.5 theta^2 h_phys."""
    A, w, c = 1500.0, 0.15, 0.5
    n_half = (lines.shape[1] - 1) // 2
    pos = lines[..., :3] - c
    if pos.min() + c < fine_lo + 2 * h or pos.max() + c > fine_hi - 2 * h:
        raise AssertionError("radial check lines leave the finest level")
    seed = pos[:, n_half]
    r_seed = np.linalg.norm(seed, axis=1)
    travel = n_half * h_phys
    r_in, r_out = r_seed.min() - travel, r_seed.max() + travel
    rng = np.random.default_rng(0)
    d = rng.normal(size=(10 ** 6, 3))
    u = (d / np.linalg.norm(d, axis=1, keepdims=True)
         * rng.uniform(r_in - 2 * h, r_out + 2 * h, (10 ** 6, 1))) / w
    f = A * np.exp(-(u * u).sum(1)) / w ** 3
    M3 = 0.0
    for i in range(3):
        for j in range(i, 3):
            for k in range(j, 3):
                t = -8 * u[:, i] * u[:, j] * u[:, k]
                t = t + 4 * ((i == j) * u[:, k] + (i == k) * u[:, j]
                             + (j == k) * u[:, i])
                M3 = max(M3, float(np.abs(f * t).max()))
    e = np.sqrt(3.0) * (h * h / 6 + 3 * h * h / 8) * M3
    r = np.linspace(r_in, r_out, 10001)
    g_min = float((A * 2 * r / w ** 2 * np.exp(-r * r / w ** 2)).min())
    theta = 1.1 * e / (g_min - e)
    unit = seed / r_seed[:, None]
    along = (pos * unit[:, None]).sum(-1, keepdims=True)
    lateral = np.linalg.norm(pos - along * unit[:, None], axis=-1)
    s = np.abs(np.arange(lines.shape[1]) - n_half) * h_phys
    lat_bound = (r_out / r_in) * theta * s[None] + 1e-12
    steps = np.linalg.norm(np.diff(pos, axis=1), axis=-1)
    step_bound = 4.5 * theta ** 2 * h_phys + 1e-12
    temp = lines[..., 3]
    if not (lateral <= lat_bound).all():
        raise AssertionError(f"lines leave their seed's ray: "
                             f"{float(lateral.max())} > bound")
    if not (np.abs(steps - h_phys) <= step_bound).all():
        raise AssertionError(f"station spacing off h_phys by "
                             f"{float(np.abs(steps - h_phys).max())} > "
                             f"{step_bound}")
    if not ((temp[:, -1] > temp[:, n_half]) & (temp[:, n_half]
                                                > temp[:, 0])).all():
        raise AssertionError("+ direction does not climb temp")
    return {"lines": len(lines), "theta_bound": theta,
            "max_lateral": float(lateral.max()),
            "lateral_bound_at_ends": float(lat_bound.max()),
            "max_step_dev": float(np.abs(steps - h_phys).max()),
            "step_bound": step_bound}


def phase_stream(tmp: str) -> dict:
    plt = os.path.join(tmp, "plt_stream")
    geoms, bas = write_synthetic_plotfile(plt, **REPO_CASE)[:2]
    L = REPO_CASE["n_levels"]
    mef = os.path.join(tmp, "seeds_repo.mef")
    # the sphere lies on the finest level; the extra seeds on levels 0, 1
    extra = [(0.1, 0.5, 0.5), (0.5, 0.9, 0.5), (0.258, 0.5, 0.5),
             (0.5, 0.5, 0.745)]
    n_sphere = write_seed_mef(mef, 32, 64, extra)
    n_seeds = n_sphere + len(extra)
    sd_grad, sd_vel, sd_samp = (os.path.join(tmp, n) for n in
                                ("sd_grad", "sd_vel", "sd_samp"))
    common = [f"plotfile={plt}", "progressName=temp", f"isoFile={mef}",
              *STREAM_KEYS, "aux_comps=density"]
    runs = {
        "stream_gradient": ("stream", [*common, f"streamFile={sd_grad}",
                                       f"outFile={sd_grad}.dat"], (L, L)),
        "stream_velocity": ("stream", [*common, "traceAlongV=1",
                                       f"streamFile={sd_vel}"], (0, L)),
        "sampleStreamlines": ("sampleStreamlines", [
            f"plotfile={plt}", f"pathFile={sd_grad}", "comps=density temp",
            f"streamSampleFile={sd_samp}"], (0, 0)),
    }
    # the stream path's run: every count set to 0 just before, read just
    # after; one grad_mag and one march launch per seeded level
    gk.LAUNCHES = mk.LAUNCHES = 0
    cold = {k: run_tool_counted(*v) for k, v in runs.items()}
    launches = {"grad_mag": gk.LAUNCHES, "stream_march": mk.LAUNCHES}
    if launches != {"grad_mag": L, "stream_march": 2 * L}:
        raise AssertionError(f"stream path launches {launches}")
    warm = {k: [run_tool_counted(*v) for _ in range(2)]
            for k, v in runs.items()}
    names = ["X", "Y", "Z", "temp", "density"]
    lines = check_stream_data(sd_grad, n_seeds, names)
    check_stream_data(sd_vel, n_seeds, names)
    samp = check_stream_data(sd_samp, n_seeds, ["X", "Y", "Z",
                                                "distance_from_seed",
                                                "density", "temp"])
    if not (samp[..., 4].min() >= 0.2 and samp[..., 4].max() <= 1.0):
        raise AssertionError("sampled density outside [0.2, 1]")
    dx_f = geoms[-1].dx[0]
    fine = bas[-1].minimal_box()
    radial = radial_line_check(
        lines[:n_sphere], 0.5 * dx_f, dx_f, fine.lo[0] * dx_f,
        (fine.hi[0] + 1) * dx_f)
    emit({"phase": "stream_repo_case", "case": REPO_CASE, "seeds": n_seeds,
          "keys": STREAM_KEYS, "launches": launches, "cold_s": cold,
          "warm_s": warm,
          "warm_median_s": {k: statistics.median(v) for k, v in warm.items()},
          "radial_lines": radial})
    return {"launches": launches, "plt": plt, "mef": mef}


# -- phase 5 --------------------------------------------------------------------
def layer_split(plt: str, dev) -> dict:
    """Read, device compute and write of each tool, timed apart (host
    clock; the compute ends in a synchronize)."""
    out = {}
    for tool in ("grad", "curvature"):
        t0 = time.perf_counter()
        ds = DenseAmrState.from_plotfile(plt, dev, names=["temp"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if tool == "grad":
            res = compute_grad_dense(ds, "temp", interp="quadratic")
        else:
            res = compute_curvature_dense(ds, "temp", interp="quadratic")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res.to_plotfile(os.path.join(os.path.dirname(plt), f"split_{tool}"))
        t3 = time.perf_counter()
        out[tool] = {"read_s": t1 - t0, "compute_s": t2 - t1,
                     "write_s": t3 - t2}
    return out


def phase_prod(tmp: str, dev) -> None:
    plt = os.path.join(tmp, "plt_prod")
    bas = write_synthetic_plotfile(
        plt, fields={"temp": default_fields()["temp"]}, **PROD_CASE)[1]
    L = PROD_CASE["n_levels"]
    res = {}
    for tool, args in (("grad", [f"infile={plt}", "gradVar=temp"]),
                       ("curvature", [f"infile={plt}", "progressName=temp"])):
        cold = run_tool(tool, args, L)
        torch.cuda.reset_peak_memory_stats()
        warm = run_tool(tool, args, L)
        res[tool] = {"cold_s": cold, "warm_s": warm,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit({"phase": "main_production_size", "case": PROD_CASE,
          "finest_patch": bas[-1].minimal_box().shape,
          "cells": sum(ba.total_cells() for ba in bas), "tools": res,
          "layers": layer_split(plt, dev)})


# -- phase 5b -------------------------------------------------------------------
def profiled_trace(fn) -> dict:
    """fn() once under torch.profiler: its host wall time and the device
    time of its device-to-host copies and of its march kernel launches."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()

    def device_ms(part: str) -> float:
        return sum(e.device_time_total for e in ev if part in e.key) / 1e3

    return {"wall_s": wall, "d2h_ms": device_ms("Memcpy DtoH"),
            "march_kernel_ms": device_ms("march_kernel")}


def stream_layer_split(plt: str, mef: str, dev, tmp: str) -> dict:
    """Read, trace (fill + gradient + march + sampling + the copy of the
    lines to the host) and write of the stream tool, timed apart; then the
    trace under the profiler, exact in float64 and with a bfloat16 field
    and its default lossy line packing."""
    t0 = time.perf_counter()
    meta, names, fabs = load_plotfile_fabs(plt, names=["temp", "density"])
    ds = DenseAmrState.from_level_fabs(meta, names, fabs, dev, torch.float64)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    seeds = read_mef(mef)
    lines = trace_streamlines(ds, seeds.positions(), 51, 0.5,
                              trace_field="temp",
                              sample_names=["temp", "density"])
    t2 = time.perf_counter()
    names = ["X", "Y", "Z", "temp", "density"]
    inside = compute_inside_nodes(meta, lines[:, lines.shape[1] // 2, :3])
    write_stream_data(os.path.join(tmp, "split_sd"), StreamData(
        names, seeds.elements, inside, lines), meta=meta)
    t3 = time.perf_counter()
    write_tecplot_lines(os.path.join(tmp, "split_lines.dat"), names, lines)
    t4 = time.perf_counter()
    kw = dict(trace_field="temp", sample_names=["temp", "density"])
    prof = {
        "float64": profiled_trace(lambda: trace_streamlines(
            ds, seeds.positions(), 51, 0.5, **kw)),
        "bfloat16_packed": profiled_trace(lambda: trace_streamlines(
            ds, seeds.positions(), 51, 0.5, march_dtype="bfloat16", **kw))}
    return {"read_s": t1 - t0, "trace_s": t2 - t1,
            "stream_data_write_s": t3 - t2, "tecplot_write_s": t4 - t3,
            "profiled_trace": prof}


def phase_stream_prod(tmp: str, dev) -> None:
    plt = os.path.join(tmp, "plt_prod_stream")
    f = default_fields()
    bas = write_synthetic_plotfile(
        plt, fields={"temp": f["temp"], "density": f["density"]},
        **PROD_CASE)[1]
    mef = os.path.join(tmp, "seeds_prod.mef")
    n_seeds = write_seed_mef(mef, 256, 510)
    sd, sd2 = os.path.join(tmp, "sd_prod"), os.path.join(tmp, "sd_prod_samp")
    # every sphere seed lies on the finest level: one launch of each kernel
    runs = (("stream", [f"plotfile={plt}", "progressName=temp",
                        f"isoFile={mef}", *STREAM_KEYS, "aux_comps=density",
                        f"streamFile={sd}", f"outFile={sd}.dat"], (1, 1)),
            ("sampleStreamlines", [f"plotfile={plt}", f"pathFile={sd}",
                                   "comps=density",
                                   f"streamSampleFile={sd2}"], (0, 0)))
    res = {}
    for tool, args, expect in runs:
        cold = run_tool_counted(tool, args, expect)
        torch.cuda.reset_peak_memory_stats()
        warm = run_tool_counted(tool, args, expect)
        res[tool] = {"cold_s": cold, "warm_s": warm,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()}
    check_stream_data(sd, n_seeds, ["X", "Y", "Z", "temp", "density"])
    check_stream_data(sd2, n_seeds, ["X", "Y", "Z", "distance_from_seed",
                                     "density"])
    emit({"phase": "stream_production_size", "case": PROD_CASE,
          "finest_patch": bas[-1].minimal_box().shape,
          "cells": sum(ba.total_cells() for ba in bas), "seeds": n_seeds,
          "lines_marched": 2 * n_seeds, "keys": STREAM_KEYS, "tools": res,
          "layers": stream_layer_split(plt, mef, dev, tmp)})


# -- phase 6 --------------------------------------------------------------------
def compare_devices(card, cpu, what: str) -> dict:
    worst = 0.0
    for lev, (a, b) in enumerate(zip(card.data, cpu.data)):
        a = a.cpu().numpy()
        b = b.numpy()
        for c, name in enumerate(cpu.names):
            fin = np.isfinite(b[c])
            if not np.array_equal(np.isfinite(a[c]), fin) or not \
                    np.array_equal(np.isnan(a[c]), np.isnan(b[c])):
                raise AssertionError(f"{what} {name} level {lev}: non-finite "
                                     "cells differ between card and CPU")
            if not fin.any():
                continue
            scale = float(np.abs(b[c][fin]).max())
            np.testing.assert_allclose(a[c][fin], b[c][fin], rtol=1e-6,
                                       atol=1e-6 * scale,
                                       err_msg=f"{what} {name} level {lev}")
            worst = max(worst, float(np.abs(a[c][fin] - b[c][fin]).max())
                        / max(scale, np.finfo(np.float64).tiny))
    return {"max_err_over_scale": worst}


def phase_cpu(tmp: str, dev) -> None:
    plt = os.path.join(tmp, "plt_repo")
    card = DenseAmrState.from_plotfile(plt, dev)
    cpu = DenseAmrState.from_plotfile(plt, "cpu")
    out = {}
    for tool, fn in (("grad", lambda s: compute_grad_dense(
            s, "temp", interp="quadratic")),
                     ("curvature", lambda s: compute_curvature_dense(
            s, "temp", interp="quadratic"))):
        out[tool] = compare_devices(fn(card), fn(cpu), tool)
    emit({"phase": "card_vs_cpu", "tolerance": "same non-finite cells; "
          "rtol 1e-6, atol 1e-6 max|cpu|", "tools": out})


def phase_stream_cpu(stream: dict, dev) -> None:
    """trace_streamlines of the repo case on the card (kernels) vs on the
    CPU (plain versions), float64: the same operations, apart from the
    CPU's sqrt, which is not always correctly rounded."""
    names = ["temp", "density", "x_velocity", "y_velocity", "z_velocity"]
    card = DenseAmrState.from_plotfile(stream["plt"], dev, names=names,
                                       dtype=torch.float64)
    cpu = DenseAmrState.from_plotfile(stream["plt"], "cpu", names=names,
                                      dtype=torch.float64)
    seeds = read_mef(stream["mef"]).positions()
    out = {}
    for mode, field in (("gradient", "temp"), ("velocity", None)):
        kw = dict(n_rk_steps=51, h_rk=0.5, trace_field=field,
                  sample_names=("density",))
        a = trace_streamlines(card, seeds, **kw)
        b = trace_streamlines(cpu, seeds, **kw)
        pos = float(np.abs(a[..., :3] - b[..., :3]).max())
        val = float(np.abs(a[..., 3] - b[..., 3]).max()
                    / np.abs(b[..., 3]).max())
        if not (pos <= 1e-12 and val <= 1e-12):
            raise AssertionError(f"stream {mode}: card vs CPU positions "
                                 f"{pos}, density {val}")
        out[mode] = {"lines": len(seeds), "max_pos_err": pos,
                     "max_density_err_over_scale": val}
    # every marchEngine name marches a card state through the kernel;
    # "torch" (the plain version) is refused there
    kw = dict(n_rk_steps=5, h_rk=0.5, trace_field="temp")
    for name in ("auto", "cuda", "pallas", "xla"):
        n0 = mk.LAUNCHES
        trace_streamlines(card, seeds, march_engine=name, **kw)
        if mk.LAUNCHES == n0:
            raise AssertionError(f"march_engine={name}: no kernel launch")
    try:
        trace_streamlines(card, seeds, march_engine="torch", **kw)
    except ValueError:
        pass
    else:
        raise AssertionError("march_engine=torch ran on a CUDA state")
    emit({"phase": "stream_card_vs_cpu", "tolerance": "positions 1e-12 of "
          "the unit domain, density 1e-12 of its largest value",
          "modes": out})


# -- phase 7 --------------------------------------------------------------------
ISO_VAL = 1000.0
# temp = 1000 K on testing.default_fields' Gaussian 300 + 1500 exp(-r^2/w^2)
ISO_R = 0.15 * np.sqrt(np.log(1500.0 / 700.0))
# the JAX package's sphere tests hold the area to 5% at r = 4 cells; the repo
# case's sphere has r = 33.5 finest cells
AREA_TOL = 0.01


def sphere_checks(mef: MEF, h: float) -> dict:
    """The temp = 1000 K surface of the repo case is a closed sphere on the
    finest level: every edge borders exactly two triangles, V - E + F = 2,
    the area is within AREA_TOL of 4 pi r^2 and every node within one
    finest cell h of the radius (degenerate triangles left out)."""
    e = mef.elements
    good = (e[:, 0] != e[:, 1]) & (e[:, 1] != e[:, 2]) & (e[:, 0] != e[:, 2])
    edges, counts = np.unique(np.sort(np.concatenate(
        [e[good][:, [0, 1]], e[good][:, [1, 2]], e[good][:, [2, 0]]]),
        axis=1), axis=0, return_counts=True)
    euler = len(np.unique(e[good])) - len(edges) + int(good.sum())
    exact = 4 * np.pi * ISO_R ** 2
    area_err = abs(mef.total_area() - exact) / exact
    radius_err = float(np.abs(np.linalg.norm(mef.positions() - 0.5, axis=1)
                              - ISO_R).max())
    if not (counts == 2).all():
        raise AssertionError(f"{int((counts != 2).sum())} edges do not "
                             "border exactly two triangles")
    if euler != 2:
        raise AssertionError(f"Euler characteristic {euler}, not 2")
    if not area_err <= AREA_TOL:
        raise AssertionError(f"area off 4 pi r^2 by {area_err}")
    if not radius_err <= h:
        raise AssertionError(f"a node is {radius_err} off the radius")
    return {"nodes": mef.n_nodes, "triangles": mef.n_elts,
            "degenerate": int((~good).sum()), "euler": euler,
            "area_rel_err": area_err, "area_tol": AREA_TOL,
            "max_radius_err_over_h": radius_err / h}


class HostTensors(TorchDispatchMode):
    """Records every op whose output holds at least ``large`` elements on
    another device type than ``device``'s."""

    def __init__(self, large: int, device: torch.device):
        super().__init__()
        self.large, self.device = large, device
        self.n_large, self.off_card = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel() >= self.large:
                self.n_large += 1
                if t.device.type != self.device.type:
                    self.off_card.append(str(func))
        return out


def phase_iso(tmp: str, dev) -> dict:
    plt = os.path.join(tmp, "plt_repo")
    base = os.path.join(tmp, "iso_repo")
    args = [f"infile={plt}", f"isoVal={ISO_VAL:g}", f"outfile_base={base}"]
    # the isosurface path's run: every count set to 0 just before, read
    # just after
    gk.LAUNCHES = mk.LAUNCHES = 0
    cold = run_tool_counted("isosurface", args, (0, 0))
    launches = {"grad_mag": gk.LAUNCHES, "stream_march": mk.LAUNCHES}
    warm = [run_tool_counted("isosurface", args, (0, 0)) for _ in range(3)]
    meta = load_plotfile_fabs(plt, names=["temp"])[0]
    mef = read_mef(base + ".mef")
    check = sphere_checks(mef, meta.geoms[-1].dx[0])
    # every tensor the size of a level volume, made by a warm extraction
    # (the per-state inputs exist), lies on the card
    ds = DenseAmrState.from_plotfile(plt, dev, names=["temp"],
                                     dtype=torch.float64)
    first = extract_isosurface(ds, "temp", ISO_VAL)
    large = min(int(np.prod(lm.bbox.shape)) for lm in ds.lmeta)
    with HostTensors(large, ds.device) as seen:
        again = extract_isosurface(ds, "temp", ISO_VAL)
    if seen.off_card or not seen.n_large:
        raise AssertionError(f"large tensors off the card: {seen.off_card}"
                             f" ({seen.n_large} large)")
    if not (np.array_equal(first.elements, again.elements)
            and np.array_equal(first.nodes, again.nodes)
            and np.array_equal(first.elements, mef.elements)):
        raise AssertionError("repeated extractions differ")
    emit({"phase": "iso_repo_case", "case": REPO_CASE, "iso_val": ISO_VAL,
          "launches": launches, "cold_s": cold, "warm_s": warm,
          "warm_median_s": statistics.median(warm), "sphere": check,
          "large_tensors_on_card": seen.n_large,
          "large_means_elements": large})
    return {"plt": plt, "mef": mef}


def phase_iso_cpu(iso: dict, dev) -> None:
    card = extract_isosurface(DenseAmrState.from_plotfile(
        iso["plt"], dev, names=["temp"], dtype=torch.float64), "temp",
        ISO_VAL)
    cpu = extract_isosurface(DenseAmrState.from_plotfile(
        iso["plt"], "cpu", names=["temp"], dtype=torch.float64), "temp",
        ISO_VAL)
    if not np.array_equal(card.elements, cpu.elements):
        raise AssertionError("isosurface elements differ between card and CPU")
    err = [float(np.abs(card.nodes[:, c] - cpu.nodes[:, c]).max()
                 / np.abs(cpu.nodes[:, c]).max())
           for c in range(cpu.nodes.shape[1])]
    if not max(err) <= 1e-12:
        raise AssertionError(f"isosurface nodes differ between card and CPU "
                             f"by {err} of scale")
    emit({"phase": "iso_card_vs_cpu", "tolerance": "identical elements; "
          "nodes within 1e-12 of each column's largest value",
          "nodes": cpu.n_nodes, "triangles": cpu.n_elts,
          "max_err_over_scale": err})


def host_waits(fn) -> int:
    """How many times fn() makes the host wait on the card (the syncs that
    torch.cuda's sync debug mode reports)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def stage_profile(fn) -> dict:
    """fn() once under torch.profiler: wall time, and the device time of
    every op attributed to the innermost ``isosurface.<stage>`` range
    around it (the engine's stages; "other" outside them)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stage_us, launches = defaultdict(float), defaultdict(int)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        own = ev.self_device_time_total
        if not own:
            continue
        p = ev
        while p is not None and not p.name.startswith("isosurface."):
            p = p.cpu_parent
        stage = p.name[len("isosurface."):] if p is not None else "other"
        stage_us[stage] += own
        launches[stage] += len(ev.kernels)
    device_ms = sum(stage_us.values()) / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_busy": device_ms / (wall * 1e3),
            "stage_device_ms": {k: v / 1e3 for k, v in
                                sorted(stage_us.items(), key=lambda x: -x[1])},
            "stage_kernels": dict(launches)}


def phase_iso_prod(tmp: str, dev) -> None:
    plt = os.path.join(tmp, "plt_prod")
    base = os.path.join(tmp, "iso_prod")
    args = [f"infile={plt}", f"isoVal={ISO_VAL:g}", f"outfile_base={base}"]
    cold = run_tool_counted("isosurface", args, (0, 0))
    torch.cuda.reset_peak_memory_stats()
    warm = run_tool_counted("isosurface", args, (0, 0))
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    meta, names, fabs = load_plotfile_fabs(plt, names=["temp"])
    ds = DenseAmrState.from_level_fabs(meta, names, fabs, dev, torch.float64)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mef = extract_isosurface(ds, "temp", ISO_VAL)
    t2 = time.perf_counter()
    write_mef(os.path.join(tmp, "split_iso.mef"), mef)
    t3 = time.perf_counter()
    waits = host_waits(lambda: extract_isosurface(ds, "temp", ISO_VAL))
    extract_ms = cuda_ms(lambda: extract_isosurface(ds, "temp", ISO_VAL),
                         n=5, warmup=1)
    sphere = sphere_checks(mef, meta.geoms[-1].dx[0])
    emit({"phase": "iso_production_size", "case": PROD_CASE,
          "cells": sum(ba.total_cells() for ba in meta.bas),
          "iso_val": ISO_VAL, "cold_s": cold, "warm_s": warm,
          "max_memory_allocated": peak,
          "layers": {"read_s": t1 - t0, "extract_s": t2 - t1,
                     "write_s": t3 - t2},
          "extract_warm_ms": extract_ms,
          "host_waits_per_extraction": waits, "sphere": sphere,
          "profile": stage_profile(
              lambda: extract_isosurface(ds, "temp", ISO_VAL))})


# -- phase 8 --------------------------------------------------------------------
def phase_main_path(tmp: str, dev) -> None:
    """grad -> curvature -> isosurface of one float32 state with the
    functions' own defaults, as the JAX bench's composite (bench.py:194):
    each stage's median CUDA-event time over warm runs, and their sum."""
    out = {}
    for name, case, n in (("repo", REPO_CASE, 20), ("production", PROD_CASE,
                                                     10)):
        plt = os.path.join(tmp, "plt_repo" if name == "repo" else "plt_prod")
        ds = DenseAmrState.from_plotfile(plt, dev, names=["temp"])
        stages = {
            "grad": lambda: compute_grad_dense(ds, "temp"),
            "curvature": lambda: compute_curvature_dense(ds, "temp"),
            "isosurface": lambda: extract_isosurface(ds, "temp", ISO_VAL)}
        # the main path's run: every count set to 0 just before, read just
        # after
        gk.LAUNCHES = mk.LAUNCHES = 0
        mef = [fn() for fn in stages.values()][-1]
        launches = {"grad_mag": gk.LAUNCHES, "stream_march": mk.LAUNCHES}
        L = case["n_levels"]
        if launches != {"grad_mag": (1 + 7) * L, "stream_march": 0}:
            raise AssertionError(f"main path launches {launches}")
        if not (mef.n_elts > 0 and np.isfinite(mef.nodes).all()):
            raise AssertionError("main path: empty or non-finite surface")
        ms = {k: cuda_ms(fn, n=n) for k, fn in stages.items()}
        out[name] = {"case": case, "dtype": "float32", "launches": launches,
                     "ms": ms, "sum_ms": sum(ms.values()),
                     "nodes": mef.n_nodes, "triangles": mef.n_elts}
    emit({"phase": "main_path", "timing": "median CUDA-event time per "
          "stage over warm runs", **out})


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    kern = phase_kernel(dev)
    march = phase_march_kernel(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        launches = phase_main(tmp)
        stream = phase_stream(tmp)
        phase_prod(tmp, dev)
        phase_stream_prod(tmp, dev)
        phase_cpu(tmp, dev)
        phase_stream_cpu(stream, dev)
        iso = phase_iso(tmp, dev)
        phase_iso_cpu(iso, dev)
        phase_iso_prod(tmp, dev)
        phase_main_path(tmp, dev)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "grad_mag", "route": "cuda",
        "source": "peleanalysis_tpu_torch/csrc/grad_mag.cu",
        "replaces": "peleanalysis_tpu/ops/pallas_kernels.py:36",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}, {
        "name": "stream_march", "route": "cuda",
        "source": "peleanalysis_tpu_torch/csrc/stream_march.cu",
        "replaces": "peleanalysis_tpu/stream/pallas_march.py:72",
        "launches": stream["launches"]["stream_march"],
        "max_abs_err": march["max_abs_err"], "ms": march["ms"],
        "plain_ms": march["plain_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
