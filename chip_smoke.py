"""Smoke run of the PyTorch port on one NVIDIA GPU: build the CUDA kernel,
check it against its plain PyTorch version, and drive the grad and
curvature tools through their CLI on synthetic 3-level hierarchies.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):
  1 device   - refuse to run without torch.cuda; print the card's name and
               power limit (nvidia-smi)
  2 build    - nvcc build of peleanalysis_tpu_torch/csrc/grad_mag.cu
  3 kernel   - grad_mag kernel vs grad_mag_torch on the card, float32 and
               float64, with and without the magnitude: gradients bitwise,
               magnitude within 1 ulp; median times over 20 runs
  4 main     - the repo's 3-level case (64^3 -> 120^3 finest patch) through
               `grad` and `curvature` (cli.main), cold then 3 warm runs;
               kernel launch counts, finiteness and the analytic gradient
  5 prod     - a 3-level case with a 248^3 finest patch (19.5 M cells), one
               warm run of each tool, peak device memory and a per-layer
               split (read / device compute / write)
  6 cpu      - compute_grad_dense and compute_curvature_dense of the repo
               case on the card vs on the CPU (plain versions)
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

import numpy as np
import torch

from peleanalysis_tpu_torch import cli
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.ops import grad_kernels as gk
from peleanalysis_tpu_torch.testing import (cell_centers, default_fields,
                                            write_synthetic_plotfile)
from peleanalysis_tpu_torch.tools.curvature import compute_curvature_dense
from peleanalysis_tpu_torch.tools.grad import compute_grad_dense

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
    path = gk.build(verbose=True)
    gk.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path, ROOT)})


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
    gk.LAUNCHES = 0
    cold = {"grad": run_tool("grad", grad_args, L),
            "curvature": run_tool("curvature", curv_args, L)}
    launches = gk.LAUNCHES
    if launches != (1 + 7) * L:
        raise AssertionError(f"main path launched {launches} kernels")
    warm = {t: [run_tool(t, a, L) for _ in range(3)]
            for t, a in (("grad", grad_args), ("curvature", curv_args))}
    check = check_outputs(plt + "_gt", plt + "_K")
    emit({"phase": "main_repo_case", "case": REPO_CASE,
          "finest_patch": bas[-1].minimal_box().shape, "launches": launches,
          "cold_s": cold, "warm_s": warm,
          "warm_median_s": {t: statistics.median(v) for t, v in warm.items()},
          "analytic_grad": check})
    return launches


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


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    kern = phase_kernel(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        launches = phase_main(tmp)
        phase_prod(tmp, dev)
        phase_cpu(tmp, dev)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "grad_mag", "route": "cuda",
        "source": "peleanalysis_tpu_torch/csrc/grad_mag.cu",
        "replaces": "peleanalysis_tpu/ops/pallas_kernels.py:36",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
