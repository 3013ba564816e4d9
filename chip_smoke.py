"""Smoke run of the PyTorch port on one NVIDIA GPU: build the CUDA kernels,
check each against its plain PyTorch version, drive the grad (also
fluxMatch=1), curvature (also do_smooth=1), stream, sampleStreamlines,
isosurface, conditionalMean and jpdf tools through their CLI on
synthetic 3-level hierarchies, time the main path (grad, curvature,
isosurface), drive partStream, integral, rmsVel, filterPlt,
flattenAMRFile, the turbulence tools, the plotfile tools, buildDistance,
the MEF tools, the streamline post-processing tools and the chemistry
tools at full size, and the production chain file-chained, as a pipeline
and through a server.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):
  1 device   - refuse to run without torch.cuda; print the card's name and
               power limit (nvidia-smi)
  2 build    - nvcc builds of peleanalysis_tpu_torch/csrc/grad_mag.cu,
               stream_march.cu and stats_hist.cu and the g++ build of the
               native host library (native/vismf_io.cpp, fmt.cpp), started
               together
  3 kernel   - grad_mag kernel vs grad_mag_torch on the card, float32 and
               float64, with and without the magnitude: gradients bitwise,
               magnitude within 1 ulp; median times over 20 runs
  3b march   - stream_march kernel vs march_torch on the card, bitwise:
               float64, float32 (float32 and float64 positions) and
               bfloat16 fields, boundary-exit lines up to the production
               line count; the order key kernel vs its plain version; at
               production, the time of march() (one call, and 10-launch
               batches), the field cells the stencils read, bytes, flops,
               bound, share of it and registers; the order key's time
  3c stats   - stats_hist kernel vs its plain versions on the card, float32
               and float64, at 1 M and at the production case's 19.4 M
               cells, a third of them on bin edges or one ulp from them:
               binned moments with and without min/max (shared-memory
               variant) and at 16384 bins (device memory), joint pdfs of 1
               and 3 pairs at 64 (shared; float64 3 pairs in device
               memory) and 256 (device) bins, at 1 M also per-cell
               weights and fields one
               cell off a 16-byte boundary; hits equal, sums within 1e-4
               (float32) / 1e-10 (float64) of the largest, min/max equal,
               binned sums also against a tree-summed reference, one
               counted launch a wrapper call; at 19.4 M cells, in five
               configurations (binned, with min/max, joint 1 pair, 3
               pairs, 256 bins), the time of each entry point per call,
               in a batch and on the device by kernel (torch.profiler),
               its plain version, its bytes bound, torch.bincount and a
               chunked one-hot torch.matmul
  4 main     - the repo's 3-level case (64^3 -> 120^3 finest patch) through
               `grad` and `curvature` (cli.main), cold then 3 warm runs;
               kernel launch counts, finiteness and the analytic gradient
  4b stream  - the repo case through `stream` (gradient mode and
               traceAlongV=1) and `sampleStreamlines`: launch counts,
               finiteness, and the analytic radial-line check
  5 prod     - a 3-level case with a 248^3 finest patch (19.5 M cells), one
               warm run of each tool, peak device memory and a per-layer
               split (read / device compute / write); the float64 write
               split into its steps on the host path (the plain version:
               device-to-host copy, transpose and cast, min/max, FAB bytes,
               headers) and on the device path (pack, one copy a level,
               tables, files), its device-to-host copies counted
               (torch.profiler), and the two plotfiles byte-equal
  5b stream  - the same case seeded from a 130k-node sphere MEF through
               `stream` and `sampleStreamlines`, with the same measurements,
               and the trace under torch.profiler (device-to-host copy and
               march kernel device times), float64 and bfloat16-packed;
               the Tecplot text of the production lines from the native
               formatter byte-equal to the parent's Python formatting,
               both timed
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
  9 smooth   - `curvature do_smooth=1` (composite and per level) and
               `grad fluxMatch=1` through cli.main at both sizes: CG
               iterations, cold/warm wall, peak memory, 7 grad_mag launches
               a level and none for fluxMatch; the float32 composite
               solve's wall, device time, kernels and host waits (with
               minus without smoothing); card vs CPU on the repo case
  10 stats   - `conditionalMean` (temp over [300, 1801) in 64 bins,
               density and a constant field averaged) and `jpdf` ((temp,
               progress) with the bench's bounds; all pairs of three) at
               both sizes: one binned launch a level, one joint launch a
               level a run, the constant's mean, the hits, each pdf's mass
               of 1, both kernels vs their plain versions level by level
               on the tools' state (the tolerances of 3c), read / compute /
               write, accumulate_stats_fused's CUDA-event time and its
               device time by kernel (torch.profiler); at production the
               five configurations of 3c on the tools' smooth levels
               (kernel_times); card vs CPU files on the repo case
  11 host io - at production size, every level of the grad, stream and
               stats plotfiles read by the native loader (load_fabs) and
               box by box (read_box): bitwise equal, both timed, with the
               loader's thread count; the card's float32 <-> float64
               conversions of quiet NaNs bitwise equal to the host's
  12 sparse  - the JAX bench's sec_sparse512 case (128^3, ratio 4, 16
               scattered 32^3 patches, temp crossing 1050 K in each) through
               all seven tools clustered and with force_dense=1: plotfiles
               equal, MEFs by canonical node and element sets, lines and
               samples within 1e-12, stats files within 1e-9 with hits
               equal; cold and warm walls and peak device memory of both
               paths; the clustered runs' kernel launches (counts set to 0
               just before each, read just after: the "launches_sparse" of
               the kernel summary); one device-to-host copy a part of the
               clustered grad (torch.profiler); the clustered grad,
               curvature, stream, conditionalMean and jpdf run once more
               with every kernel call followed by its plain version on the
               same inputs (HeldAgainstPlain, the tolerances of 3, 3b, 3c):
               cluster substates, the coarse pass, one histogram a part
  12b scale  - 256^3 + 64 scattered 64^3 patches on a 1024^3 finest index
               space (1.3 GB plotfile, 5 components): clustered grad,
               curvature and isosurface, walls, peak device memory, each
               run split into read, coarse pass and clusters, and the
               finest union bbox force_dense=1 would allocate; grad and
               curvature once more with every grad_mag call held against
               grad_mag_torch (64 x 64 x 832 clusters, the 256^3 coarse
               pass)
  13 tools8  - partStream (the 130k-node MEF, Nsteps=51, Tecplot, particle
               and StreamData files; oneSeedPerCell with seedStride=64),
               integral (1 as ppm, 2, 3, 3 with cVar), rmsVel (3 files),
               filterPlt box and gaussian at production size;
               flattenAMRFile of the repo case to 256^3; the four
               turbulence_post verbs and turbulenceSpectra on a periodic
               256^3 HIT run of two plotfiles; turbulenceSpectra at
               production's 512^3 finest level.  Launches counted (counts
               set to 0 just before the cold runs, read just after: the
               "launches_tools8" of the kernel summary), warm walls split
               into read / compute / write with peak device memory (device
               time by torch.profiler for partStream and the production
               spectrum), the HIT closed forms
               (kin_energy_adim 0.5, magvort with sin(kh)/kh, divu^2 <
               1e-12, <T'^2>, Parseval in shell 1), partStream's lines
               bitwise equal to `stream traceAlongV=1`, every verb card vs
               CPU at the repo case (HIT at 64^3), and partStream and
               turbulenceSlice once more under HeldAgainstPlain (grad_mag
               at grown 258^3, the march at 260k lines)
  14 tools84 - avgPlotfiles (pc and linear) over three production
               hierarchies (phase 13's plotfile, refine_frac 0.25, two
               levels), subPlt, combinePlts, regridPlt, template, plt2npz
               (levels; flat to level 1) and npz2plt, fcompare and
               fextrema, slicePlot, avgToPlane, interp at 1 M points,
               amrToFE (flt; Tecplot at the repo case), doctor,
               buildDistance (the 130,052-node sphere MEF)
               and isosurface build_distance_function=1 at production
               size: launches counted (none of the five kernels runs on
               this path: the "launches_tools84" of the kernel summary),
               cold walls and device time, the outputs checked (the
               ensemble's level 0 equal to the field, round trips bitwise,
               the distances within one finest dx of |r - R| in the band
               and of the right sign), buildDistance's layers split (band
               seeding, sweeps as CUDA graphs and op by op, bitwise equal,
               parity sign), and every verb card against CPU at the repo
               case (the Tecplot text of amrToFE among them)
  15 tools86 - the 13 MEF verbs (isoMEF, combineMEF, mergeMEF, multMEF,
               scaleMEF, sliceMEF, smoothMEF, trimMEFgen, binMEF,
               decimateMEF, surfDATtoMEF, surfMEFtoDAT, checkIso) on the
               130,052-node sphere MEF with two fields, the production
               isosurface of 7c and 1 M random triangles (binMEF, 16^3
               bins over 3 coordinates), and stream2plt, streamScatter,
               streamSub and streamTubeStats on 5b's 130,052-line
               StreamData: launches counted (none of the five kernels runs
               on this path: the "launches_tools86" of the kernel
               summary), warm walls split into read / compute / write with
               peak device memory and device time (one profiler session),
               the closed forms (bins add up to the area, a trim through
               the centre keeps half of it, the equator slice is one
               closed polyline of length 2 pi r, the sphere and its
               decimation watertight, tube volumes >= 0 and the seed
               surface's 1000 K), and every verb card against CPU
               (elements and connectivity equal, values within 1e-12; the
               stream verbs at the repo case)
  16 tools88 - plotXtoY, plotYtoX, plotTransportCoeff, plotTYtoLe,
               plotQPD (QPDatom=C; an 84-reaction mechanism over drm19's
               21 species written by the script), sCO2 (nBins=64,
               nBinPlanes=10) and buildPMF (a 2,000-point flame table) at
               production size (the 19.5 M-cell case with 21 mole
               fractions, temp, density, adv_0, adv_1 and vfrac; 4 GB):
               launches counted (none of the five kernels runs on this
               path: the "launches_tools88" of the kernel summary), each
               cold run's device time and kernels from one profiler
               session, each output read back and deleted;
               every verb card against CPU at the repo case (adv_0 with
               NaN, +-inf and +-1e30 cells; plotfiles within 1e-12,
               plotQPD within 1e-10, sCO2 within 1e-12, buildPMF byte for
               byte) and the closed forms (Y sums to 1, Y -> X round trip,
               Le = 1, a uniform field's plotQPD integral Q x V_domain,
               sCO2's slabs adding up to the domain); qf_qr_sums of a
               53-species, 325-reaction mechanism on 19.4 M random states
               made on the card (CUDA events, peak memory, bound), and on
               the CPU for 1 M of them
  17 pipeline - the production chain of the JAX bench's sec_cli32 (grad,
               curvature, the temp = 1000 K isosurface, stream traceAlongV=1
               seeded from its nodes) warm, three ways in turns, min of 2:
               four cli.main calls (file-chained), one `pipeline` with
               write=0 on the isosurface, and the four commands through a
               `serve` thread (send_command sync=True, an empty session
               each round; then twice with a warm session): walls, each
               stage's and command's wall and peak device memory, reads,
               the final flushes' wait; the pipeline's and the server's
               plotfiles and lines (and the server's MEF) byte-equal to the
               file-chained run's; a session's device memory back to its
               level after reset; `python -m peleanalysis_tpu_torch serve`
               as a child process (one send of grad at the repo case equal
               to a direct run, shutdown, exit 0); conditionalMean and a
               jpdf pair over 4 production plotfiles with prefetch=0 and 1
               (outputs equal); DeferredSurface.positions() against its
               full copy and DeferredLines.finish() against one copy a
               level.  Launches counted over the timed runs (the
               "launches_pipeline" of the kernel summary), then every
               kernel held against its plain version on one pipeline and
               one run of each stats tool
  18 sharded - ndevices=4 with mesh_shape=2 2 (four shards on the one
               card: parallel/) against ndevices=1 at production size on
               phase 17's plotfile: grad, curvature (do_gaussCurv=1) and
               the 1000 K isosurface (deep-halo windows), partStream from
               the 130k-node MEF (the migrating march, four X slabs), and
               grad, curvature and isosurface on the sparse parity case
               (the clusters dealt over the shards): outputs byte-equal,
               cold and warm walls, peak device memory, the largest
               window's bytes against the whole state's; the sharded runs'
               launches counted (the "launches_sharded" of the kernel
               summary, grad_mag's equal to the windows' levels); each
               sharded run of a tool that launches a kernel (grad,
               curvature, partStream; the sparse grad and curvature) once
               more with every kernel call held against its plain version
               at the windows', clusters' and blocks' own shapes (as phase
               12); halo_grad (parallel/halo.py) over 2 x 2 shards against
               the plain global gradient (gradients bitwise, magnitude <= 1
               ulp) and the march over a window of a volume against the
               plain version, bitwise, in all five variants
The errors of 12, 12b, 13, 17 and 18 go into the kernel summary's
max_abs_err.
The line before the last is the kernel summary ({"kernels": [...]}); the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import filecmp
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from peleanalysis_tpu_torch import cli, native
from peleanalysis_tpu_torch.amr.cluster import (cluster_boxes,
                                                cluster_substates,
                                                coarse_only_state)
from peleanalysis_tpu_torch.amr.dense import (DenseAmrState, PlotfileRecords,
                                              _box_slices, _level_metas)
from peleanalysis_tpu_torch.amr.hierarchy import (AmrMeta, load_plotfile_fabs,
                                                  output_layout,
                                                  write_level_fabs)
from peleanalysis_tpu_torch.chem.kinetics import Kinetics, parse_chemkin
from peleanalysis_tpu_torch.chem.mechanism import molecular_weight
from peleanalysis_tpu_torch.geom import marching_cubes as mc
from peleanalysis_tpu_torch.geom.marching_cubes import extract_isosurface
from peleanalysis_tpu_torch.geom import mef_tools
from peleanalysis_tpu_torch.io.fab import fab_header_str, read_fab
from peleanalysis_tpu_torch.io.fab_pack import fetch_level, level_records
from peleanalysis_tpu_torch.io.mef import MEF, read_mef, write_mef
from peleanalysis_tpu_torch.io.particles import read_particles
from peleanalysis_tpu_torch.io.plotfile import (PlotfileReader,
                                                write_plotfile_header)
from peleanalysis_tpu_torch.io.stream_data import (StreamData,
                                                   compute_inside_nodes,
                                                   read_stream_data,
                                                   write_stream_data)
from peleanalysis_tpu_torch.ops import grad_kernels as gk
from peleanalysis_tpu_torch.parallel.dense_shard import (
    CURVATURE_STAGES, GRAD_STAGES, ISO_HALO, ShardedDenseState,
    make_spatial_mesh, stencil_halo)
from peleanalysis_tpu_torch.parallel.halo import (WindowHalo, halo_grad,
                                                  join_blocks, split_blocks)
from peleanalysis_tpu_torch.ops import solve
from peleanalysis_tpu_torch.ops import stats_kernels as sk
from peleanalysis_tpu_torch.stream import march_kernels as mk
from peleanalysis_tpu_torch.session import load_state
from peleanalysis_tpu_torch.stream.trace import trace_streamlines
from peleanalysis_tpu_torch.testing import (cell_centers, default_fields,
                                            make_amr_hierarchy,
                                            synthetic_mechanism,
                                            write_hit_run,
                                            write_scattered_plotfile,
                                            write_synthetic_plotfile)
from peleanalysis_tpu_torch.tools.conditional_mean import (
    accumulate_conditional_mean, accumulate_stats_fused, stats_parts,
    write_cm_dat)
from peleanalysis_tpu_torch.tools.curvature import compute_curvature_dense
from peleanalysis_tpu_torch.tools.flatten_amr import flatten_to_level
from peleanalysis_tpu_torch.tools.grad import compute_grad_dense
from peleanalysis_tpu_torch.tools.jpdf import (compute_jpdf_pairs,
                                               normalize_pair, write_gnuplot)
from peleanalysis_tpu_torch.tools.sco2 import slab_sums
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


def batch_ms(fn, launches=10, reps=5, warmup=3) -> float:
    """Median over reps of the mean device time of fn() over a batch of
    launches, CUDA events around the batch: the host's work between
    launches overlaps the device's, as in a stream of calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


# one H100 SXM's published peaks (NVIDIA's data sheet, at the 700 W limit):
# memory bytes/s and the vector (non-tensor-core) flop/s of each dtype
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the flops over the dtype's peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


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
    # one nvcc per source and the g++ build, all started together
    with ThreadPoolExecutor(4) as ex:
        jobs = [ex.submit(m.build, verbose=True) for m in (gk, mk, sk)]
        jobs.append(ex.submit(native.build))
        paths = [j.result() for j in jobs]
    gk.load_library()
    mk.load_library()
    sk.load_library()
    native.get_lib()
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
    # the yardstick: torch.gradient computes gx, gy, gz (not the magnitude)
    # of the grown field; its interior is the kernel's with_mag=False output
    g = torch.randn((122,) * 3, generator=gen, dtype=torch.float64).to(
        dev, torch.float32)
    lib = torch.gradient(g, spacing=list(dx))
    k = gk.grad_mag(g, dx, False)
    lib_err = max(float((a[1:-1, 1:-1, 1:-1] - b).abs().max())
                  for a, b in zip(lib, k))
    if not lib_err <= 1e-5 * float(k.abs().max()):
        raise AssertionError(f"torch.gradient differs from grad_mag by "
                             f"{lib_err}")
    library_ms = cuda_ms(lambda: torch.gradient(g, spacing=list(dx)))
    # the bound of the main-path case (grown 122^3 float32, with the
    # magnitude): the grown field read once and 4 outputs written once,
    # against 12 flops a cell (3 differences and divisions; 3 products,
    # 2 sums and a square root)
    n = 120 ** 3
    nbytes, flops = 4 * (122 ** 3 + 4 * n), 12 * n
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)
    ms, plain_ms = main_times[((122, 122, 122), torch.float32, True)]
    emit({"phase": "kernel_vs_plain", "tolerance": "gradients bitwise, "
          "magnitude <= 1 ulp", "cases": cases,
          "library": {"call": "torch.gradient", "grown": [122] * 3,
                      "dtype": "float32", "ms": library_ms,
                      "kernel_ms_without_magnitude": main_times[
                          ((122, 122, 122), torch.float32, False)][0],
                      "max_abs_diff": lib_err},
          "bound": {"bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
                    "bound_by": bound_by, "share": bound_ms / ms}})
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# -- phase 3b -------------------------------------------------------------------
# (field dtype, position dtype) of the march kernel's five variants
MARCH_VARIANTS = {"f64": (torch.float64, torch.float64),
                  "f32": (torch.float32, torch.float32),
                  "f32_f64": (torch.float32, torch.float64),
                  "bf16_f64": (torch.bfloat16, torch.float64),
                  "bf16_f32": (torch.bfloat16, torch.float32)}


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


# flops of one line-step of the march: 4 stages of 84 (the cell coordinate
# 9, t and the weights 6, the 8 corner weights from their 4 shared products
# wx * wy and the 24-term sum 57, the norm 6, the unit vector 6) and 39 for
# the stage inputs and the update
FLOPS_PER_LINE_STEP = 4 * 84 + 39


class StencilCells(TorchDispatchMode):
    """Marks the field cells that march_torch's corner gathers read (every
    aten.index of the field's storage), on the field's device."""

    def __init__(self, field: torch.Tensor):
        super().__init__()
        self.ptr = field.untyped_storage().data_ptr()
        self.seen = torch.zeros(int(np.prod(field.shape[:3])),
                                dtype=torch.bool, device=field.device)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func is torch.ops.aten.index.Tensor
                and args[0].untyped_storage().data_ptr() == self.ptr):
            self.seen[args[1][0].reshape(-1)] = True
        return func(*args, **(kwargs or {}))


def march_bound(field, seeds, n_steps: int, cells: int) -> dict:
    """Bytes, flops and bound of one march in which every line stays alive:
    each touched cell's 3 components read once, the seeds and directions
    read once, the positions and alive flags written once;
    FLOPS_PER_LINE_STEP flops a line-step, at the peak of the position
    dtype."""
    N, pos = seeds.shape[0], seeds.element_size()
    nbytes = (cells * 3 * field.element_size() + N * 4 * pos
              + (n_steps + 1) * N * 3 * pos + N)
    flops = FLOPS_PER_LINE_STEP * N * n_steps
    bound_ms, bound_by = bound(nbytes, flops, seeds.dtype)
    return {"cells": cells, "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_march_kernel(dev) -> dict:
    """Kernel vs march_torch at three shapes: boundary-exit lines in a
    small outward-drift field, the repo case's finest level (grown 150^3,
    gradient 148^3, 4k lines) and the production finest level (gradient
    276^3, 130k sphere seeds in both directions, 25 steps).  The order key
    kernel vs order_key_torch at each.  At production: the distinct field
    cells the stencils read (counted from the plain version's gathers),
    the bytes, flops and bound of a march, the kernel's share of it and its
    registers; the order key's times and bound."""
    cases, worst, times, key = [], 0.0, {}, None
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
        vec = field64.movedim(-1, 0)
        shape = field64.shape[:3]
        if not torch.equal(mk.order_key(shape, plo, dx, seeds, dirs),
                           mk.order_key_torch(shape, plo, dx, seeds, dirs)):
            raise AssertionError(f"order key differs from plain at {name}")
        if name == "production":
            key = order_key_times(shape, plo, dx, seeds, dirs)
        for var, (fdt, sdt) in MARCH_VARIANTS.items():
            field = mk.prepare_field(vec, fdt)
            s, d = seeds.to(sdt), dirs.to(sdt)
            k, ka = mk.march(field, plo, dx, h, s, n, d)
            with StencilCells(field) as stencils:
                p, pa = mk.march_torch(field, plo, dx, h, s, n, d)
            torch.cuda.synchronize()
            err = float((k - p).abs().max())
            if not (torch.equal(k, p) and torch.equal(ka, pa)):
                raise AssertionError(f"march kernel differs from plain at "
                                     f"{name} {var}: err {err}, alive "
                                     f"equal {torch.equal(ka, pa)}")
            if not torch.isfinite(k).all():
                raise AssertionError(f"non-finite march at {name} {var}")
            worst = max(worst, err)
            case = {"shape": name, "variant": var, "lines": 2 * ns,
                    "steps": n, "max_abs_err": err, "bitwise": True,
                    "alive": int(ka.sum()),
                    "ordered": (fdt, sdt) in mk.ORDERED}
            if name == "production" and var != "bf16_f32":
                if not bool(ka.all()):
                    raise AssertionError("a production line froze: the "
                                         "bound counts every line-step")
                case.update(march_bound(field, s, n,
                                        int(stencils.seen.sum())))
                def run():
                    return mk.march(field, plo, dx, h, s, n, d)
                # one call, the host's work before its launches included;
                # then the mean over a batch, where that work overlaps the
                # previous call's launches
                case["ms"] = cuda_ms(run, n=10)
                case["batch_ms"] = batch_ms(run)
                case["plain_ms"] = cuda_ms(
                    lambda: mk.march_torch(field, plo, dx, h, s, n, d),
                    n=5, warmup=1)
                case["share_of_bound"] = case["bound_ms"] / case["ms"]
                case["share_of_bound_batch"] = (case["bound_ms"]
                                                / case["batch_ms"])
                case["kernel"] = mk.kernel_report(fdt, sdt)
                times[var] = case
            cases.append(case)
            del field, k, p
    emit({"phase": "march_kernel_vs_plain", "tolerance": "bitwise: "
          "positions and alive flags identical; order keys identical",
          "cases": cases, "order_key": key})
    return {"max_abs_err": worst, "key": key, **{k: times["f64"][k] for k in (
        "ms", "batch_ms", "plain_ms", "bound_ms", "bound_by")}}


def order_key_times(shape, plo, dx, seeds, dirs) -> dict:
    """The order key kernel and its plain version at one march's lines
    (float64): times per call and the bound, the seeds and directions read
    once and the int32 keys written once, against 9 flops a line (the cell
    coordinate; the Morton code is integer work)."""
    N = seeds.shape[0]
    ms = cuda_ms(lambda: mk.order_key(shape, plo, dx, seeds, dirs))
    plain_ms = cuda_ms(lambda: mk.order_key_torch(shape, plo, dx, seeds,
                                                  dirs))
    nbytes, flops = N * (4 * 8 + 4), 9 * N
    bound_ms, bound_by = bound(nbytes, flops, torch.float64)
    return {"lines": N, "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": 0}


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
    reset_counts()
    cold = {"grad": run_tool("grad", grad_args, L),
            "curvature": run_tool("curvature", curv_args, L)}
    launches = gk.LAUNCHES
    if launches != (1 + 7) * L or any(list(counts().values())[1:]):
        raise AssertionError(f"main path launches {counts()}")
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


def counts() -> dict:
    return {"grad_mag": gk.LAUNCHES, "stream_march": mk.LAUNCHES,
            "stream_march_order_key": mk.KEY_LAUNCHES,
            "stats_binned": sk.BINNED_LAUNCHES,
            "stats_joint": sk.JOINT_LAUNCHES}


def reset_counts() -> None:
    gk.LAUNCHES = mk.LAUNCHES = mk.KEY_LAUNCHES = 0
    sk.BINNED_LAUNCHES = sk.JOINT_LAUNCHES = 0


def run_tool_counted(tool: str, args, expect) -> float:
    """One CLI run; expect = its launches of each kernel, as counts()
    orders them, and none of the kernels past its end.  The tools march
    float64 fields, so every march launch follows one order key launch."""
    expect = tuple(expect) + (0,) * (len(counts()) - len(expect))
    before = counts()
    t0 = time.perf_counter()
    rc = cli.main([tool, *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{tool} exited {rc}")
    got = tuple(v - before[k] for k, v in counts().items())
    if got != tuple(expect):
        raise AssertionError(f"{tool}: launches {got} of {list(before)}, "
                             f"expected {tuple(expect)}")
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
                                       f"outFile={sd_grad}.dat"], (L, L, L)),
        "stream_velocity": ("stream", [*common, "traceAlongV=1",
                                       f"streamFile={sd_vel}"], (0, L, L)),
        "sampleStreamlines": ("sampleStreamlines", [
            f"plotfile={plt}", f"pathFile={sd_grad}", "comps=density temp",
            f"streamSampleFile={sd_samp}"], (0, 0, 0)),
    }
    # the stream path's run: every count set to 0 just before, read just
    # after; one grad_mag, one order key and one march launch per seeded
    # level
    reset_counts()
    cold = {k: run_tool_counted(*v) for k, v in runs.items()}
    launches = counts()
    if launches != {"grad_mag": L, "stream_march": 2 * L,
                    "stream_march_order_key": 2 * L, "stats_binned": 0,
                    "stats_joint": 0}:
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
    return {"launches": launches, "plt": plt, "mef": mef, "sd": sd_grad}


# -- phase 5 --------------------------------------------------------------------
def same_tree(a: str, b: str) -> int:
    """Raise unless directories a and b hold the same files, byte for
    byte; returns the bytes compared."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    if files(a) != files(b):
        raise AssertionError(f"{a} and {b} hold different files")
    for f in files(a):
        if not filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False):
            raise AssertionError(f"{f} differs between {a} and {b}")
    return sum(os.path.getsize(os.path.join(a, f)) for f in files(a))


def host_write_split(ds, path: str) -> dict:
    """The float64 plotfile write as the port made it before the device
    writer (the plain host version), step by step: one copy of each level
    to the host; box by box a numpy transpose to [comp, k, j, i] and cast;
    each box's per-component min/max of its cast values; the FAB bytes;
    the Header and _H text."""
    from peleanalysis_tpu_torch.io.plotfile import (_write_fab_files,
                                                    _write_vismf_h)
    meta, nc = ds.meta, len(ds.names)
    geoms, bas = output_layout(meta)
    t = dict.fromkeys(("d2h_s", "transpose_cast_s", "minmax_s",
                       "fab_bytes_s", "headers_s"), 0.0)
    t0 = time.perf_counter()
    hosts = [d.cpu().numpy() for d in ds.data]
    t["d2h_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_plotfile_header(path, ds.names, meta.time, geoms, meta.ref_ratio,
                          bas, meta.level_steps)
    t["headers_s"] += time.perf_counter() - t0
    for lev, ba in enumerate(meta.bas):
        bbox = ds.lmeta[lev].bbox
        wins = [hosts[lev][(slice(None),) + _box_slices(b, bbox)] for b in ba]
        t0 = time.perf_counter()
        recs = [np.ascontiguousarray(np.transpose(w, (0, 3, 2, 1)),
                                     dtype=np.float64) for w in wins]
        t1 = time.perf_counter()
        cast = [np.asarray(w, dtype=np.float64) for w in wins]
        mins = np.array([[float(c[k].min()) for k in range(nc)]
                         for c in cast])
        maxs = np.array([[float(c[k].max()) for k in range(nc)]
                         for c in cast])
        t2 = time.perf_counter()
        d = os.path.join(path, f"Level_{lev}")
        entries = _write_fab_files(
            d, "Cell", len(ba), lambda f, i: (f.write(fab_header_str(
                bas[lev][i], nc)), recs[i].tofile(f)), 64)
        t3 = time.perf_counter()
        _write_vismf_h(d, "Cell", bas[lev], nc, entries, mins, maxs)
        t4 = time.perf_counter()
        t["transpose_cast_s"] += t1 - t0
        t["minmax_s"] += t2 - t1
        t["fab_bytes_s"] += t3 - t2
        t["headers_s"] += t4 - t3
    return t


def device_write_split(ds, path: str) -> dict:
    """to_plotfile step by step: each level packed on the card (slice,
    permute, cast, min/max tables), its one copy to pinned host memory,
    the tables' zero signs settled, the FAB bytes, the Header and _H."""
    from peleanalysis_tpu_torch.io.plotfile import (_write_fab_files,
                                                    _write_vismf_h)
    meta, nc = ds.meta, len(ds.names)
    geoms, bas = output_layout(meta)
    t = dict.fromkeys(("pack_s", "d2h_s", "tables_s", "fab_bytes_s",
                       "headers_s"), 0.0)
    t0 = time.perf_counter()
    write_plotfile_header(path, ds.names, meta.time, geoms, meta.ref_ratio,
                          bas, meta.level_steps)
    t["headers_s"] += time.perf_counter() - t0
    for lev, ba in enumerate(bas):
        t0 = time.perf_counter()
        packed = ds.packed_level(lev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host, wait = fetch_level(packed)
        wait()
        t2 = time.perf_counter()
        payloads, mins, maxs = level_records(packed, host,
                                             [b.shape for b in ba])
        t3 = time.perf_counter()
        d = os.path.join(path, f"Level_{lev}")
        entries = _write_fab_files(
            d, "Cell", len(ba), lambda f, i: (f.write(fab_header_str(
                ba[i], nc)), f.write(payloads[i])), 64)
        t4 = time.perf_counter()
        _write_vismf_h(d, "Cell", ba, nc, entries, mins, maxs)
        t5 = time.perf_counter()
        for k, v in zip(("pack_s", "d2h_s", "tables_s", "fab_bytes_s",
                         "headers_s"), (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                        t5 - t4)):
            t[k] += v
    return t


PROFILE_PAUSES_S = (0.5, 2.0)
# the time kernel_profiles may spend profiling fns alone when its joint
# session keeps losing markers
PROFILE_FALLBACK_S = 30.0


def profiled(fn):
    """fn() once under torch.profiler, in a window the trace holds whole: a
    marker kernel (``torch.cuda._sleep``, "spin_kernel") just before fn and
    one just after it must both be among the trace's device events.  The
    device events of a session's first few hundred ms can be missing from
    the trace (seen in a long process: every event of a 0.3 s tool run), so
    fn starts after a pause, and the trace stays open as long after it; a
    window that lost a marker is taken again after a longer pause.  Returns
    (prof, fn's host wall seconds, the device events between the markers
    in start order, whether both markers were seen; if not, every device
    event of the last try)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for pause in PROFILE_PAUSES_S:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(pause)
            torch.cuda._sleep(1000)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pause)
        dev = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.start_ns())
        marks = [i for i, e in enumerate(dev) if "spin_kernel" in e.name()]
        if len(marks) == 2:
            return prof, wall, dev[marks[0] + 1: marks[1]], True
    return prof, wall, [e for e in dev if "spin_kernel" not in e.name()], \
        False


def d2h_copies(fn) -> int:
    """Device-to-host copies the card makes during fn() (torch.profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name.startswith("Memcpy DtoH"))


def write_checks(res, base: str) -> dict:
    """The device writer's plotfile (``base``, from to_plotfile) against
    the plain host writer's, byte for byte; the write split on both paths;
    one device-to-host copy a level."""
    plain = base + "_plain"
    t0 = time.perf_counter()
    write_level_fabs(res.meta, res.names, res.level_fabs(), plain)
    plain_s = time.perf_counter() - t0
    nbytes = same_tree(base, plain)
    host = host_write_split(res, base + "_host")
    same_tree(base + "_host", plain)
    device = device_write_split(res, base + "_dev")
    same_tree(base + "_dev", plain)
    copies = d2h_copies(lambda: res.to_plotfile(base + "_prof"))
    if copies != res.meta.n_levels:
        raise AssertionError(f"to_plotfile: {copies} device-to-host copies "
                             f"for {res.meta.n_levels} levels")
    nonfinite = sum(int((~torch.isfinite(d)).sum()) for d in res.data)
    for d in (plain, base + "_host", base + "_dev", base + "_prof"):
        shutil.rmtree(d)
    return {"bytes_equal": nbytes, "plain_write_s": plain_s,
            "host_split": host, "device_split": device,
            "d2h_copies": copies, "nonfinite_cells": nonfinite}


def layer_split(plt: str, dev) -> dict:
    """Read, device compute and write of each tool, timed apart (host
    clock; the compute ends in a synchronize), and the write's checks."""
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
        split = os.path.join(os.path.dirname(plt), f"split_{tool}")
        res.to_plotfile(split)
        t3 = time.perf_counter()
        out[tool] = {"read_s": t1 - t0, "compute_s": t2 - t1,
                     "write_s": t3 - t2,
                     "write": write_checks(res, split)}
        shutil.rmtree(split)
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
    time of its device-to-host copies, of its march kernel launches and of
    the march's locality order (key kernel and radix sort)."""
    _, wall, dev, whole = profiled(fn)

    def device_ms(part: str) -> float:
        return sum(e.end_ns() - e.start_ns() for e in dev
                   if part in e.name()) / 1e6

    return {"wall_s": wall, "d2h_ms": device_ms("Memcpy DtoH"),
            "march_kernel_ms": device_ms("march_kernel"),
            "march_order_ms": device_ms("order_key_kernel")
            + device_ms("RadixSort"), "trace_whole": whole}


def tecplot_python(names, lines: np.ndarray) -> bytes:
    """The Tecplot text as the port formatted it before the native
    formatter: one Python ``%`` format a line, the JAX package's numpy
    text wherever no NaN appears."""
    nl, st, nc = lines.shape
    zone = (" ".join(["%.9g"] * nc) + "\n") * st
    parts = [("VARIABLES = " + " ".join(names) + "\n").encode()]
    for i in range(nl):
        parts.append(f'ZONE T="line{i}" I={st} DATAPACKING=POINT\n'.encode())
        parts.append((zone % tuple(lines[i].ravel().tolist())).encode())
    return b"".join(parts)


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
    tec = os.path.join(tmp, "split_lines.dat")
    write_tecplot_lines(tec, names, lines)
    t4 = time.perf_counter()
    ref = tecplot_python(names, lines)
    t5 = time.perf_counter()
    if not np.isfinite(lines).all():
        raise AssertionError("production lines hold non-finite values")
    with open(tec, "rb") as f:
        if f.read() != ref:
            raise AssertionError("native Tecplot text differs from the "
                                 "Python formatting")
    kw = dict(trace_field="temp", sample_names=["temp", "density"])
    prof = {
        "float64": profiled_trace(lambda: trace_streamlines(
            ds, seeds.positions(), 51, 0.5, **kw)),
        "bfloat16_packed": profiled_trace(lambda: trace_streamlines(
            ds, seeds.positions(), 51, 0.5, march_dtype="bfloat16", **kw))}
    return {"read_s": t1 - t0, "trace_s": t2 - t1,
            "stream_data_write_s": t3 - t2, "tecplot_write_s": t4 - t3,
            "tecplot_python_format_s": t5 - t4, "tecplot_bytes": len(ref),
            "tecplot_byte_equal": True, "profiled_trace": prof}


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
                        f"streamFile={sd}", f"outFile={sd}.dat"], (1, 1, 1)),
            ("sampleStreamlines", [f"plotfile={plt}", f"pathFile={sd}",
                                   "comps=density",
                                   f"streamSampleFile={sd2}"], (0, 0, 0)))
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
    reset_counts()
    cold = run_tool_counted("isosurface", args, (0, 0, 0))
    launches = counts()
    warm = [run_tool_counted("isosurface", args, (0, 0, 0))
            for _ in range(3)]
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
    prof, wall, _, whole = profiled(fn)
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
            "stage_kernels": dict(launches), "trace_whole": whole}


def phase_iso_prod(tmp: str, dev) -> None:
    plt = os.path.join(tmp, "plt_prod")
    base = os.path.join(tmp, "iso_prod")
    args = [f"infile={plt}", f"isoVal={ISO_VAL:g}", f"outfile_base={base}"]
    cold = run_tool_counted("isosurface", args, (0, 0, 0))
    torch.cuda.reset_peak_memory_stats()
    warm = run_tool_counted("isosurface", args, (0, 0, 0))
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
        reset_counts()
        mef = [fn() for fn in stages.values()][-1]
        launches = counts()
        L = case["n_levels"]
        if launches != {"grad_mag": (1 + 7) * L, "stream_march": 0,
                        "stream_march_order_key": 0, "stats_binned": 0,
                        "stats_joint": 0}:
            raise AssertionError(f"main path launches {launches}")
        if not (mef.n_elts > 0 and np.isfinite(mef.nodes).all()):
            raise AssertionError("main path: empty or non-finite surface")
        ms = {k: cuda_ms(fn, n=n) for k, fn in stages.items()}
        out[name] = {"case": case, "dtype": "float32", "launches": launches,
                     "ms": ms, "sum_ms": sum(ms.values()),
                     "nodes": mef.n_nodes, "triangles": mef.n_elts}
    emit({"phase": "main_path", "timing": "median CUDA-event time per "
          "stage over warm runs", **out})


# -- phase 3c -------------------------------------------------------------------
# the production case's cells (128^3 + 128^3 + 248^3), flattened
PROD_CELLS = 2 * 128 ** 3 + 248 ** 3
STATS_BINS = 64
# (lo, hi) of the three variables of the stats checks: temp, progress,
# density ranges of testing.default_fields, as the JAX bench bins them
STATS_RANGES = ((300.0, 1801.0), (-0.1, 1.1), (0.05, 1.3))
# sums, of each output's largest value: a float32 kernel adds its terms
# into per-block shared-memory bins (a thread's runs, a warp's sums) before
# its float64 reduction, where the plain version adds them all in float64;
# in float64
# the plain version's index_add_ adds up to ~250 K terms a bin one after
# another (n eps = 3e-11), and is the less exact of the two (tree_sums)
STATS_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def stats_fields(n: int, dtype, dev, seed: int, nbins: int = STATS_BINS):
    """Three fields of n cells over STATS_RANGES widened by a tenth each
    side; every third cell sits on a float64 bin edge rounded to dtype or
    one ulp either side of it.  A mask keeping ~90% of the cells."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for lo, hi in STATS_RANGES:
        span = hi - lo
        v = (torch.rand(n, generator=g, device=dev, dtype=torch.float64)
             * 1.2 * span + lo - 0.1 * span).to(dtype)
        e = torch.tensor(lo + span * np.arange(nbins + 1) / nbins,
                         device=dev).to(dtype)
        inf = torch.full_like(e, float("inf"))
        near = torch.cat([e, torch.nextafter(e, inf),
                          torch.nextafter(e, -inf)])
        k = v[::3].numel()
        v[::3] = near[torch.randint(0, near.numel(), (k,), generator=g,
                                    device=dev)]
        out.append(v)
    mask = torch.rand(n, generator=g, device=dev) > 0.1
    return out, mask


def stats_edges(nbins: int, dtype, folded: bool):
    return [sk.bin_transform(lo, hi, nbins, dtype, folded)
            for lo, hi in STATS_RANGES]


def check_stats(k, p, dtype, what: str):
    """Kernel vs plain: hits (k[0], p[0]) equal, the other float outputs
    within STATS_RTOL of their largest value, min/max equal; returns the
    largest absolute difference and the largest over its output's
    largest value."""
    if not torch.equal(k[0], p[0]):
        raise AssertionError(f"{what}: hits differ from the plain version")
    worst = worst_rel = 0.0
    for i, (a, b) in enumerate(zip(k[1:], p[1:]), start=1):
        if a is None and b is None:
            continue
        if i >= 3:                           # binned min/max: exact
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: min/max differ")
            continue
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not err <= STATS_RTOL[dtype] * scale:
            raise AssertionError(f"{what}: output {i} off by {err} of "
                                 f"{scale}")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    return worst, worst_rel


def tree_sums(bv, av, w, mask, edges, nbins, shift):
    """Binned sums and sums of squares (no clamp) with each bin's terms,
    rounded in the values' dtype as the kernel rounds them, added by
    torch.sum's tree in float64: nearly exact, to tell which of the kernel
    and its plain version is off where they differ."""
    f = sk._bin_coord(bv, edges, nbins)
    ok = mask & (f >= 0) & (f < nbins)
    idx = f.clamp(0, nbins - 1).long()
    vs = av - shift.reshape((-1,) + (1,) * bv.ndim)
    wt = torch.as_tensor(w, dtype=av.dtype, device=av.device)
    terms = [(wt * vs).double(), (wt * (vs * vs)).double()]
    out = torch.zeros((2, nbins, av.shape[0]), dtype=torch.float64,
                      device=av.device)
    for b in range(nbins):
        sel = ok & (idx == b)
        for t in range(2):
            out[t, b] = terms[t][:, sel].sum(dim=1)
    return out


def tree_errs(k, p, ref) -> dict:
    """The largest difference of the kernel's and the plain version's sums
    and sums of squares from tree_sums, over each output's largest value."""
    def rel(x):
        return max(float((x[t].double() - ref[t]).abs().max())
                   / (float(ref[t].abs().max()) or 1.0) for t in range(2))
    return {"kernel_vs_tree": rel(k[1:3]), "plain_vs_tree": rel(p[1:3])}


def lib_binned(bv, av, w, mask, edges, nbins, shift, onehot: bool):
    """The same accumulators from library calls: torch.bincount(weights=)
    or a one-hot torch.matmul in 64K-cell chunks (the JAX design)."""
    f = sk._bin_coord(bv, edges, nbins)
    ok = mask & (f >= 0) & (f < nbins)
    idx = f.clamp(0, nbins - 1).long()
    ww = torch.where(ok, torch.full_like(bv, w), torch.zeros_like(bv))
    vs = av[0] - shift[0]
    rhs = torch.stack([torch.ones_like(vs), vs, vs * vs], dim=1)
    if not onehot:
        return [torch.bincount(idx, weights=ww * rhs[:, c], minlength=nbins)
                for c in range(3)]
    bins = torch.arange(nbins, device=bv.device)
    acc = torch.zeros((nbins, 3), dtype=bv.dtype, device=bv.device)
    for c0 in range(0, bv.numel(), 1 << 16):
        sl = slice(c0, c0 + (1 << 16))
        oh = (idx[sl, None] == bins).to(bv.dtype) * ww[sl, None]
        acc += oh.T @ rhs[sl]
    return acc


def lib_joint(vals, w, mask, edges, nbins, pairs, shifts, onehot: bool):
    """Joint histograms from library calls, as lib_binned."""
    T = vals[0].dtype
    idx = [sk._bin_coord(v, e, nbins).clamp(0, nbins - 1).long()
           for v, e in zip(vals, edges)]
    ww = torch.where(mask, torch.full_like(vals[0], w),
                     torch.zeros_like(vals[0]))
    fs = [v - shifts[k] for k, v in enumerate(vals)]
    out = []
    for i, j in pairs:
        if not onehot:
            b = idx[i] * nbins + idx[j]
            out += [torch.bincount(b, weights=x, minlength=nbins * nbins)
                    for x in (ww, ww * fs[i], ww * fs[j])]
            continue
        bins = torch.arange(nbins, device=vals[0].device)
        acc = torch.zeros((3, nbins, nbins), dtype=T, device=vals[0].device)
        for c0 in range(0, vals[0].numel(), 1 << 16):
            sl = slice(c0, c0 + (1 << 16))
            o1 = (idx[i][sl, None] == bins).to(T) * ww[sl, None]
            o2 = (idx[j][sl, None] == bins).to(T)
            lhs = torch.stack([o1, o1 * fs[i][sl, None], o1 * fs[j][sl, None]])
            acc += torch.einsum("xcb,cd->xbd", lhs, o2)
        out.append(acc)
    return out


STATS_KERNELS = ("binned_kernel", "binned_device", "binned_finish",
                 "joint_kernel", "joint_device", "joint_finish")


def stats_device_ms(fn, calls: int = 10) -> dict:
    """Device ms a call of fn, by stats kernel name and in all (the
    histogram and finishing kernels, and whatever else fn launches), from
    ``calls`` calls in one profiled window."""
    prof = kernel_profile(lambda: [fn() for _ in range(calls)],
                          STATS_KERNELS)
    return {"device_ms": prof["device_ms"] / calls,
            "kernels_a_call": prof["kernels"] / calls,
            "by_kernel": {k: v / calls for k, v in
                          prof["device_ms_of"].items() if v},
            "trace_whole": prof["trace_whole"]}


def stats_times(fn, plain, lib, onehot, nbytes, n=10) -> dict:
    """ms: CUDA events around one call (the host's work before its launches
    included); batch_ms: a call in a batch of 10; device_ms: the kernels'
    device time (torch.profiler)."""
    ms = cuda_ms(fn, n=n)
    bound_ms, bound_by = bound(nbytes, 0.0, torch.float32)
    dev = stats_device_ms(fn)
    return {"ms": ms, "batch_ms": batch_ms(fn), **dev,
            "plain_ms": cuda_ms(plain, n=3, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "share_of_bound": bound_ms / ms,
            "share_of_bound_device": bound_ms / dev["device_ms"],
            "library_ms": cuda_ms(lib, n=n) if lib is not None else None,
            "onehot_matmul_ms": cuda_ms(onehot, n=3, warmup=1)
            if onehot is not None else None}


# the five configurations the stats kernel is timed in: binned moments of
# one averaged component in 64 bins, the same with min/max, the joint pdf
# of one pair in 64 bins, of three pairs, and of one pair in 256 bins
STATS_CONFIGS = ("binned", "binned_minmax", "joint", "joint_3pairs",
                 "joint_256")


def stats_config_call(vals, mask, w, shift_b, shift_j, config: str):
    """(entry, args, bytes read and written) of one configuration on one
    level or flat array; vals = [binned / first variable, second, third],
    shift_b [1], shift_j [3]."""
    n = vals[0].numel()
    T = vals[0].dtype
    es = vals[0].element_size()
    if config.startswith("binned"):
        minmax = config == "binned_minmax"
        e = stats_edges(STATS_BINS, T, True)[0]
        args = (vals[0], vals[1][None], w, mask, e, STATS_BINS, False,
                minmax, shift_b)
        return "binned", args, ((2 * es + 1) * n
                                + STATS_BINS * (3 + 2 * minmax) * es)
    nbins = 256 if config == "joint_256" else STATS_BINS
    pairs = [(0, 1), (0, 2), (1, 2)] if config == "joint_3pairs" \
        else [(0, 1)]
    nv = len({i for p in pairs for i in p})
    edges = stats_edges(nbins, T, config != "joint_3pairs")
    args = (vals, w, mask, edges, nbins, pairs, shift_j)
    return "joint", args, (nv * es + 1) * n + 3 * len(pairs) * nbins ** 2 * es


def stats_level_times(ds) -> dict:
    """The five configurations on a tool state's levels (temp binned,
    progress averaged; the tools' weights 8^-lev and masked-mean shifts),
    one call being the levels' calls: per call, in a batch, device ms by
    kernel, bytes bound and shares."""
    levels = []
    for lev, d in enumerate(ds.data):
        vals = [d[ds.comp(n)] for n in ("temp", "progress", "density")]
        m = ds.valid_mask(lev)
        sh = torch.stack([v[m].mean() for v in vals])
        levels.append((vals, m, 8.0 ** -lev, sh[1:2].clone(), sh))
    out = {}
    for config in STATS_CONFIGS:
        calls = [stats_config_call(*lv, config) for lv in levels]
        fn = sk.binned_moments if calls[0][0] == "binned" else sk.joint_hist
        run = lambda: [fn(*a) for _, a, _ in calls]  # noqa: E731
        nbytes = sum(b for _, _, b in calls)
        bound_ms, _ = bound(nbytes, 0.0, torch.float32)
        ms, bms, dev = cuda_ms(run, n=10), batch_ms(run), stats_device_ms(run)
        out[config] = {"ms": ms, "batch_ms": bms, **dev, "bytes": nbytes,
                       "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
                       "share_of_bound_device": bound_ms / dev["device_ms"]}
    return out


def check_stats_cases(fields, dtype, dev, worst, cases, calls) -> None:
    """Every variant of both entry points against its plain version on
    ``fields`` (from stats_fields); appends a record to ``cases``, keeps the
    largest error per entry in ``worst`` and counts wrapper calls."""
    (v0, v1, v2), mask = fields
    n = v0.numel()
    av = torch.stack([v1, v2])
    shift = torch.tensor([0.5, 0.7], dtype=dtype, device=dev)
    e0 = stats_edges(STATS_BINS, dtype, folded=True)[0]
    # binned moments: shared-memory variant with and without min/max, and
    # the device-memory one (16384 bins do not fit in shared memory)
    for nbins, minmax in ((STATS_BINS, False), (STATS_BINS, True),
                          (16384, True)):
        e = e0 if nbins == STATS_BINS else sk.bin_transform(
            300.0, 1801.0, nbins, dtype, True)
        args = (v0, av, 8.0, mask, e, nbins, False, minmax, shift)
        k, p = sk.binned_moments(*args), sk.binned_moments_torch(*args)
        calls[0] += 1
        torch.cuda.synchronize()
        plan = sk.binned_plan(v0, av, 8.0, mask, nbins, minmax)
        err, rel = check_stats(k, p, dtype,
                               f"binned {n} {dtype} {nbins} {minmax}")
        worst["binned"] = max(worst["binned"], err)
        cases.append({"entry": "binned", "cells": n,
                      "dtype": str(dtype)[6:], "nbins": nbins,
                      "minmax": minmax, "variant": plan.variant,
                      "threads": plan.threads, "vec": plan.vec,
                      "max_abs_err": err, "max_err_over_scale": rel,
                      "hits": int(float(p[0].sum()) / 8.0)})
        if nbins == STATS_BINS and not minmax:
            cases[-1].update(tree_errs(k, p, tree_sums(
                v0, av, 8.0, mask, e, nbins, shift)))
            if not cases[-1]["kernel_vs_tree"] <= STATS_RTOL[dtype]:
                raise AssertionError(f"binned {n} {dtype}: kernel "
                                     f"{cases[-1]['kernel_vs_tree']} off "
                                     "the tree sums")
    # joint pdfs: 1 pair with the tools' folded single-pair edges, 3 pairs
    # with joint_pdf_multi's divided ones; 64 bins (shared memory) and 256
    # (device memory)
    for nbins in (STATS_BINS, 256):
        for pairs, folded in ((((0, 1),), True),
                              (((0, 1), (0, 2), (1, 2)), False)):
            edges = stats_edges(nbins, dtype, folded)
            sh = torch.tensor([1000.0, 0.5, 0.7], dtype=dtype, device=dev)
            args = ([v0, v1, v2], 2.0 ** -21, mask, edges, nbins,
                    list(pairs), sh)
            k, p = sk.joint_hist(*args), sk.joint_hist_torch(*args)
            calls[1] += 1
            torch.cuda.synchronize()
            plan = sk.joint_plan([v0, v1, v2], 2.0 ** -21, mask, nbins,
                                 len(pairs))
            err, rel = check_stats(k, p, dtype,
                                   f"joint {n} {dtype} {nbins} {len(pairs)}")
            worst["joint"] = max(worst["joint"], err)
            cases.append({"entry": "joint", "cells": n,
                          "dtype": str(dtype)[6:], "nbins": nbins,
                          "pairs": len(pairs), "variant": plan.variant,
                          "threads": plan.threads, "vec": plan.vec,
                          "folded": folded, "max_abs_err": err,
                          "max_err_over_scale": rel})
    if n > 1 << 20:
        return
    # the per-cell weight paths (multiples of 1/8, so that the hits, sums
    # of weights, are exact in any order), and fields one cell off a
    # 16-byte boundary (one cell a thread at a time), at 64 bins
    cw = 0.125 * (1 + (v1 > 0.5).to(dtype) + 2 * (v2 > 0.6).to(dtype))
    args = (v0, av, cw, mask, e0, STATS_BINS, True, True, shift)
    check_stats(sk.binned_moments(*args), sk.binned_moments_torch(*args),
                dtype, f"binned cell weight {n} {dtype}")
    j_args = ([v0, v1, v2], cw, mask, stats_edges(STATS_BINS, dtype, False),
              STATS_BINS, [(0, 1), (1, 2)], sh)
    check_stats(sk.joint_hist(*j_args), sk.joint_hist_torch(*j_args), dtype,
                f"joint cell weight {n} {dtype}")
    u = [v[1:] for v in (v0, v1, v2)]
    um = mask[1:]
    ua = torch.stack([u[1], u[2]])
    args = (u[0], ua, 8.0, um, e0, STATS_BINS, False, True, shift)
    if sk.binned_plan(u[0], ua, 8.0, um, STATS_BINS, True).vec != 1:
        raise AssertionError("an unaligned field took 16-byte loads")
    check_stats(sk.binned_moments(*args), sk.binned_moments_torch(*args),
                dtype, f"binned unaligned {n} {dtype}")
    j_args = (u, 2.0 ** -21, um, stats_edges(STATS_BINS, dtype, True),
              STATS_BINS, [(0, 1), (0, 2), (1, 2)], sh)
    check_stats(sk.joint_hist(*j_args), sk.joint_hist_torch(*j_args), dtype,
                f"joint unaligned {n} {dtype}")
    calls[0] += 2
    calls[1] += 2
    cases.append({"entry": "both", "cells": n, "dtype": str(dtype)[6:],
                  "cases": "per-cell weight; unaligned (vec 1)",
                  "held": True})


def phase_stats_kernel(dev) -> dict:
    t0 = time.perf_counter()
    worst = {"binned": 0.0, "joint": 0.0}
    cases = []
    # each wrapper call on the card is one counted launch; the plain
    # versions count none
    before = (sk.BINNED_LAUNCHES, sk.JOINT_LAUNCHES)
    calls = [0, 0]
    # 1 M cells, and the production case's 19.4 M flattened: more cells a
    # block than any level of the main path gives a launch (its largest is
    # 248^3).  Phase 10 adds the tools' smooth fields, where a block's
    # cells crowd into few bins.
    for n, seed in ((1 << 20, 1), (PROD_CELLS, 2)):
        for dtype in (torch.float64, torch.float32):
            fields = stats_fields(n, dtype, dev, seed)
            check_stats_cases(fields, dtype, dev, worst, cases, calls)
            del fields
    launched = [sk.BINNED_LAUNCHES - before[0], sk.JOINT_LAUNCHES - before[1]]
    if launched != calls:
        raise AssertionError(f"stats kernel launches {launched} for "
                             f"{calls} wrapper calls")
    # times at the production case's 19.4 M cells, float32 (the tools'
    # default), CUDA events per call, on the fields just checked
    (v0, v1, v2), mask = stats_fields(PROD_CELLS, torch.float32, dev, 2)
    av, shift = v1[None], torch.tensor([0.5], device=dev)
    e0 = stats_edges(STATS_BINS, torch.float32, True)[0]
    b_args = (v0, av, 8.0, mask, e0, STATS_BINS, False, False, shift)
    cell_b = 4 + 4 + 1             # binned value, averaged value, mask byte
    times = {"binned": stats_times(
        lambda: sk.binned_moments(*b_args),
        lambda: sk.binned_moments_torch(*b_args),
        lambda: lib_binned(v0, av, 8.0, mask, e0, STATS_BINS, shift, False),
        lambda: lib_binned(v0, av, 8.0, mask, e0, STATS_BINS, shift, True),
        cell_b * PROD_CELLS)}
    mm_args = b_args[:7] + (True, shift)
    times["binned_minmax"] = stats_times(
        lambda: sk.binned_moments(*mm_args),
        lambda: sk.binned_moments_torch(*mm_args), None, None,
        cell_b * PROD_CELLS)
    sh = torch.tensor([1000.0, 0.5, 0.7], device=dev)
    for name, nbins, pairs, folded in (
            ("joint", STATS_BINS, [(0, 1)], True),
            ("joint_3pairs", STATS_BINS, [(0, 1), (0, 2), (1, 2)], False),
            ("joint_256_global", 256, [(0, 1)], True)):
        edges = stats_edges(nbins, torch.float32, folded)
        nv = len({i for p in pairs for i in p})
        j_args = ([v0, v1, v2], 2.0 ** -21, mask, edges, nbins, pairs, sh)
        times[name] = stats_times(
            lambda: sk.joint_hist(*j_args),
            lambda: sk.joint_hist_torch(*j_args),
            lambda: lib_joint(*j_args[:6], sh, False),
            (lambda: lib_joint(*j_args[:6], sh, True))
            if nbins == STATS_BINS else None,
            (4 * nv + 1) * PROD_CELLS)
    # the library yardsticks compute the same accumulators
    lb = lib_binned(v0, av, 8.0, mask, e0, STATS_BINS, shift, False)
    kb = sk.binned_moments(*b_args)
    if not torch.allclose(lb[0].double(), kb[0].double(), rtol=1e-6):
        raise AssertionError("bincount hits differ from the kernel's")
    emit({"phase": "stats_kernel_vs_plain", "tolerance": "hits equal; sums "
          "within 1e-4 (float32) / 1e-10 (float64) of the largest value, "
          "of the plain version's and of tree_sums; min/max equal",
          "seconds": time.perf_counter() - t0, "cases": cases,
          "launches": {"binned": launched[0], "joint": launched[1]},
          "production_cells": PROD_CELLS,
          "timing": "float32, CUDA events per call and per call in a "
          "batch of 10, device ms by kernel (torch.profiler); library = "
          "torch.bincount(weights=) per accumulator with the bin index as "
          "torch ops; onehot = torch.matmul in 64K-cell chunks",
          "times": times})
    out = {}
    for key, tkey in (("binned", "binned"), ("joint", "joint")):
        t = times[tkey]
        out[key] = {"max_abs_err": worst[key], **{k: t[k] for k in (
            "ms", "batch_ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}}
    return out


# -- phase 9 --------------------------------------------------------------------
def kernel_profile(fn, names=()) -> dict:
    """fn() once under torch.profiler (``profiled``): wall ms, device ms
    and kernel launches, and the device ms of the kernels whose names hold
    each of ``names``.  The device's own events count: kernels (ctypes
    launches included, which no PyTorch op owns), copies and memsets."""
    _, wall, dev, whole = profiled(fn)

    def ms(evs) -> float:
        return sum(e.end_ns() - e.start_ns() for e in evs) / 1e6

    out = {"wall_ms": wall * 1e3, "device_ms": ms(dev),
           "copy_ms": ms(e for e in dev if e.name().startswith("Memcpy")),
           "kernels": sum(1 for e in dev
                          if not e.name().startswith(("Memcpy", "Memset"))),
           "trace_whole": whole}
    if names:
        out["device_ms_of"] = {n: ms(e for e in dev if n in e.name())
                               for n in names}
    return out


def kernel_profiles(fns: dict) -> dict:
    """``kernel_profile`` of each fn of ``fns`` from one torch.profiler
    session, which saves each fn a session's start and stop (seconds): a
    marker kernel before each fn and one after the last; a fn's device
    events are those between its two markers.  A window that lost a
    marker is taken again after a longer pause, then each fn is
    profiled alone until ``PROFILE_FALLBACK_S`` have gone (a long
    process's profiler sessions now and then lose device events, and ~20
    verbs profiled alone took ~2 min on an H100 80GB HBM3 at 700 W); the
    fns left get None and ``not_measured``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for pause in PROFILE_PAUSES_S:
        walls = {}
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(pause)
            for k, fn in fns.items():
                torch.cuda._sleep(1000)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[k] = time.perf_counter() - t0
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pause)
        dev = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.start_ns())
        marks = [i for i, e in enumerate(dev) if "spin_kernel" in e.name()]
        if len(marks) == len(fns) + 1:
            break
    else:
        out, t0 = {}, time.perf_counter()
        for k, fn in fns.items():
            if time.perf_counter() - t0 < PROFILE_FALLBACK_S:
                out[k] = {**kernel_profile(fn), "profiled_alone": True}
            else:
                out[k] = {"wall_ms": None, "device_ms": None,
                          "copy_ms": None, "kernels": None,
                          "trace_whole": False,
                          "not_measured": "profiler fallback over its "
                          f"{PROFILE_FALLBACK_S} s"}
        return out

    def ms(evs) -> float:
        return sum(e.end_ns() - e.start_ns() for e in evs) / 1e6

    out = {}
    for j, k in enumerate(fns):
        evs = dev[marks[j] + 1: marks[j + 1]]
        out[k] = {"wall_ms": walls[k] * 1e3, "device_ms": ms(evs),
                  "copy_ms": ms(e for e in evs
                                if e.name().startswith("Memcpy")),
                  "kernels": sum(1 for e in evs if not e.name().startswith(
                      ("Memcpy", "Memset"))),
                  "trace_whole": True}
    return out


def solve_cost(plt: str, dev) -> dict:
    """The composite smoothing solve's part of a float32 curvature call:
    wall, device time, kernels and host waits with do_smooth=1 minus
    without, and the host's share of the solve's wall time."""
    ds = DenseAmrState.from_plotfile(plt, dev, names=["temp"])
    plain = dict(interp="quadratic")
    smooth = dict(interp="quadratic", do_smooth=True)
    for kw in (plain, smooth):
        compute_curvature_dense(ds, "temp", **kw)        # warm
    solve.ITERATIONS.clear()
    a = kernel_profile(lambda: compute_curvature_dense(ds, "temp", **smooth))
    iters = list(solve.ITERATIONS)
    b = kernel_profile(lambda: compute_curvature_dense(ds, "temp", **plain))
    waits = (host_waits(lambda: compute_curvature_dense(ds, "temp", **smooth))
             - host_waits(lambda: compute_curvature_dense(ds, "temp",
                                                          **plain)))
    d = {k: a[k] - b[k] for k in ("wall_ms", "device_ms", "kernels")}
    return {"iterations": iters, "with_smooth": a, "without": b,
            "solve": d, "solve_share_of_wall": d["wall_ms"] / a["wall_ms"],
            "host_share_of_solve": 1.0 - d["device_ms"] / d["wall_ms"],
            "kernels_per_iteration": d["kernels"] / max(sum(iters), 1),
            "host_waits": waits}


def phase_smooth(tmp: str, dev) -> None:
    out = {}
    for name, case, plt in (("repo", REPO_CASE, "plt_repo"),
                            ("production", PROD_CASE, "plt_prod")):
        plt = os.path.join(tmp, plt)
        L = case["n_levels"]
        res = {}
        for mode, keys in (("composite", []),
                           ("per_level", ["smooth_composite=0"])):
            args = [f"infile={plt}", "progressName=temp", "do_smooth=1",
                    *keys, f"outfile={plt}_Ks"]
            solve.ITERATIONS.clear()
            cold = run_tool("curvature", args, L)       # 7 grad_mag a level
            torch.cuda.reset_peak_memory_stats()
            solve.ITERATIONS.clear()
            warm = run_tool("curvature", args, L)
            res[f"curvature_{mode}"] = {
                "cold_s": cold, "warm_s": warm,
                "cg_iterations": list(solve.ITERATIONS),
                "grad_mag_launches": 7 * L,
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
        args = [f"infile={plt}", "gradVar=temp", "fluxMatch=1",
                f"outfile={plt}_gfm"]
        cold = run_tool_counted("grad", args, (0,))     # no kernel: plain
        torch.cuda.reset_peak_memory_stats()
        warm = run_tool_counted("grad", args, (0,))
        res["grad_fluxMatch"] = {
            "cold_s": cold, "warm_s": warm,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        check_outputs(plt + "_gfm", plt + "_Ks")
        res["composite_solve_cost"] = solve_cost(plt, dev)
        out[name] = res
    # card vs CPU on the repo case: the smoothing in float64 (a float32 CG
    # that stalls follows its rounding), fluxMatch in float32
    plt = os.path.join(tmp, "plt_repo")
    cmp = {}
    for composite in (True, False):
        runs = {}
        for where in (dev, "cpu"):
            st = DenseAmrState.from_plotfile(plt, where, names=["temp"],
                                             dtype=torch.float64)
            solve.ITERATIONS.clear()
            runs[str(where)] = (compute_curvature_dense(
                st, "temp", interp="quadratic", do_smooth=True,
                smooth_composite=composite), list(solve.ITERATIONS))
        (card, it_card), (cpu, it_cpu) = runs[str(dev)], runs["cpu"]
        if it_card != it_cpu:
            raise AssertionError(f"CG iterations card {it_card} vs CPU "
                                 f"{it_cpu}")
        key = "composite" if composite else "per_level"
        cmp[f"curvature_{key}_float64"] = {
            **compare_devices(card, cpu, f"smooth {key}"),
            "cg_iterations": it_card}
    card = DenseAmrState.from_plotfile(plt, dev)
    cpu = DenseAmrState.from_plotfile(plt, "cpu")
    cmp["grad_fluxMatch_float32"] = compare_devices(
        compute_grad_dense(card, "temp", interp="quadratic", flux_match=True),
        compute_grad_dense(cpu, "temp", interp="quadratic", flux_match=True),
        "fluxMatch")
    emit({"phase": "smooth_fluxmatch", "tolerance": "card vs CPU: same "
          "non-finite cells; rtol 1e-6, atol 1e-6 max|cpu|; equal CG "
          "iterations", "cases": out, "card_vs_cpu": cmp})


# -- phase 10 -------------------------------------------------------------------
CONST = 2.5
CM_KEYS = ["binComp=temp", "avgComps=density const", "nBins=64", "binMin=300",
           "binMax=1801"]                                        # bench.py:601
JPDF_PAIR = ["vars=temp progress", "nBins=64", "useminmax1=300 1801",
             "useminmax2=-0.1 1.1", "output_gnuplot=1", "output_plotfile=0"]
JPDF_3VAR = ["vars=temp progress density", "nBins=64", "output_gnuplot=1",
             "output_plotfile=0"]


def cm_check(path: str, finest_cells: int) -> dict:
    """The constant field's conditional mean is the constant, its std 0;
    the hits are the finest-equivalent cells of the domain (temp stays in
    [300, 1801)); density's means lie in its range."""
    t = np.loadtxt(path, skiprows=2)
    n = t[:, -2]
    pop = n > 0
    const_avg = t[pop, 6]
    if not np.allclose(const_avg, CONST, rtol=1e-6):
        raise AssertionError(f"constant field averages {const_avg}")
    if not np.all(t[pop, 8] <= 1e-3 * CONST):
        raise AssertionError("constant field has a spread")
    if not abs(n.sum() - finest_cells) <= 1e-6 * finest_cells:
        raise AssertionError(f"hits {n.sum()} != {finest_cells}")
    dens = t[pop, 5]
    if not (dens.min() >= 0.2 - 1e-6 and dens.max() <= 1.0 + 1e-6):
        raise AssertionError("density averages outside [0.2, 1]")
    return {"bins_populated": int(pop.sum()), "hits": float(n.sum()),
            "max_const_err": float(np.abs(const_avg - CONST).max())}


def pdf_mass(base: str, names) -> dict:
    """Each written pdf sums to 1: its unnormalized mass is the valid
    cells' volume, the domain's."""
    out = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            g = np.loadtxt(os.path.join(base, f"Pdf_{a}_{b}.gpd"))
            s = float(g[:, 2].sum())
            if not abs(s - 1.0) <= 1e-5:
                raise AssertionError(f"pdf {a}-{b} sums to {s}")
            out[f"{a}_{b}"] = s
    return out


def stats_split(plt: str, dev, tmp: str) -> dict:
    """Read, compute (device work and the fetch) and write of both tools,
    timed apart on the host clock."""
    from peleanalysis_tpu_torch.parmparse import ParmParse
    pp = ParmParse({})
    t0 = time.perf_counter()
    [(ds, _)] = stats_parts({}, load_state({}, plt, names=[
        "temp", "density", "const"]), dev, pp, "conditionalMean")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    h, s, q, mn, mx = accumulate_conditional_mean(
        ds, "temp", ["density", "const"], 64, 300.0, 1801.0)
    t2 = time.perf_counter()
    finest_cells = ds.meta.geoms[-1].domain.size
    if h.sum() != finest_cells:          # exact: counts times the weights
        raise AssertionError(f"hits {h.sum()} != {finest_cells}")
    write_cm_dat(os.path.join(tmp, "split_cm.dat"), "temp",
                 ["density", "const"], 64, 300.0, 1801.0, h, s, q)
    t3 = time.perf_counter()
    names = ["temp", "progress", "density"]
    [(ds3, _)] = stats_parts({}, load_state({}, plt, names=names), dev, pp,
                             "jpdf")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    lo_hi = {"temp": (300.0, 1801.0), "progress": (-0.1, 1.1),
             "density": (0.05, 1.3)}
    fields = [[d[ds3.comp(n)] for d in ds3.data] for n in names]
    pairs = ((0, 1), (0, 2), (1, 2))
    b, bx1, bx2 = compute_jpdf_pairs(ds3, fields,
                                     [lo_hi[n][0] for n in names],
                                     [lo_hi[n][1] for n in names], 64, pairs)
    t5 = time.perf_counter()
    for p, (i, j) in enumerate(pairs):
        bn, _, _, C1, C2 = normalize_pair(b[p], bx1[p], bx2[p],
                                          *lo_hi[names[i]], *lo_hi[names[j]],
                                          1.0)
        write_gnuplot(os.path.join(tmp, f"split_{p}.gpd"), C1, C2, bn)
    t6 = time.perf_counter()
    return {"conditionalMean": {"read_s": t1 - t0, "compute_s": t2 - t1,
                                "write_s": t3 - t2},
            "jpdf_3var": {"read_s": t4 - t3, "compute_s": t5 - t4,
                          "write_s": t6 - t5}}


def compare_text_files(a: str, b: str, rtol: float) -> float:
    """Two text outputs: the same words, numbers within rtol of the file's
    largest value; returns the largest difference over that value."""
    def read(path):
        nums, words = [], []
        with open(path) as f:
            for tok in f.read().split():
                try:
                    nums.append(float(tok))
                except ValueError:
                    words.append(tok)
        return np.asarray(nums), words
    (x, wa), (y, wb) = read(a), read(b)
    if wa != wb or x.shape != y.shape:
        raise AssertionError(f"{a} and {b} differ in layout")
    # NaN equals NaN, whatever its sign: the card's NaN is positive, the
    # host's 0/0 negative, and glibc prints the sign
    if not np.array_equal(np.isnan(x), np.isnan(y)):
        raise AssertionError(f"{a} and {b} differ in their NaNs")
    x, y = x[~np.isnan(x)], y[~np.isnan(y)]
    if not np.array_equal(np.isinf(x), np.isinf(y)) or \
            not np.array_equal(x[np.isinf(x)], y[np.isinf(y)]):
        raise AssertionError(f"{a} and {b} differ in their infinities")
    x, y = x[np.isfinite(x)], y[np.isfinite(y)]
    scale = float(np.abs(y).max(initial=0.0)) or 1.0
    err = float(np.abs(x - y).max(initial=0.0)) / scale
    if not err <= rtol:
        raise AssertionError(f"{a} vs {b}: {err} of the largest value")
    return err


def stats_levels_vs_plain(ds) -> dict:
    """The stats wrappers against their plain versions level by level on a
    tool's own state: the main path's shapes and smooth fields, where a
    block's cells crowd into few bins.  Binned with min/max (temp bins,
    density and progress averaged), joint of 1 pair (folded edges) and 3
    pairs (divided), 64 bins; returns the largest absolute error and the
    largest over its output's largest value, per entry, and the binned
    sums' largest distance from tree_sums."""
    ic = [ds.comp(n) for n in ("temp", "progress", "density")]
    worst = {"binned": [0.0, 0.0], "joint": [0.0, 0.0]}
    tree = {"kernel_vs_tree": 0.0, "plain_vs_tree": 0.0}

    def keep(entry, errs):
        worst[entry] = [max(a, b) for a, b in zip(worst[entry], errs)]

    for lev, d in enumerate(ds.data):
        T, m, w = d.dtype, ds.valid_mask(lev), 8.0 ** -lev
        vals = [d[i] for i in ic]
        av = torch.stack([vals[2], vals[1]])
        e = stats_edges(STATS_BINS, T, True)[0]
        args = (vals[0], av, w, m, e, STATS_BINS, False, True,
                av.mean(dim=(1, 2, 3)))
        k, p = sk.binned_moments(*args), sk.binned_moments_torch(*args)
        keep("binned", check_stats(k, p, T, f"binned, level {lev}"))
        errs = tree_errs(k, p, tree_sums(*args[:6], args[8]))
        if not errs["kernel_vs_tree"] <= STATS_RTOL[T]:
            raise AssertionError(f"binned, level {lev}: {errs}")
        tree = {key: max(tree[key], errs[key]) for key in tree}
        sh = torch.stack([v.mean() for v in vals])
        for pairs, folded in (([(0, 1)], True),
                              ([(0, 1), (0, 2), (1, 2)], False)):
            args = (vals, w, m, stats_edges(STATS_BINS, T, folded),
                    STATS_BINS, pairs, sh)
            keep("joint", check_stats(sk.joint_hist(*args),
                                      sk.joint_hist_torch(*args), T,
                                      f"joint {len(pairs)} pairs, level "
                                      f"{lev}"))
    out = {k: {"max_abs_err": a, "max_err_over_scale": r}
           for k, (a, r) in worst.items()}
    out["binned"].update(tree)
    return out


def phase_stats(tmp: str, dev):
    t0 = time.perf_counter()
    out, launches = {}, None
    f = default_fields()
    fields = {"temp": f["temp"], "progress": f["progress"],
              "density": f["density"],
              "const": lambda x, y, z: np.full_like(x, CONST)}
    for name, case in (("repo", REPO_CASE), ("production", PROD_CASE)):
        plt = os.path.join(tmp, f"plt_stats_{name}")
        bas = write_synthetic_plotfile(plt, fields=fields, **case)[1]
        L = case["n_levels"]
        finest_cells = (case["n_cell"] * 2 ** (L - 1)) ** 3
        cm_out = os.path.join(tmp, f"cm_{name}.dat")
        runs = {
            "conditionalMean": ("conditionalMean", [
                f"infile={plt}", *CM_KEYS, f"outfile={cm_out}"], (0,) * 3
                + (L, 0)),
            "jpdf_pair": ("jpdf", [f"infile={plt}", *JPDF_PAIR,
                                   "outSuffix=_jp2"], (0,) * 4 + (L,)),
            "jpdf_3var": ("jpdf", [f"infile={plt}", *JPDF_3VAR,
                                   "outSuffix=_jp3"], (0,) * 4 + (L,))}
        # the stats path's run: every count set to 0 just before, read just
        # after; one binned launch a level for conditionalMean, one joint
        # launch a level for each jpdf run (all pairs in one launch)
        reset_counts()
        cold = {k: run_tool_counted(*v) for k, v in runs.items()}
        if name == "repo":
            launches = counts()
            if launches != {"grad_mag": 0, "stream_march": 0,
                            "stream_march_order_key": 0, "stats_binned": L,
                            "stats_joint": 2 * L}:
                raise AssertionError(f"stats path launches {launches}")
        torch.cuda.reset_peak_memory_stats()
        warm = {k: run_tool_counted(*v) for k, v in runs.items()}
        peak = torch.cuda.max_memory_allocated()
        checks = {"conditionalMean": cm_check(cm_out, finest_cells),
                  "jpdf_pair": pdf_mass(plt + "_jp2", ["temp", "progress"]),
                  "jpdf_3var": pdf_mass(plt + "_jp3", ["temp", "progress",
                                                       "density"])}
        ds = DenseAmrState.from_plotfile(plt, dev,
                                         names=["temp", "progress",
                                                "density"])
        fused = lambda: accumulate_stats_fused(  # noqa: E731
            ds, "temp", ["density"], 64, 300.0, 1801.0,
            ("temp", "progress"), (300.0, 1801.0, -0.1, 1.1), 64)
        (_, _, _), (b, _, _) = fused()
        if not abs(float(b.sum()) - 1.0) <= 1e-5:
            raise AssertionError(f"fused jpdf mass {float(b.sum())}")
        out[name] = {"case": case, "cells": sum(ba.total_cells()
                                                for ba in bas),
                     "cold_s": cold, "warm_s": warm,
                     "max_memory_allocated": peak, "checks": checks,
                     "kernel_vs_plain": stats_levels_vs_plain(ds),
                     "layers": stats_split(plt, dev, tmp),
                     "stats_fused_ms": cuda_ms(fused, n=10),
                     "kernel_times": stats_level_times(ds)
                     if name == "production" else None,
                     "stats_fused_profile": kernel_profile(
                         fused, STATS_KERNELS)}
    # card vs CPU on the repo case, file against file
    plt = os.path.join(tmp, "plt_stats_repo")
    cpu_cm = os.path.join(tmp, "cm_repo_cpu.dat")
    for tool, args in (("conditionalMean", [f"infile={plt}", *CM_KEYS,
                                            f"outfile={cpu_cm}"]),
                       ("jpdf", [f"infile={plt}", *JPDF_3VAR,
                                 "outSuffix=_jp3cpu"])):
        if cli.main([tool, *args, "device=cpu"]) != 0:
            raise RuntimeError(f"{tool} device=cpu failed")
    cmp = {"conditionalMean": compare_text_files(
        os.path.join(tmp, "cm_repo.dat"), cpu_cm, 1e-5)}
    for a, b in (("temp", "progress"), ("temp", "density"),
                 ("progress", "density")):
        cmp[f"jpdf_{a}_{b}"] = compare_text_files(
            os.path.join(plt + "_jp3", f"Pdf_{a}_{b}.gpd"),
            os.path.join(plt + "_jp3cpu", f"Pdf_{a}_{b}.gpd"), 1e-5)
    emit({"phase": "stats_tools", "keys": {"conditionalMean": CM_KEYS,
                                           "jpdf_pair": JPDF_PAIR,
                                           "jpdf_3var": JPDF_3VAR},
          "launches": launches, "tools": out,
          "seconds": time.perf_counter() - t0,
          "card_vs_cpu": {"tolerance": "1e-5 of each file's largest value",
                          "max_err_over_scale": cmp}})
    return launches, {k: max(o["kernel_vs_plain"][k]["max_abs_err"]
                             for o in out.values())
                      for k in ("binned", "joint")}


# -- phase 11 -------------------------------------------------------------------
def loader_check(plt: str) -> dict:
    """Every level of ``plt`` read by the native loader and box by box:
    bitwise equal; both timed (host clock, the files in the page cache)."""
    r = PlotfileReader(plt)
    out = {"levels": r.meta.n_levels, "comps": r.meta.ncomp, "boxes": 0,
           "cells": 0, "native_s": 0.0, "per_box_s": 0.0}
    for lev in range(r.meta.n_levels):
        t0 = time.perf_counter()
        got = r.read_level(lev)
        t1 = time.perf_counter()
        plain = [r.read_box(lev, i) for i in range(len(got))]
        t2 = time.perf_counter()
        for i, (a, b) in enumerate(zip(got, plain)):
            if not np.array_equal(a.view(np.uint64), b.view(np.uint64)):
                raise AssertionError(f"{plt} level {lev} box {i}: native "
                                     "loader differs from read_box")
        out["native_s"] += t1 - t0
        out["per_box_s"] += t2 - t1
        out["boxes"] += len(got)
        out["cells"] += sum(a[0].size for a in got)
    return out


def nan_casts(dev) -> dict:
    """The device writer casts with the card's own float32 <-> float64
    conversions: they must keep a quiet NaN's sign and payload as the
    host's conversion does, or the FAB bytes differ."""
    out = {}
    for name, bits, dst in (
            ("float32_to_float64", np.array(
                [0x7FC00000, 0xFFC00000, 0x7FFFFFFF, 0x7FC12345], np.uint32),
             np.float64),
            ("float64_to_float32", np.array(
                [0x7FF8000000000000, 0xFFF8000000000000, 0x7FFFFFFFFFFFFFFF,
                 0xFFF8123456789ABC], np.uint64), np.float32)):
        x = bits.view(np.float32 if bits.dtype == np.uint32 else np.float64)
        ubits = np.uint64 if dst == np.float64 else np.uint32
        card = torch.from_numpy(x).to(dev).to(
            torch.float64 if dst == np.float64 else torch.float32)
        card = card.cpu().numpy().view(ubits)
        host = x.astype(dst).view(ubits)
        if not np.array_equal(card, host):
            raise AssertionError(f"{name}: the card's NaN bits "
                                 f"{[hex(v) for v in card]} differ from the "
                                 f"host's {[hex(v) for v in host]}")
        out[name] = [f"{a:#x} -> {b:#x}" for a, b in zip(bits, card)]
    return out


def phase_host_io(tmp: str, dev) -> None:
    """The native loader at production size against read_box; the card's
    NaN conversions against the host's."""
    out = {name: loader_check(os.path.join(tmp, plt)) for name, plt in (
        ("grad_curvature", "plt_prod"), ("stream", "plt_prod_stream"),
        ("stats", "plt_stats_production"))}
    emit({"phase": "host_io", "tolerance": "bitwise",
          "loader_threads": native.loader_threads(),
          "cpus": len(os.sched_getaffinity(0)), "plotfiles": out,
          "nan_casts": nan_casts(dev)})


# -- phase 12 -------------------------------------------------------------------
# the JAX bench's sec_sparse512 case (bench.py:796, testing.py:133): 128^3
# level 0, ratio 4, 16 scattered 32^3 patches on a 512^3 finest index space
SPARSE_PARITY = dict(n0=128, ratio=4, n_clusters=16, fine_box=32)
# 16.8 M coarse + 16.8 M fine cells on a 1024^3 finest index space
SPARSE_SCALE = dict(n0=256, ratio=4, n_clusters=64, fine_box=64)
SPARSE_ISO = 1050.0
SPARSE_CM = ["binComp=temp", "avgComps=density", "nBins=64", "binMin=300",
             "binMax=1801", "writeBinMinMax=1"]
SPARSE_JPDF = ["vars=temp density x_velocity", "nBins=64",
               "output_gnuplot=1", "output_plotfile=0"]


def sparse_fields():
    """temp crosses 1050 K in every patch of the 4^3 lattice (period 1/4);
    the velocities and density of testing.default_fields."""
    f = default_fields()
    return {"temp": lambda x, y, z: 300 + 750 * (
        1 + np.cos(8 * np.pi * x) * np.cos(8 * np.pi * y)
        * np.cos(8 * np.pi * z)),
        "density": f["density"], "x_velocity": f["x_velocity"],
        "y_velocity": f["y_velocity"], "z_velocity": f["z_velocity"]}


def sparse_seeds(meta, per_box: int, n_coarse: int) -> np.ndarray:
    """per_box seeds inside each finest box, n_coarse anywhere."""
    rng = np.random.default_rng(11)
    dx = np.array(meta.geoms[-1].dx)
    pts = [rng.random((n_coarse, 3))]
    for b in meta.bas[-1]:
        lo, hi = np.array(b.lo) * dx + dx, (np.array(b.hi) + 1) * dx - dx
        pts.append(lo + (hi - lo) * rng.random((per_box, 3)))
    return np.concatenate(pts)


def run_wall(tool: str, args) -> float:
    t0 = time.perf_counter()
    if cli.main([tool, *args]) != 0:
        raise RuntimeError(f"{tool} {args} failed")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def same_plotfile(a: str, b: str) -> dict:
    """Every FAB of two plotfiles equal, NaN equal to NaN (the CPU tests'
    float32 tolerance between the clustered and the dense path)."""
    ra, rb = PlotfileReader(a), PlotfileReader(b)
    if ra.var_names != rb.var_names or ra.meta.n_levels != rb.meta.n_levels:
        raise AssertionError(f"{a} and {b} differ in layout")
    cells = 0
    for lev in range(ra.meta.n_levels):
        for fa, fb in zip(ra.read_level(lev), rb.read_level(lev)):
            if not np.array_equal(fa, fb, equal_nan=True):
                raise AssertionError(f"{a} and {b} differ on level {lev}: "
                                     f"{np.nanmax(np.abs(fa - fb))}")
            cells += fa[0].size
    return {"cells": cells, "equal": True}


def close_scaled(a: np.ndarray, b: np.ndarray, what: str) -> float:
    """Within 1e-12 of each column's largest value (at least 1)."""
    scale = np.maximum(np.abs(b).reshape(-1, b.shape[-1]).max(axis=0), 1.0)
    err = float((np.abs(a - b) / scale).max(initial=0.0))
    if not err <= 1e-12:
        raise AssertionError(f"{what}: {err} of the column scale")
    return err


def canon(m: MEF):
    n = np.round(m.nodes, 9)
    order = np.lexsort(n.T[::-1])
    rank = np.empty(len(n), np.int64)
    rank[order] = np.arange(len(n))
    tris = np.sort(rank[m.elements], axis=1)
    return m.nodes[order], tris[np.lexsort(tris.T[::-1])]


def same_surface(a: str, b: str) -> dict:
    (na, ta), (nb, tb) = canon(read_mef(a)), canon(read_mef(b))
    if not np.array_equal(ta, tb):
        raise AssertionError(f"{a} and {b}: element sets differ")
    err = close_scaled(na, nb, f"{a} nodes")
    if not (na[:, 3] == SPARSE_ISO).all():
        raise AssertionError(f"{a}: iso column is not {SPARSE_ISO}")
    return {"nodes": len(na), "elements": len(ta), "max_err": err}


def same_lines(a: str, b: str) -> dict:
    la, lb = read_stream_data(a), read_stream_data(b)
    if la.names != lb.names or not np.isfinite(la.lines).all():
        raise AssertionError(f"{a} and {b}: names or non-finite lines")
    return {"lines": la.n_lines, "max_err": close_scaled(la.lines, lb.lines,
                                                         a)}


def same_stats(a: str, b: str, hits_col=None) -> dict:
    x, y = np.loadtxt(a, skiprows=2 if hits_col else 0), np.loadtxt(
        b, skiprows=2 if hits_col else 0)
    np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-12, err_msg=a)
    if hits_col is not None and not np.array_equal(x[:, hits_col],
                                                   y[:, hits_col]):
        raise AssertionError(f"{a}: hits differ")
    # empty bins hold +-inf min/max columns, equal in both files
    fin = np.isfinite(y)
    err = np.abs(x[fin] - y[fin]) / np.maximum(np.abs(y[fin]), 1e-300)
    return {"max_rel_err": float(err.max(initial=0.0))}


def same_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| where neither is NaN."""
    d = (a.double() - b.double()).abs()
    return float(torch.where(d.isnan(), 0.0, d).max()) if d.numel() else 0.0


class HeldAgainstPlain:
    """Within the block, every call a tool makes of a kernel's wrapper
    (grad_mag, march, the order key, binned_moments, joint_hist) is followed
    by the plain version on the same inputs, and the kernel's output is held
    to the tolerance of phases 3, 3b and 3c: gradients bitwise and the
    magnitude within 1 ulp; march positions, alive flags and order keys
    bitwise; stats hits and min/max equal, sums within STATS_RTOL of the
    largest value.  The names are replaced where the tools look them up,
    so the checks see the shapes the sparse paths give the kernels (cluster
    substates, the coarse pass, one histogram a part).  ``seen`` keeps, per
    kernel, the calls, their distinct input shapes and the largest error."""

    def __init__(self):
        from peleanalysis_tpu_torch.ops import stats as ops_stats
        from peleanalysis_tpu_torch.parallel import particles
        from peleanalysis_tpu_torch.stream import trace
        from peleanalysis_tpu_torch.tools import (curvature, grad,
                                                  turbulence_post)
        self.sites = [(m, "grad_mag", "grad_mag", gk.grad_mag_torch,
                       self._grad)
                      for m in (grad, curvature, trace, turbulence_post)]
        self.sites += [
            (trace, "march", "stream_march", mk.march_torch, self._march),
            (particles, "march", "stream_march", mk.march_torch,
             self._march),
            (mk, "order_key", "stream_march_order_key", mk.order_key_torch,
             self._key),
            (ops_stats, "binned_moments", "stats_binned",
             sk.binned_moments_torch, self._stats),
            (ops_stats, "joint_hist", "stats_joint", sk.joint_hist_torch,
             self._stats)]
        self.seen = defaultdict(lambda: {"calls": 0, "shapes": set(),
                                         "max_abs_err": 0.0})
        self._saved = []

    @staticmethod
    def _grad(k, p, args):
        if not same_nan(k[:3], p[:3]):
            raise AssertionError("gradient differs from plain")
        ulps = ulp_diff(k[3], p[3]) if k.shape[0] == 4 else 0
        if ulps > 1:
            raise AssertionError(f"magnitude {ulps} ulp off")
        return abs_err(k, p), tuple(args[0].shape)

    @staticmethod
    def _march(k, p, args):
        if not (same_nan(k[0], p[0]) and torch.equal(k[1], p[1])):
            raise AssertionError("march differs from plain")
        return abs_err(k[0], p[0]), (tuple(args[0].shape), args[4].shape[0])

    @staticmethod
    def _key(k, p, args):
        if not torch.equal(k, p):
            raise AssertionError("order key differs from plain")
        return 0.0, (tuple(args[0]), args[3].shape[0])

    @staticmethod
    def _stats(k, p, args):
        vals = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
        err, _ = check_stats(k, p, vals[0].dtype, "sparse part")
        return err, tuple(vals[0].shape)

    def __enter__(self):
        for mod, attr, name, plain, check in self.sites:
            real = getattr(mod, attr)
            self._saved.append((mod, attr, real))

            def held(*args, _real=real, _plain=plain, _check=check,
                     _name=name, **kw):
                k = _real(*args, **kw)
                p = _plain(*args, **kw)
                try:
                    err, shape = _check(k, p, args)
                except AssertionError as e:
                    raise AssertionError(f"{_name}, sparse path: {e}") from e
                s = self.seen[_name]
                s["calls"] += 1
                s["shapes"].add(shape)
                s["max_abs_err"] = max(s["max_abs_err"], err)
                return k
            setattr(mod, attr, held)
        return self

    def __exit__(self, *exc):
        for mod, attr, real in reversed(self._saved):
            setattr(mod, attr, real)
        self._saved = []
        return False

    def report(self) -> dict:
        return {k: {"calls": v["calls"], "max_abs_err": v["max_abs_err"],
                    "shapes": sorted(str(s) for s in v["shapes"])[:8],
                    "n_shapes": len(v["shapes"])}
                for k, v in self.seen.items()}


def sparse_kernels_vs_plain(tool_runs) -> dict:
    """Each (tool, args) clustered run once more under HeldAgainstPlain;
    fails unless every kernel of counts() was held at least once."""
    with HeldAgainstPlain() as held:
        for tool, args in tool_runs:
            if cli.main([tool, *args]) != 0:
                raise RuntimeError(f"{tool} {args} failed")
    missing = [k for k in counts() if held.seen[k]["calls"] == 0]
    if missing:
        raise AssertionError(f"sparse runs held no call of {missing}")
    return held.report()


def phase_sparse(tmp: str) -> dict:
    """Every ported tool on the sparse parity case, clustered and with
    force_dense=1: outputs equal, walls, peak memory, kernel launches;
    each kernel held against its plain version at the clustered runs'
    shapes."""
    t0 = time.perf_counter()
    plt = os.path.join(tmp, "plt_sparse")
    meta = write_scattered_plotfile(plt, fields=sparse_fields(),
                                    **SPARSE_PARITY)[0]
    fin = meta.n_levels - 1
    n_cl = len(cluster_boxes(meta.bas[fin]))
    mef = os.path.join(tmp, "seeds_sparse.mef")
    seeds = sparse_seeds(meta, 1000, 4000)
    write_mef(mef, MEF("0", ["X", "Y", "Z"], seeds,
                       np.zeros((0, 3), np.int32)))
    out = lambda name, mode: os.path.join(tmp, f"sp_{name}_{mode}")  # noqa
    runs = {
        "grad": lambda m: ("grad", [f"infile={plt}", "gradVar=temp",
                                    f"outfile={out('grad', m)}"]),
        "curvature": lambda m: ("curvature", [
            f"infile={plt}", "progressName=temp",
            f"outfile={out('curvature', m)}"]),
        "isosurface": lambda m: ("isosurface", [
            f"infile={plt}", "isoCompName=temp", f"isoVal={SPARSE_ISO}",
            "comps=density", f"outfile_base={out('isosurface', m)}"]),
        "stream": lambda m: ("stream", [
            f"plotfile={plt}", "progressName=temp", f"isoFile={mef}",
            *STREAM_KEYS, "aux_comps=density",
            f"streamFile={out('stream', m)}"]),
        "sampleStreamlines": lambda m: ("sampleStreamlines", [
            f"plotfile={plt}", f"pathFile={out('stream', 'clustered')}",
            "comps=density temp",
            f"streamSampleFile={out('sampleStreamlines', m)}"]),
        "conditionalMean": lambda m: ("conditionalMean", [
            f"infile={plt}", *SPARSE_CM, "dtype=float64",
            f"outfile={out('conditionalMean', m)}"]),
        "jpdf": lambda m: ("jpdf", [f"infile={plt}", *SPARSE_JPDF,
                                    "dtype=float64", f"outSuffix=_{m}"]),
    }
    # kernel launches of each clustered run: one gradient a level in the
    # coarse pass and one a cluster (grad), 7 (curvature: 7 the coarse
    # pass's level, 14 a cluster's two levels); one histogram a part
    expect = {"grad": (1 + n_cl,), "curvature": (7 + 14 * n_cl,),
              "isosurface": (), "sampleStreamlines": (),
              "stream": (1 + n_cl, 1 + n_cl, 1 + n_cl),
              "conditionalMean": (0, 0, 0, 1 + n_cl),
              "jpdf": (0, 0, 0, 0, 1 + n_cl)}
    tools, launches = {}, {}
    for name, args in runs.items():
        res = {}
        for mode, extra in (("clustered", []), ("dense", ["force_dense=1"])):
            tool, a = args(mode)
            if mode == "clustered":
                # the sparse path's run: counts set to 0 just before, read
                # just after
                reset_counts()
                cold = run_tool_counted(tool, [*a, *extra], expect[name])
                launches[name] = counts()
            else:
                cold = run_wall(tool, [*a, *extra])
            torch.cuda.reset_peak_memory_stats()
            warm = run_wall(tool, [*a, *extra])
            res[mode] = {"cold_s": cold, "warm_s": warm,
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated()}
        tools[name] = res
    o = lambda name: (out(name, "clustered"), out(name, "dense"))  # noqa
    parity = {
        "grad": same_plotfile(*o("grad")),
        "curvature": same_plotfile(*o("curvature")),
        "isosurface": same_surface(*(p + ".mef" for p in o("isosurface"))),
        "stream": same_lines(*o("stream")),
        "sampleStreamlines": same_lines(*o("sampleStreamlines")),
        "conditionalMean": same_stats(*o("conditionalMean"), hits_col=-2)}
    for a, b in (("temp", "density"), ("temp", "x_velocity"),
                 ("density", "x_velocity")):
        parity[f"jpdf_{a}_{b}"] = same_stats(
            *(os.path.join(plt + f"_{m}", f"Pdf_{a}_{b}.gpd")
              for m in ("clustered", "dense")))
    tool, a = runs["grad"]("clustered")
    copies = d2h_copies(lambda: cli.main([tool, *a]))
    if copies != fin + n_cl:
        raise AssertionError(f"clustered grad: {copies} device-to-host "
                             f"copies, expected {fin + n_cl}")
    held = sparse_kernels_vs_plain(
        [runs[name]("clustered") for name in (
            "grad", "curvature", "stream", "conditionalMean", "jpdf")])
    bbox = meta.bas[fin].minimal_box()
    emit({"phase": "sparse_parity", "case": SPARSE_PARITY,
          "clusters": n_cl, "finest_cells": meta.bas[fin].total_cells(),
          "finest_bbox_cells": bbox.size, "seeds": len(seeds),
          "tolerance": "plotfiles equal (NaN = NaN); MEFs by canonical "
          "node and element sets, nodes, lines and samples within 1e-12 "
          "of each column's scale; stats rtol 1e-9, hits equal",
          "tools": tools, "launches": launches, "parity": parity,
          "grad_d2h_copies": copies,
          "kernels_vs_plain": {"tolerance": "as phases 3, 3b and 3c",
                               "calls": held},
          "seconds": time.perf_counter() - t0})
    return ({k: sum(v[k] for v in launches.values()) for k in counts()},
            {k: v["max_abs_err"] for k, v in held.items()})


def sparse_split(plt: str, tool: str, dev) -> dict:
    """One clustered run of grad, curvature or isosurface taken apart (host
    clock, each step ending in a synchronize): read and coarse assembly,
    the coarse pass (compute, then its levels packed and copied), the
    clusters (build, compute, pack and copy, one after another) and the
    file write, or for the isosurface the merge of the runs by node key."""
    t0 = time.perf_counter()
    names = ["temp"] if tool != "isosurface" else ["temp", "density"]
    dt = torch.float64 if tool == "isosurface" else torch.float32
    meta, names, fabs = load_plotfile_fabs(plt, names)
    base = DenseAmrState.coarse_only(meta, names, fabs, dev, dt)
    fin = meta.n_levels - 1
    groups, subs = cluster_substates(base, fabs[fin])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if tool == "isosurface":
        comps = [base.comp(n) for n in names]
        coarse_ds = coarse_only_state(base)
        mc._share_coarse_inputs(coarse_ds, base, comps, range(fin))
        results = [mc.extract_isosurface_enum(
            coarse_ds, "temp", SPARSE_ISO, ["density"], want_eids=True)]
        t2 = t3 = time.perf_counter()
        for sub in subs:
            mc._share_coarse_inputs(sub, base, comps, range(fin))
            results.append(mc.extract_isosurface_enum(
                sub, "temp", SPARSE_ISO, ["density"], emit_levels=(fin,),
                want_eids=True))
            del sub
        t4 = time.perf_counter()
        mef = mc._merge_runs(results)
        t5 = time.perf_counter()
        extra = {"nodes": mef.n_nodes, "merge_s": t5 - t4,
                 "keys": sum(len(k) for _, k in results)}
    else:
        if tool == "grad":
            run = lambda ds, **kw: compute_grad_dense(  # noqa: E731
                ds, "temp", interp="quadratic", **kw)
            kw_fin = {"levels": (fin,)}
        else:
            lo, hi = 300.0, 1800.0
            run = lambda ds, **kw: compute_curvature_dense(  # noqa: E731
                ds, "temp", prog_min=lo, prog_max=hi, use_file_minmax=False,
                interp="quadratic")
            kw_fin = {}
        coarse = run(coarse_only_state(base))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rec = PlotfileRecords(meta, coarse.names)
        for lev in range(fin):
            rec.add(lev, coarse.data[lev], coarse.lmeta[lev].bbox,
                    range(len(meta.bas[lev])))
        del coarse
        t3 = time.perf_counter()
        for g, sub in zip(groups, subs):
            res = run(sub, **kw_fin)
            rec.add(fin, res.data[fin], res.lmeta[fin].bbox, g)
            del sub, res
        t4 = time.perf_counter()
        path = os.path.join(os.path.dirname(plt), f"split_sparse_{tool}")
        rec.write(path)
        t5 = time.perf_counter()
        shutil.rmtree(path)
        extra = {"write_s": t5 - t4}
    return {"read_and_assembly_s": t1 - t0, "coarse_compute_s": t2 - t1,
            "coarse_pack_s": t3 - t2, "clusters_s": t4 - t3,
            "per_cluster_s": (t4 - t3) / len(groups), **extra}


def phase_sparse_scale(tmp: str, dev) -> float:
    """The scale case through clustered grad, curvature and isosurface:
    walls, peak device memory, the coarse pass against the clusters, and
    the finest union bbox that force_dense=1 would allocate (from the
    meta; not run)."""
    t0 = time.perf_counter()
    plt = os.path.join(tmp, "plt_sparse_scale")
    meta = write_scattered_plotfile(plt, fields=sparse_fields(),
                                    **SPARSE_SCALE)[0]
    gen_s = time.perf_counter() - t0
    fin = meta.n_levels - 1
    n_cl = len(cluster_boxes(meta.bas[fin]))
    runs = {"grad": (["grad", f"infile={plt}", "gradVar=temp",
                      f"outfile={plt}_gt"], (1 + n_cl,)),
            "curvature": (["curvature", f"infile={plt}", "progressName=temp",
                           f"outfile={plt}_K"], (7 + 14 * n_cl,)),
            "isosurface": (["isosurface", f"infile={plt}",
                            "isoCompName=temp", f"isoVal={SPARSE_ISO}",
                            "comps=density", f"outfile_base={plt}_iso"],
                           ())}
    tools = {}
    for name, ((tool, *a), exp) in runs.items():
        cold = run_tool_counted(tool, a, exp)
        torch.cuda.reset_peak_memory_stats()
        warm = run_tool_counted(tool, a, exp)
        tools[name] = {"cold_s": cold, "warm_s": warm,
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated(),
                       "split": sparse_split(plt, name, dev)}
    # the gradient kernel at the scale clusters' shapes (64 x 64 x 832
    # columns) and the 256^3 coarse pass
    with HeldAgainstPlain() as held:
        for name in ("grad", "curvature"):
            tool, *a = runs[name][0]
            if cli.main([tool, *a]) != 0:
                raise RuntimeError(f"{tool} failed")
    if held.seen["grad_mag"]["calls"] != 1 + n_cl + 7 + 14 * n_cl:
        raise AssertionError(f"scale: {held.seen['grad_mag']['calls']} "
                             "grad_mag calls held")
    m = read_mef(plt + "_iso.mef")
    if not (m.n_elts > 0 and np.isfinite(m.nodes).all()):
        raise AssertionError("scale isosurface empty or non-finite")
    ds = DenseAmrState.from_plotfile(plt + "_gt", "cpu", names=[
        "||gradtemp||"], dtype=torch.float64, max_level=0)
    if not torch.isfinite(ds.data[0]).all():
        raise AssertionError("scale grad: non-finite level 0")
    bbox = meta.bas[fin].minimal_box()
    coarse_cells = meta.bas[0].total_cells()
    emit({"phase": "sparse_scale", "case": SPARSE_SCALE, "clusters": n_cl,
          "coarse_cells": coarse_cells,
          "finest_cells": meta.bas[fin].total_cells(),
          "plotfile_bytes": sum(os.path.getsize(os.path.join(d, f))
                                for d, _, fs in os.walk(plt) for f in fs),
          "generate_and_write_s": gen_s, "tools": tools,
          "iso_nodes": m.n_nodes, "iso_elements": m.n_elts,
          "force_dense_avoided": {
              "finest_bbox": list(bbox.shape), "cells": bbox.size,
              "bytes_per_float32_component": 4 * bbox.size,
              "bytes_per_float64_component": 8 * bbox.size,
              "grad_float32_in_out_bytes": 4 * bbox.size * (1 + 5),
              "isosurface_float64_input_bytes": 8 * bbox.size * (3 + 2)},
          "coarse_level_bytes_float32": 4 * coarse_cells,
          "kernels_vs_plain": {"tolerance": "as phase 3",
                               "calls": held.report()},
          "seconds": time.perf_counter() - t0})
    return held.seen["grad_mag"]["max_abs_err"]


# -- phase 13 -------------------------------------------------------------------
# HIT: one periodic 256^3 level of testing.hit_fields in 64^3 boxes (16.8 M
# cells, 671 MB a float64 plotfile); its card-vs-CPU twin at 64^3
HIT_CASE = dict(n_cell=256, max_grid_size=64)
HIT_CPU_CASE = dict(n_cell=64, max_grid_size=32)
PART_KEYS = ["Nsteps=51", "hRK=0.5"]
PROD_SEEDS = (256, 510)            # the 130,052-node sphere MEF of phase 5b
TOOLS8_NAMES = ["temp", "density", "x_velocity", "y_velocity", "z_velocity"]


class Split:
    """Within the block, the host-clock time the tools spend reading (the
    plotfile load and the dense assembly with its copy to the card, MEF,
    point and npz reads) and writing (plotfile packing and files, Tecplot,
    StreamData, particle, image, FAB, npz, flt and text writers), each call
    ending in a synchronize; the names are replaced where the tools look
    them up.  ``take()`` returns the times since the last take."""

    READS = ("load_plotfile_fabs", "read_points", "_level_values",
             "read_mef", "read_npz", "read_mef_tecplot", "read_stream_data",
             "assemble_level")
    WRITES = ("write_tecplot_lines", "write_part_file", "write_stream_data",
              "write_plotfile", "write_dat_1d", "write_dat_2d", "write_ppm",
              "write_pgm", "write_fab", "write_samples", "write_tec_febrick",
              "write_flt", "write_mef", "savetxt_fast", "write_mef_tecplot")

    def __init__(self):
        from peleanalysis_tpu_torch import session
        from peleanalysis_tpu_torch.amr import cluster, dense
        from peleanalysis_tpu_torch.tools import (
            amr_to_fe, avg_plotfiles, avg_to_plane, build_distance,
            build_pmf, chem_tools, combine_plts, compare_plts, filter_plt,
            flatten_amr, integral, interp, isosurface, mef_tools,
            part_stream, plt2npz, regrid_plt, rms_vel, sco2, slice_plot,
            stream2plt, stream_scatter, stream_sub, stream_tube_stats,
            sub_plt, template, turbulence_post, turbulence_spectra)
        self.mods = [session, dense, filter_plt, flatten_amr, integral,
                     part_stream, rms_vel, turbulence_post,
                     turbulence_spectra, amr_to_fe,
                     avg_plotfiles, avg_to_plane, build_distance,
                     combine_plts, compare_plts, interp, isosurface,
                     plt2npz, regrid_plt, slice_plot, sub_plt, template,
                     mef_tools, stream2plt, stream_scatter, stream_sub,
                     stream_tube_stats, cluster, chem_tools, sco2, build_pmf]
        self.t = {"read": 0.0, "write": 0.0}
        self._depth = 0
        self._saved = []

    def _wrap(self, kind, fn):
        def timed(*a, **k):
            # a series tool's read-ahead thread reads while the main thread
            # computes: only the main thread's reads and writes are timed
            if self._depth or threading.current_thread() is not \
                    threading.main_thread():
                return fn(*a, **k)
            self._depth += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                self.t[kind] += time.perf_counter() - t0
                self._depth -= 1
        return timed

    def __enter__(self):
        for mod in self.mods:
            for kind, names in (("read", self.READS), ("write", self.WRITES)):
                for name in names:
                    if hasattr(mod, name):
                        real = getattr(mod, name)
                        self._saved.append((mod, name, real))
                        setattr(mod, name, self._wrap(kind, real))
        assemble = DenseAmrState.__dict__["from_level_fabs"]
        self._saved.append((DenseAmrState, "from_level_fabs", assemble))
        DenseAmrState.from_level_fabs = classmethod(self._wrap(
            "read", assemble.__func__))
        # the plotfile writers (PlotfileRecords.add packs a part on the
        # card and copies it to the host), the archives of plt2npz/npz2plt
        for owner, name, kind in ((DenseAmrState, "to_plotfile", "write"),
                                  (PlotfileRecords, "add", "write"),
                                  (PlotfileRecords, "write", "write"),
                                  (np, "savez_compressed", "write"),
                                  (np, "save", "write"),
                                  (np, "savetxt", "write")):
            real = getattr(owner, name)
            self._saved.append((owner, name, real))
            setattr(owner, name, self._wrap(kind, real))
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self._saved):
            setattr(mod, name, real)
        self._saved = []
        return False

    def take(self) -> dict:
        out = {f"{k}_s": v for k, v in self.t.items()}
        self.t = {"read": 0.0, "write": 0.0}
        return out


def tool_cost(tool: str, args, profile: bool) -> dict:
    """One warm CLI run split into read, write and the rest (host clock,
    each part ending in a synchronize; the rest is the device compute with
    the host work between its launches), its peak device memory; with
    ``profile``, one more run under torch.profiler (``kernel_profile``)
    for the device time of its kernels, copies and memsets, the copies'
    part, and whether the trace held the run whole."""
    torch.cuda.reset_peak_memory_stats()
    with Split() as split:
        wall = run_wall(tool, args)
    out = {"warm_s": wall, **split.take(),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    out["compute_s"] = wall - out["read_s"] - out["write_s"]
    if profile:
        prof = kernel_profile(lambda: cli.main([tool, *args]))
        out.update({k: prof[k] for k in ("device_ms", "copy_ms", "kernels",
                                         "trace_whole")})
        out["profiled_wall_ms"] = prof["wall_ms"]
    return out


def close_plotfiles(a: str, b: str, rtol: float) -> float:
    """Two plotfiles of the same layout, each component within rtol of its
    largest value; returns the largest error over that value."""
    ra, rb = PlotfileReader(a), PlotfileReader(b)
    if ra.var_names != rb.var_names or ra.meta.n_levels != rb.meta.n_levels:
        raise AssertionError(f"{a} and {b} differ in layout")
    worst = 0.0
    for lev in range(ra.meta.n_levels):
        fa, fb = ra.read_level(lev), rb.read_level(lev)
        for c in range(len(ra.var_names)):
            x = np.concatenate([f[c].ravel() for f in fa])
            y = np.concatenate([f[c].ravel() for f in fb])
            err = float(np.abs(x - y).max()) / max(float(np.abs(y).max()),
                                                   1e-300)
            if not err <= rtol:
                raise AssertionError(f"{a} vs {b}: {ra.var_names[c]} level "
                                     f"{lev} {err} of its largest value")
            worst = max(worst, err)
    return worst


def hit_checks(root: str, tag: str, n: int, spectra_base: str,
               aug: str, avg_temp: float) -> dict:
    """The closed forms of testing.hit_fields on an n^3 run: tseries
    kin_energy_adim 0.5, magvort^2 with the centred difference's
    (sin kh / kh)^2 at kh = 2 pi / n, divu^2 < 1e-12, <T'^2> = 50; the
    slice's kin_energy line; the augmented plotfile's <|w|^2> and divu;
    the spectrum's energy 0.75 all in shell 1 (Parseval); varfieldAverage's
    mass-weighted temp ``avg_temp`` 300 (constant density)."""
    lines = open(os.path.join(root, "tseries.csv")).read().splitlines()
    vals = dict(zip(["tau"] + lines[0].split(",")[1:],
                    map(float, lines[1].split(","))))
    kh = 2 * np.pi / n
    w2 = 3 * (2 * np.pi) ** 2 * 0.5 * (np.sin(kh) / kh) ** 2
    errs = {"kin_energy_adim": abs(vals["kin_energy_avg_adim"] - 0.5),
            "magvort_rel": abs(vals["magvort_sq_avg_adim"] - w2 / 4)
            / (w2 / 4),
            "divu_sq_adim": vals["divu_sq_avg_adim"],
            "temp_var_adim": abs(vals["temp_var_sq_avg_adim"] - 50 / 1.44)}
    if not (errs["kin_energy_adim"] < 1e-9 and errs["magvort_rel"] < 1e-9
            and errs["divu_sq_adim"] < 1e-12
            and errs["temp_var_adim"] < 1e-6):
        raise AssertionError(f"HIT tseries off its closed forms: {errs}")
    with open(os.path.join(root, f"{tag}_slice.dat")) as fh:
        rows = [ln for ln in fh.read().splitlines()
                if ln and not ln.startswith("#")][:n]
    sl = np.array([[float(v) for v in ln.split()] for ln in rows])
    x = sl[:, 0]
    y = z = (n // 2 + 0.5) / n
    ke = (np.sin(2 * np.pi * y) ** 2 + np.sin(2 * np.pi * z) ** 2
          + np.sin(2 * np.pi * x) ** 2) / 3
    errs["slice_kin_energy"] = float(np.abs(sl[:, 4] - ke).max())
    r = PlotfileReader(aug)
    f = np.concatenate([b.reshape(b.shape[0], -1) for b in r.read_level(0)],
                       axis=1)
    im, idv = r.var_names.index("magvort"), r.var_names.index("divu")
    errs["aug_magvort_rel"] = abs(float((f[im] ** 2).mean()) - w2) / w2
    errs["aug_divu"] = float(np.abs(f[idv]).max())
    E = np.loadtxt(f"{spectra_base}_{tag}_spectrum.dat")[:, 1]
    errs["spectrum_parseval"] = abs(float(E.sum()) - 0.75)
    errs["spectrum_off_shell_1"] = float(E.sum() - E[1]) / float(E.sum())
    errs["varfield_avg_temp"] = abs(avg_temp - 300.0)
    if not (errs["slice_kin_energy"] < 1e-7 and errs["aug_magvort_rel"]
            < 1e-9 and errs["aug_divu"] < 1e-12
            and errs["spectrum_parseval"] < 1e-9
            and errs["spectrum_off_shell_1"] < 1e-12
            and errs["varfield_avg_temp"] < 1e-9):
        raise AssertionError(f"HIT outputs off their closed forms: {errs}")
    return errs


def hit_runs(root: str, dev: str, base: str):
    """The four turbulence_post verbs and turbulenceSpectra on a HIT run
    directory (two plotfiles): (tool, args, expected launches) in order."""
    plts = [os.path.join(root, p) for p in ("plt00000", "plt00001")]
    d = [f"device={dev}"]
    return [("turbulenceTseries", [f"root_dir={root}", *d], (6,)),
            ("turbulenceSlice", [f"root_dir={root}", "plotfile=plt00001", *d],
             (3,)),
            ("augmentPlotfile", [f"infile={plts[1]}",
                                 f"outfile={plts[1]}_aug", *d], (3,)),
            ("varfieldAverage", [f"plotfile={plts[1]}", "var=temp", *d], ()),
            ("turbulenceSpectra", [f"infile={' '.join(plts)}",
                                   f"outfile_base={base}", *d], ())]


def tools8_runs(plt: str, mef: str, tmp: str, dev: str) -> dict:
    """The production runs of partStream, integral, rmsVel and filterPlt:
    name -> (tool, args, expected launches)."""
    d = [f"device={dev}"]
    o = lambda name: os.path.join(tmp, f"t8_{name}")  # noqa: E731
    integ = [f"infile={plt}", "vars=temp density", *d]
    return {
        "partStream_mef": ("partStream", [
            f"infile={plt}", f"isoFile={mef}", *PART_KEYS,
            f"outFile={o('ps.dat')}", f"streamFile={o('ps_sd')}",
            f"partFile={o('ps_parts')}", *d], (0, 1, 1)),
        "partStream_cells": ("partStream", [
            f"infile={plt}", "oneSeedPerCell=1", "seedStride=64", *PART_KEYS,
            f"outFile={o('cells.dat')}", *d], (0, 1, 1)),
        "integral_1d_ppm": ("integral", [
            *integ, "integralDimension=1", "dir=2", "format=ppm",
            f"outfile_base={o('int1')}"], ()),
        "integral_2d": ("integral", [
            *integ, "integralDimension=2", "dir1=0", "dir2=1",
            f"outfile_base={o('int2')}"], ()),
        "integral_3d": ("integral", [
            *integ, "integralDimension=3", f"outfile_base={o('int3')}"], ()),
        "integral_3d_cVar": ("integral", [
            *integ, "integralDimension=3", "cVar=temp", "cMin=500",
            "cMax=1500", "avg=1", f"outfile_base={o('int3c')}"], ()),
        "rmsVel": ("rmsVel", [f"infile={plt} {plt} {plt}",
                              f"outfile={o('rms.dat')}", *d], ()),
        "filterPlt_box": ("filterPlt", [
            f"infile={plt}", "vars=temp density", "filter_type=box",
            f"outfile={o('filt_box')}", *d], ()),
        "filterPlt_gaussian": ("filterPlt", [
            f"infile={plt}", "vars=temp density", "filter_type=gaussian",
            f"outfile={o('filt_gauss')}", *d], ())}


def tools8_card_vs_cpu(tmp: str, stream: dict, dev) -> dict:
    """Each new verb on the card and with device=cpu at the repo case (and
    the HIT tools on a 64^3 run): float64 plotfiles, lines, particle files
    and tseries within 1e-12, the slice's %.9g text within 1e-8, the %e
    text files (integral's three forms, rmsVel, the spectra and their
    stats) within 1e-6 (their 7 digits), images within one level and
    varfieldAverage's printed line equal; integrate_along, rms_velocity
    and varfield_average on card and CPU states within 1e-12."""
    from peleanalysis_tpu_torch.tools.integral import integrate_along
    from peleanalysis_tpu_torch.tools.rms_vel import rms_velocity
    from peleanalysis_tpu_torch.tools.turbulence_post import varfield_average
    plt, mef = stream["plt"], stream["mef"]
    out = {}
    o = lambda who, name: os.path.join(tmp, f"cc_{who}_{name}")  # noqa
    for who in ("card", "cpu"):
        d = "cuda" if who == "card" else "cpu"
        for tool, args in (
                ("partStream", [f"infile={plt}", f"isoFile={mef}", *PART_KEYS,
                                f"streamFile={o(who, 'sd')}",
                                f"partFile={o(who, 'parts')}",
                                f"outFile={o(who, 'ps.dat')}"]),
                ("integral", [f"infile={plt}", "vars=temp density",
                              "integralDimension=1", "dir=0", "format=ppm",
                              "dtype=float64",
                              f"outfile_base={o(who, 'int')}"]),
                ("integral", [f"infile={plt}", "vars=temp density",
                              "integralDimension=2", "dir1=0", "dir2=2",
                              "avg=1", "dtype=float64",
                              f"outfile_base={o(who, 'int2')}"]),
                ("integral", [f"infile={plt}", "vars=temp density",
                              "integralDimension=3", "cVar=progress",
                              "cMin=0.1", "cMax=0.9", "dtype=float64",
                              f"outfile_base={o(who, 'int3')}"]),
                ("rmsVel", [f"infile={plt} {plt}", "dtype=float64",
                            f"outfile={o(who, 'rms.dat')}"]),
                ("filterPlt", [f"infile={plt}", "vars=temp density",
                               "filter_type=gaussian", "dtype=float64",
                               f"outfile={o(who, 'filt')}"]),
                ("flattenAMRFile", [f"infile={plt}",
                                    f"outfile={o(who, 'flat')}"])):
            run_wall(tool, [*args, f"device={d}"])
    pos = float(np.abs(read_stream_data(o("card", "sd")).lines
                       - read_stream_data(o("cpu", "sd")).lines).max())
    if not pos <= 1e-12:
        raise AssertionError(f"partStream card vs CPU: {pos}")
    out["partStream_max_pos_err"] = pos
    (pa, ra, ia), (pb, rb, ib) = (read_particles(o(w, "parts"))
                                  for w in ("card", "cpu"))
    if list(ra) != list(rb) or list(ia) != list(ib) or pa.shape != pb.shape:
        raise AssertionError("partStream particle files differ in layout")
    perr = max([float(np.abs(pa - pb).max())]
               + [float(np.abs(ra[k] - rb[k]).max()) for k in ra])
    if not (perr <= 1e-12 and all(np.array_equal(ia[k], ib[k]) for k in ia)):
        raise AssertionError(f"partStream particles card vs CPU: {perr}")
    out["partFile_max_err"] = perr
    out["integral_text"] = max(
        compare_text_files(o("card", f), o("cpu", f), 1e-6)
        for f in ("int_x.dat", "int_y.dat", "int3.dat", "int2_x.dat",
                  "int2_temp.dat", "int2_density.dat"))
    for n in ("temp", "density"):
        a, b = (np.fromfile(o(w, f"int_{n}.ppm"), np.uint8)
                for w in ("card", "cpu"))
        if a.shape != b.shape or np.abs(a.astype(int) - b).max() > 1:
            raise AssertionError(f"integral ppm {n}: card vs CPU")
    out["rmsVel_text"] = compare_text_files(o("card", "rms.dat"),
                                            o("cpu", "rms.dat"), 1e-6)
    out["filterPlt"] = close_plotfiles(o("card", "filt"), o("cpu", "filt"),
                                       1e-12)
    out["flattenAMRFile"] = close_plotfiles(o("card", "flat"),
                                            o("cpu", "flat"), 1e-12)
    # the sums themselves, before the %e text
    states = {w: DenseAmrState.from_plotfile(plt, w, names=TOOLS8_NAMES
                                             + ["progress"],
                                             dtype=torch.float64)
              for w in (dev, "cpu")}
    worst = 0.0
    for dirs in ([0, 1, 2], [2], [0, 1]):
        a, b = (integrate_along(states[w], ["temp", "density"], dirs,
                                "progress", 0.1, 0.9, True)
                for w in (dev, "cpu"))
        for x, y in zip([a[1], *a[2]], [b[1], *b[2]]):
            worst = max(worst, float(np.abs(x - y).max())
                        / float(np.abs(y).max()))
    r_card, r_cpu = (rms_velocity(states[w]) for w in (dev, "cpu"))
    out["integrate_along_rel"] = worst
    out["rms_velocity_rel"] = abs(r_card - r_cpu) / r_cpu
    if not (worst <= 1e-12 and out["rms_velocity_rel"] <= 1e-12):
        raise AssertionError(f"integral/rmsVel card vs CPU: {out}")
    # the HIT tools on a 64^3 run, card then CPU
    hit = {}
    root = os.path.join(tmp, "hit_cpu")
    os.makedirs(root)
    write_hit_run(root, **HIT_CPU_CASE)
    printed, avg = {}, {}
    for who, d in (("card", "cuda"), ("cpu", "cpu")):
        for tool, args, _ in hit_runs(root, d, o(who, "turb")):
            if tool != "varfieldAverage":
                run_wall(tool, args)
                continue
            with contextlib.redirect_stdout(io.StringIO()) as said:
                run_wall(tool, args)
            printed[who] = said.getvalue()
            avg[who] = varfield_average(os.path.join(root, "plt00001"),
                                        "temp", dev if who == "card" else d)
        for f in ("tseries.csv", "plt00001_slice.dat"):
            shutil.copy(os.path.join(root, f), o(who, f))
        os.replace(os.path.join(root, "plt00001_aug"), o(who, "aug"))
    for who in ("card", "cpu"):          # the csv's numbers as words
        with open(o(who, "tseries.csv")) as fi, \
                open(o(who, "tseries.txt"), "w") as fo:
            fo.write(fi.read().replace(",", " "))
    hit["tseries"] = compare_text_files(o("card", "tseries.txt"),
                                        o("cpu", "tseries.txt"), 1e-12)
    hit["slice"] = compare_text_files(o("card", "plt00001_slice.dat"),
                                      o("cpu", "plt00001_slice.dat"), 1e-8)
    hit["augment"] = close_plotfiles(o("card", "aug"), o("cpu", "aug"),
                                     1e-12)
    hit["spectrum"] = max(compare_text_files(
        o("card", f"turb_plt0000{i}_spectrum.dat"),
        o("cpu", f"turb_plt0000{i}_spectrum.dat"), 1e-6) for i in (0, 1))
    hit["spectrum_stats"] = compare_text_files(o("card", "turb_stats.dat"),
                                               o("cpu", "turb_stats.dat"),
                                               1e-6)
    hit["varfield_average_rel"] = abs(avg["card"] - avg["cpu"]) / avg["cpu"]
    if not (hit["varfield_average_rel"] <= 1e-12
            and printed["card"] == printed["cpu"]
            and "Average temp" in printed["cpu"]):
        raise AssertionError(f"varfieldAverage card vs CPU: {avg} {printed}")
    hit["checks_64"] = hit_checks(root, "plt00001", HIT_CPU_CASE["n_cell"],
                                  o("cpu", "turb"), o("cpu", "aug"),
                                  avg["card"])
    out["hit_64"] = hit
    return out


def phase_tools8(tmp: str, stream: dict, dev) -> dict:
    """partStream, integral, rmsVel, filterPlt, flattenAMRFile and the
    turbulence tools on the card at full size: launches counted (counts
    set to 0 just before the cold runs, read just after), warm walls split
    into read / compute / write with peak device memory and device time,
    the closed forms of the HIT run, partStream against `stream
    traceAlongV=1`, card against CPU, and grad_mag and the march held
    against their plain versions at this phase's shapes."""
    t0 = time.perf_counter()
    plt = os.path.join(tmp, "plt_prod_tools")
    f = default_fields()
    bas = write_synthetic_plotfile(
        plt, fields={n: f[n] for n in TOOLS8_NAMES}, **PROD_CASE)[1]
    mef = os.path.join(tmp, "seeds_prod_tools.mef")
    n_seeds = write_seed_mef(mef, *PROD_SEEDS)
    root = os.path.join(tmp, "hit")
    os.makedirs(root)
    write_hit_run(root, **HIT_CASE)
    gen_s = time.perf_counter() - t0
    spectra = os.path.join(tmp, "t8_turb")
    runs = tools8_runs(plt, mef, tmp, "cuda")
    for tool, args, exp in hit_runs(root, "cuda", spectra):
        runs[f"hit_{tool}"] = (tool, args, exp)
    fin = os.path.join(tmp, "t8_flat")
    runs["flattenAMRFile"] = ("flattenAMRFile", [
        f"infile={stream['plt']}", f"outfile={fin}", "device=cuda"], ())
    runs["turbulenceSpectra_prod"] = ("turbulenceSpectra", [
        f"infile={plt}", f"outfile_base={os.path.join(tmp, 't8_prod')}",
        "device=cuda"], ())
    # this phase's runs: every count set to 0 just before, read just after
    reset_counts()
    cold = {k: run_tool_counted(*v) for k, v in runs.items()}
    launches = counts()
    tools = {}
    for k, (tool, args, _) in runs.items():
        # a profiled run of partStream and of the production spectrum only
        # (the other verbs' device times were cut to keep the script's
        # time; PERF.md keeps the numbers measured before)
        first = k in ("partStream_mef", "turbulenceSpectra_prod")
        tools[k] = {"cold_s": cold[k], **tool_cost(tool, args, first)}
    # checks of the production outputs
    lines = check_stream_data(os.path.join(tmp, "t8_ps_sd"), n_seeds,
                              ["X", "Y", "Z"])
    pos, reals, _ = read_particles(os.path.join(tmp, "t8_ps_parts"))
    if not (np.array_equal(pos, lines[:, -1])
            and np.array_equal(reals["path_050_z"], lines[:, 50, 2])):
        raise AssertionError("particle file differs from the lines")
    sd_v = os.path.join(tmp, "t8_stream_v")
    run_wall("stream", [f"plotfile={plt}", "traceAlongV=1", f"isoFile={mef}",
                        "nRKsteps=51", "hRK=0.5", f"streamFile={sd_v}"])
    if not np.array_equal(lines, read_stream_data(sd_v).lines[..., :3]):
        raise AssertionError("partStream lines differ from stream "
                             "traceAlongV=1")
    fin_cells = bas[-1].total_cells()
    with open(os.path.join(tmp, "t8_cells.dat"), "rb") as fh:
        zones = fh.read().count(b"ZONE ")
    if zones != len(range(0, fin_cells, 64)):
        raise AssertionError(f"oneSeedPerCell: {zones} lines")
    n_fin = REPO_CASE["n_cell"] * 2 ** (REPO_CASE["n_levels"] - 1)
    flat = PlotfileReader(fin)
    if flat.meta.n_levels != 1 or flat.box_array(0).total_cells() != \
            n_fin ** 3:
        raise AssertionError("flattenAMRFile: not one level of the finest "
                             "domain")
    n_fin = PROD_CASE["n_cell"] * 2 ** (PROD_CASE["n_levels"] - 1)
    sp = np.loadtxt(os.path.join(tmp, "t8_prod_plt_prod_tools_spectrum.dat"))
    if not (len(sp) == n_fin // 2 + 1 and np.isfinite(sp).all()):
        raise AssertionError("production spectrum: shape or non-finite")
    from peleanalysis_tpu_torch.tools.turbulence_post import varfield_average
    avg_temp = varfield_average(os.path.join(root, "plt00001"), "temp", dev)
    checks = {"hit_256": hit_checks(root, "plt00001", HIT_CASE["n_cell"],
                                    spectra,
                                    os.path.join(root, "plt00001_aug"),
                                    avg_temp),
              "partStream_vs_stream_traceAlongV": "bitwise",
              "oneSeedPerCell_lines": zones}
    for name in ("rms.dat", "int3.dat", "int3c.dat"):
        vals = np.loadtxt(os.path.join(tmp, "t8_" + name), ndmin=1)
        if not np.isfinite(vals).all():
            raise AssertionError(f"{name}: non-finite")
    for name in ("t8_filt_box", "t8_filt_gauss"):
        r = PlotfileReader(os.path.join(tmp, name))
        for lev in range(r.meta.n_levels):
            if not all(np.isfinite(b).all() for b in r.read_level(lev)):
                raise AssertionError(f"{name}: non-finite level {lev}")
    # grad_mag and the march at this phase's shapes: the HIT slice's
    # gradients (grown 258^3 float64) and the production partStream
    with HeldAgainstPlain() as held:
        for k in ("partStream_mef", "hit_turbulenceSlice"):
            tool, args, _ = runs[k]
            run_wall(tool, args)
    for k in ("grad_mag", "stream_march", "stream_march_order_key"):
        if held.seen[k]["calls"] == 0:
            raise AssertionError(f"tools8 held no call of {k}")
    for p in ("t8_ps.dat", "t8_cells.dat", "t8_ps_parts", "t8_filt_box",
              "t8_filt_gauss", "t8_flat", "t8_stream_v"):
        p = os.path.join(tmp, p)
        shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    shutil.rmtree(root)
    cmp = tools8_card_vs_cpu(tmp, stream, dev)
    emit({"phase": "tools8", "cases": {
        "production": PROD_CASE, "cells": sum(b.total_cells() for b in bas),
        "seeds": n_seeds, "hit": HIT_CASE, "hit_cpu": HIT_CPU_CASE},
        "generate_s": gen_s, "launches": launches, "tools": tools,
        "checks": checks, "card_vs_cpu": cmp,
        "kernels_vs_plain": {"tolerance": "as phases 3 and 3b",
                             "calls": held.report()},
        "seconds": time.perf_counter() - t0})
    return launches, {k: v["max_abs_err"] for k, v in held.report().items()}


# -- phase 14 -------------------------------------------------------------------
TOOLS84_EXTRA = (dict(refine_frac=0.25), dict(n_levels=2))
INTERP_POINTS = 1_000_000


def tools84_runs(plt, plt_q, plt_2l, mef, pts, repo, tmp) -> dict:
    """The production runs of the plotfile tools and buildDistance, and
    amrToFE's Tecplot text of the repo case ``repo``: name -> (tool, args),
    on the card."""
    d = ["device=cuda"]
    o = lambda name: os.path.join(tmp, f"t84_{name}")  # noqa: E731
    ens = f"infile={plt} {plt_q} {plt_2l}"
    n = PROD_CASE["n_cell"]
    n_fin = n * 2 ** (PROD_CASE["n_levels"] - 1)
    return {
        "avgPlotfiles_pc": ("avgPlotfiles", [ens, f"outfile={o('avg_pc')}",
                                             *d]),
        "avgPlotfiles_linear": ("avgPlotfiles", [
            ens, "interp_type=2", f"outfile={o('avg_lin')}", *d]),
        "subPlt": ("subPlt", [f"infile={plt}",
                              f"box={' '.join([str(n // 4)] * 3)} "
                              f"{' '.join([str(3 * n // 4 - 1)] * 3)}",
                              "comps=temp density", f"outfile={o('sub')}",
                              *d]),
        "combinePlts": ("combinePlts", [
            f"infile1={plt}", f"infile2={plt}", "comps1=temp density",
            "comps2=x_velocity", f"outfile={o('comb')}", *d]),
        "regridPlt": ("regridPlt", [f"infile={plt}", "max_grid_size=32",
                                    f"outfile={o('rg')}", *d]),
        "template": ("template", [f"infile={plt}", "vars=temp density",
                                  f"outfile={o('tmpl')}", *d]),
        "plt2npz_levels": ("plt2npz", [f"infile={plt}", "vars=temp",
                                       f"outfile={o('lev.npz')}", *d]),
        "plt2npz_flat": ("plt2npz", [f"infile={plt}", "vars=temp",
                                     "mode=flat", "finestLevel=1",
                                     f"outfile={o('flat.npz')}", *d]),
        "npz2plt": ("npz2plt", [f"infile={o('flat.npz')}",
                                f"outfile={o('rt')}", *d]),
        "fcompare": ("fcompare", [f"infile1={plt}", f"infile2={o('tmpl')}",
                                  "vars=temp density", *d]),
        "fextrema": ("fextrema", [f"infile={plt}", *d]),
        "slicePlot": ("slicePlot", [f"file={plt}", "varname=temp",
                                    "slicedir=2", f"sliceloc={n_fin // 2}",
                                    "outtype=image",
                                    f"outfile={o('slice.ppm')}", *d]),
        "avgToPlane": ("avgToPlane", [f"infile={plt}", "vars=temp density",
                                      "dir=2", f"outfile_base={o('plane')}",
                                      *d]),
        "interp": ("interp", [f"infile={plt}", "vars=temp density",
                              f"points={pts}", f"out={o('interp.dat')}",
                              *d]),
        "amrToFE_flt": ("amrToFE", [f"infile={plt}", "vars=temp",
                                    "outType=flt", f"outfile={o('fe.flt')}",
                                    *d]),
        "amrToFE_tec_repo": ("amrToFE", [f"infile={repo}", "vars=temp",
                                         f"outfile={o('fe.dat')}", *d]),
        "buildDistance": ("buildDistance", [f"infile={plt}",
                                            f"isoFile={mef}",
                                            f"outfile={o('dist')}", *d]),
        "isosurface_distance": ("isosurface", [
            f"infile={plt}", f"isoVal={ISO_VAL}", "build_distance_function=1",
            f"outfile_base={o('iso')}", f"outfile={o('iso_dist')}", *d])}


def level_centres_r(meta, lev: int, bbox) -> np.ndarray:
    """|x - (0.5, 0.5, 0.5)| at the cell centres of ``bbox`` on ``lev``."""
    g = meta.geoms[lev]
    cs = [g.prob_lo[d] + (np.arange(bbox.lo[d], bbox.hi[d] + 1)
                          - g.domain.lo[d] + 0.5) * g.dx[d] for d in range(3)]
    X, Y, Z = np.meshgrid(*cs, indexing="ij")
    return np.sqrt((X - .5) ** 2 + (Y - .5) ** 2 + (Z - .5) ** 2)


def distance_checks(path: str, radius: float, inside_sign: float) -> dict:
    """A distance plotfile of a sphere of ``radius`` at the domain's
    centre: |phi| within dmax everywhere, within one finest dx of |r - R|
    in the unclamped band, and of sign ``inside_sign`` at the valid cells
    more than a cell inside, the opposite more than a cell outside."""
    ds = DenseAmrState.from_plotfile(path, "cpu", dtype=torch.float64)
    fin = ds.meta.n_levels - 1
    h = ds.meta.geoms[fin].dx[0]
    dmax = float(max(np.abs(d[0].numpy()).max() for d in ds.data))
    out = {"dmax": dmax, "finest_dx": h}
    for lev in range(ds.meta.n_levels):
        phi = ds.data[lev][0].numpy()
        valid = ds.valid_mask_np(lev)
        r = level_centres_r(ds.meta, lev, ds.lmeta[lev].bbox)
        dx = ds.meta.geoms[lev].dx[0]
        band = valid & (np.abs(r - radius) < dmax - dx)
        err = float(np.abs(np.abs(phi[band]) - np.abs(r[band] - radius))
                    .max(initial=0.0))
        inside = valid & (r < radius - dx)
        outside = valid & (r > radius + dx)
        ok_sign = (bool((np.sign(phi[inside]) == inside_sign).all())
                   and bool((np.sign(phi[outside]) == -inside_sign).all()))
        if not (err <= h and ok_sign and np.isfinite(phi).all()):
            raise AssertionError(f"{path} level {lev}: band error {err} "
                                 f"(finest dx {h}), signs {ok_sign}")
        out[f"level{lev}"] = {"band_cells": int(band.sum()),
                              "band_max_err": err,
                              "inside_cells": int(inside.sum())}
    return out


def tools84_checks(plt: str, tmp: str, mef_nodes: int, dev) -> dict:
    """The production outputs against their sources and closed forms."""
    o = lambda name: os.path.join(tmp, f"t84_{name}")  # noqa: E731
    src = DenseAmrState.from_plotfile(plt, "cpu", names=["temp", "density"],
                                      dtype=torch.float64)
    out = {}
    # the ensemble of three identical analytic fields: level 0, which every
    # file has, averages to the field itself
    for k in ("avg_pc", "avg_lin"):
        avg = DenseAmrState.from_plotfile(o(k), "cpu", dtype=torch.float64)
        if avg.meta.n_levels != 3 or avg.names != ["temp", "density"]:
            raise AssertionError(f"{k}: {avg.meta.n_levels} levels "
                                 f"{avg.names}")
        err = max(float((avg.data[0][c] - src.data[0][src.comp(n)]).abs()
                        .max() / src.data[0][src.comp(n)].abs().max())
                  for c, n in enumerate(avg.names))
        if not (err <= 1e-15 and all(torch.isfinite(d).all()
                                     for d in avg.data)):
            raise AssertionError(f"{k}: level 0 off the field by {err}")
        out[k] = {"level0_rel_err": err, "cells": [
            int(avg.in_level_mask_np(l).sum()) for l in range(3)]}
    n = PROD_CASE["n_cell"]
    n_fin = n * 2 ** (PROD_CASE["n_levels"] - 1)
    sub = PlotfileReader(o("sub"))
    if sub.meta.prob_domain[0].shape != (n // 2,) * 3:
        raise AssertionError(f"subPlt domain {sub.meta.prob_domain[0]}")
    rg, pr = PlotfileReader(o("rg")), PlotfileReader(plt)
    if any(rg.box_array(l).total_cells() != pr.box_array(l).total_cells()
           for l in range(3)) or max(max(b.shape) for l in range(3)
                                     for b in rg.box_array(l)) > 32:
        raise AssertionError("regridPlt: coverage or box size")
    out["regridPlt_boxes"] = [len(rg.box_array(l)) for l in range(3)]
    if PlotfileReader(o("comb")).var_names != ["temp", "density",
                                               "x_velocity"]:
        raise AssertionError("combinePlts: components")
    z = np.load(o("flat.npz"))
    rt = DenseAmrState.from_plotfile(o("rt"), "cpu", dtype=torch.float64)
    if z["data"].shape != (1,) + (2 * n,) * 3 or not np.array_equal(
            rt.data[0].numpy(), z["data"]):
        raise AssertionError("plt2npz mode=flat -> npz2plt: not bitwise")
    zl = np.load(o("lev.npz"))
    if zl["lev2"].shape != (1,) + src.lmeta[2].bbox.shape:
        raise AssertionError("plt2npz levels: lev2 shape")
    img = open(o("slice.ppm"), "rb").read(16)
    if not img.startswith(f"P6\n{n_fin} {n_fin}\n".encode()):
        raise AssertionError(f"slicePlot header {img!r}")
    with open(o("interp.dat"), "rb") as f:
        head = f.readline()
        rows = sum(1 for _ in f)
    if head != b"# x y z temp density\n" or rows != INTERP_POINTS:
        raise AssertionError(f"interp: {head!r} {rows} rows")
    with open(o("fe.flt"), "rb") as f:
        nz = int(np.fromfile(f, np.int32, 1)[0])
        n0 = np.fromfile(f, np.int32, 3)
    valid0 = int(src.valid_mask_np(0).sum())
    if nz != 3 or n0[0] != valid0 or n0[1] != 4:
        raise AssertionError(f"amrToFE flt header {nz} {n0}")
    out["amrToFE_flt_bytes"] = os.path.getsize(o("fe.flt"))
    with open(o("fe.dat")) as f:
        head = [f.readline() for _ in range(2)]
    if head[0] != "VARIABLES = X Y Z temp\n" or "ET=BRICK" not in head[1]:
        raise AssertionError(f"amrToFE tec header {head}")
    out["amrToFE_tec_repo_bytes"] = os.path.getsize(o("fe.dat"))
    out["buildDistance"] = distance_checks(o("dist"), STREAM_R, -1.0)
    out["buildDistance"]["mef_nodes"] = mef_nodes
    out["isosurface_distance"] = distance_checks(o("iso_dist"), ISO_R, 1.0)
    return out


def tools84_card_vs_cpu(tmp: str, stream: dict) -> dict:
    """Each verb on the card and with device=cpu at the repo case (plt2npz
    mode=flat to level 1, the distance verbs on level 0): the copies byte
    for byte, float64 plotfiles within 1e-12, npz arrays equal,
    fcompare/fextrema printouts equal, images within one level, amrToFE's
    Tecplot text and flt tables byte for byte, the samples within 1e-12,
    and the distances within 1e-6 dmax but at near ties of the band (at
    most 2% of the cells, within 0.02 dmax), their signs equal where
    |phi| > 1e-6 dx."""
    plt, mef = stream["plt"], stream["mef"]
    plt_q = os.path.join(tmp, "plt_repo_q")
    write_synthetic_plotfile(plt_q, **{**REPO_CASE, "refine_frac": 0.25})
    pts = os.path.join(tmp, "pts_repo.xyz")
    rng = np.random.default_rng(5)
    with open(pts, "wb") as f:
        native.savetxt_fast(f, rng.uniform(-0.02, 1.02, (20000, 3)),
                            "%.17g")
    o = lambda who, name: os.path.join(tmp, f"cc84_{who}_{name}")  # noqa
    printed, walls = {}, {}
    for who in ("card", "cpu"):
        d = "cuda" if who == "card" else "cpu"
        runs = [
            ("avgPlotfiles", [f"infile={plt} {plt_q}", "interp_type=2",
                              f"outfile={o(who, 'avg')}"]),
            ("subPlt", [f"infile={plt}", "box=8 8 8 50 40 30",
                        f"outfile={o(who, 'sub')}"]),
            ("combinePlts", [f"infile1={plt}", f"infile2={plt}",
                             "comps1=temp", f"outfile={o(who, 'comb')}"]),
            ("regridPlt", [f"infile={plt}", "max_grid_size=16",
                           f"outfile={o(who, 'rg')}"]),
            ("template", [f"infile={plt}", f"outfile={o(who, 'tmpl')}"]),
            ("plt2npz", [f"infile={plt}", "vars=temp density",
                         f"outfile={o(who, 'lev.npz')}"]),
            ("plt2npz", [f"infile={plt}", "mode=flat", "vars=temp density",
                         "finestLevel=1", f"outfile={o(who, 'flat.npz')}"]),
            ("npz2plt", [f"infile={o('card', 'flat.npz')}",
                         f"outfile={o(who, 'rt')}"]),
            ("slicePlot", [f"file={plt}", "varname=temp", "slicedir=1",
                           "sliceloc=100", "outtype=fab", "dtype=float64",
                           f"outfile={o(who, 'slice.fab')}"]),
            ("slicePlot", [f"file={plt}", "varname=temp", "slicedir=1",
                           "sliceloc=100", f"outfile={o(who, 'slice.ppm')}"]),
            ("avgToPlane", [f"infile={plt}", "vars=temp density", "dir=0",
                            "dtype=float64", "format=dat",
                            f"outfile_base={o(who, 'plane')}"]),
            ("interp", [f"infile={plt}", "vars=temp density", "dtype=float64",
                        f"points={pts}", f"out={o(who, 'interp.dat')}"]),
            ("amrToFE", [f"infile={plt}", "vars=temp density",
                         f"outfile={o(who, 'fe.dat')}"]),
            ("amrToFE", [f"infile={plt}", "vars=temp", "connect_cc=0",
                         "outType=flt", f"outfile={o(who, 'fec.flt')}"]),
            ("buildDistance", [f"infile={plt}", f"isoFile={mef}",
                               "finestLevel=0", "dtype=float64",
                               f"outfile={o(who, 'dist')}"]),
            ("isosurface", [f"infile={plt}", f"isoVal={ISO_VAL}",
                            "finestLevel=0", "build_distance_function=1",
                            "dtype=float64",
                            f"outfile_base={o(who, 'iso')}",
                            f"outfile={o(who, 'iso_dist')}"])]
        for tool, args in runs:
            walls[f"{who} {tool} {args[-1].split('_', 2)[-1]}"] = run_wall(
                tool, [*args, f"device={d}"])
        # fcompare: this device's regrid against the card's
        for tool, args in (("fcompare", [f"infile1={o(who, 'rg')}",
                                         f"infile2={o('card', 'rg')}"]),
                           ("fextrema", [f"infile={plt}"])):
            with contextlib.redirect_stdout(io.StringIO()) as said:
                run_wall(tool, [*args, f"device={d}"])
            printed[(tool, who)] = said.getvalue()
    out = {}
    for k in ("sub", "comb", "rg", "tmpl", "rt"):
        same_tree(o("card", k), o("cpu", k))
    out["copies_bitwise"] = ["subPlt", "combinePlts", "regridPlt",
                             "template", "npz2plt"]
    out["avgPlotfiles"] = close_plotfiles(o("card", "avg"), o("cpu", "avg"),
                                          1e-12)
    for k in ("lev.npz", "flat.npz"):
        za, zb = np.load(o("card", k)), np.load(o("cpu", k))
        if sorted(za.files) != sorted(zb.files) or not all(
                np.array_equal(za[f], zb[f]) for f in za.files):
            raise AssertionError(f"plt2npz {k}: card vs CPU")
    out["plt2npz"] = "equal"
    for tool in ("fcompare", "fextrema"):
        if printed[(tool, "card")] != printed[(tool, "cpu")]:
            raise AssertionError(f"{tool} printouts differ")
    if "PLOTFILES AGREE" not in printed[("fcompare", "card")]:
        raise AssertionError("fcompare of equal regrids")
    out["fcompare_fextrema_printouts"] = "equal"
    with open(o("card", "slice.fab"), "rb") as fa, \
            open(o("cpu", "slice.fab"), "rb") as fb:
        (_, a), (_, b) = read_fab(fa), read_fab(fb)
    out["slicePlot_fab"] = float(np.abs(a - b).max() / np.abs(b).max())
    a, b = (np.fromfile(o(w, "slice.ppm"), np.uint8) for w in ("card",
                                                              "cpu"))
    if a.shape != b.shape or np.abs(a.astype(int) - b).max() > 1 \
            or not out["slicePlot_fab"] <= 1e-12:
        raise AssertionError("slicePlot card vs CPU")
    out["avgToPlane"] = max(compare_text_files(
        o("card", f"plane_{n}.dat"), o("cpu", f"plane_{n}.dat"), 1e-12)
        for n in ("temp", "density"))
    out["interp"] = compare_text_files(o("card", "interp.dat"),
                                       o("cpu", "interp.dat"), 1e-12)
    # the same float64 node values on both: the files byte for byte
    for k in ("fe.dat", "fec.flt"):
        if not filecmp.cmp(o("card", k), o("cpu", k), shallow=False):
            raise AssertionError(f"amrToFE {k} card vs CPU")
    out["amrToFE_tec_and_flt"] = "byte-equal"
    for k in ("dist", "iso_dist"):
        out[k] = close_distances(o("card", k), o("cpu", k))
    out["walls_s"] = walls
    return out


def close_distances(a: str, b: str) -> dict:
    """Two distance plotfiles of one hierarchy: |phi| within 1e-6 dmax but
    at most 2% of the cells (near ties of the band that carried another
    triangle through the sweeps), those within 0.02 dmax; the signs equal
    where |phi| > 1e-6 dx."""
    ra, rb = PlotfileReader(a), PlotfileReader(b)
    out = {"off_cells": 0, "cells": 0, "max_err_over_dmax": 0.0}
    for lev in range(rb.meta.n_levels):
        x = np.concatenate([f.ravel() for f in ra.read_level(lev)])
        y = np.concatenate([f.ravel() for f in rb.read_level(lev)])
        dmax = float(np.abs(y).max())
        err = np.abs(np.abs(x) - np.abs(y))
        far = np.abs(y) > 1e-6 * rb.meta.geometry(lev).dx[0]
        out["off_cells"] += int((err > 1e-6 * dmax).sum())
        out["cells"] += len(y)
        out["max_err_over_dmax"] = max(out["max_err_over_dmax"],
                                       float(err.max()) / dmax)
        if not (err.max() <= 0.02 * dmax
                and np.array_equal(np.sign(x[far]), np.sign(y[far]))):
            raise AssertionError(f"{a} vs {b} level {lev}: {out}")
    if out["off_cells"] > 0.02 * out["cells"]:
        raise AssertionError(f"{a} vs {b}: {out}")
    return out


def sdf_split(plt: str, mef_path: str, dev) -> dict:
    """buildDistance's layers on every production level (float32 seeding,
    dmax 4 finest dx, the parity sign), each step ending in a synchronize:
    the band seeding and the parity sign by host clock and profiler device
    time (profiled on levels 0 and 2; level 1, windowed alike, takes level
    0's), the sweeps (their plane step replayed as CUDA graphs) by host
    clock and CUDA events, which the replays keep busy.  Their sum is the
    verb's distance work on the card: a trace of the whole verb holds ~0.76
    M kernels of the graphs and loses events.  On level 0 the sweeps
    replayed as graphs and launched op by op are held bitwise equal."""
    from peleanalysis_tpu_torch.geom import sdf
    ds = DenseAmrState.from_plotfile(plt, dev, names=["temp"],
                                     dtype=torch.float64)
    m = read_mef(mef_path)
    tri_v = m.positions()[m.elements]
    tri = torch.from_numpy(tri_v).to(dev)
    fin = ds.meta.n_levels - 1
    dmax = 4.0 * ds.meta.geoms[fin].dx[0]

    def grid(lev):
        geom, bbox = ds.meta.geoms[lev], ds.lmeta[lev].bbox
        dx = np.array(geom.dx)
        return (np.array(geom.prob_lo) + (np.array(bbox.lo)
                                          - np.array(geom.domain.lo)) * dx,
                dx, bbox.shape)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    seed = lambda o, d, s: sdf.band_seed(tri_v, tri, o, d, s, dmax)  # noqa
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    out = {"triangles": len(tri_v), "dmax": dmax}
    total = {"host_s": 0.0, "device_ms": 0.0}
    dev_ms = {}
    for lev in range(ds.meta.n_levels):
        origin, dx, shape = grid(lev)
        o = {"cells": int(np.prod(shape)),
             "reach": [b.stop - b.start for b in sdf._reach(
                 tri_v, origin, dx, shape, dmax)]}
        (phi0, cl0), o["band_seed_s"] = timed(lambda: seed(origin, dx,
                                                           shape))
        _, o["parity_sign_s"] = timed(lambda: sdf.parity_sign(
            tri_v, origin, dx, shape, dev))
        # both windowed like the finest level: profiled there only
        if lev == fin or lev == 0:
            prof = kernel_profile(lambda: seed(origin, dx, shape))
            dev_ms = {"band_seed": prof["device_ms"]}
            o["band_seed_kernels"] = prof["kernels"]
            prof = kernel_profile(lambda: sdf.parity_sign(
                tri_v, origin, dx, shape, dev))
            dev_ms["parity_sign"] = prof["device_ms"]
        for k, v in dev_ms.items():
            o[f"{k}_device_ms"] = v
        phi, cl = phi0.clone(), cl0.clone()
        ev[0].record()
        o["rounds"], o["sweep_s"] = timed(lambda: sdf.sweep_reach(
            tri_v, tri, phi, cl, origin, dx, dmax))
        ev[1].record()
        torch.cuda.synchronize()
        o["sweep_event_ms"] = ev[0].elapsed_time(ev[1])
        total["host_s"] += o["band_seed_s"] + o["parity_sign_s"] \
            + o["sweep_s"]
        total["device_ms"] += o["band_seed_device_ms"] \
            + o["parity_sign_device_ms"] + o["sweep_event_ms"]
        out[f"level{lev}"] = o
    out["total"] = total
    # level 0: graph replays against the same steps launched op by op
    origin, dx, shape = grid(0)
    phi0, cl0 = seed(origin, dx, shape)
    res = {}
    for graphs in (True, False):
        phi, cl = phi0.clone(), cl0.clone()
        _, sec = timed(lambda: sdf.sweep_reach(tri_v, tri, phi, cl, origin,
                                               dx, dmax, graphs))
        key = "graphs" if graphs else "op_by_op"
        out[f"level0_sweep_{key}_s"] = sec
        res[key] = (phi, cl)
    if not (torch.equal(res["graphs"][0], res["op_by_op"][0])
            and torch.equal(res["graphs"][1], res["op_by_op"][1])):
        raise AssertionError("sweeps: graph replays differ from the ops")
    out["level0_graphs_vs_op_by_op"] = "bitwise"
    return out


def phase_tools84(tmp: str, stream: dict, dev) -> dict:
    """The plotfile tools and buildDistance on the card at full size (the
    5-component plotfile of phase 13, two more hierarchies for the
    ensemble average, 1 M interp points, the 130,052-node sphere MEF):
    launches counted (counts set to 0 just before the cold runs, read just
    after: none of the five kernels runs on this path), cold walls and
    device time, the outputs checked, and every verb card against CPU at
    the repo case."""
    t0 = time.perf_counter()
    plt = os.path.join(tmp, "plt_prod_tools")
    mef = os.path.join(tmp, "seeds_prod_tools.mef")
    if not os.path.exists(plt):          # phase 13 writes both
        f = default_fields()
        write_synthetic_plotfile(
            plt, fields={n: f[n] for n in TOOLS8_NAMES}, **PROD_CASE)
    n_seeds = write_seed_mef(mef, *PROD_SEEDS)
    f = default_fields()
    extra = []
    for i, kw in enumerate(TOOLS84_EXTRA):
        extra.append(os.path.join(tmp, f"plt_prod_84_{i}"))
        write_synthetic_plotfile(extra[-1], fields={
            n: f[n] for n in ("temp", "density")}, **{**PROD_CASE, **kw})
    pts = os.path.join(tmp, "pts_prod.xyz")
    rng = np.random.default_rng(4)
    with open(pts, "wb") as fh:
        native.savetxt_fast(fh, rng.uniform(0.0, 1.0, (INTERP_POINTS, 3)),
                            "%.17g")
    gen_s = time.perf_counter() - t0
    runs = tools84_runs(plt, *extra, mef, pts, stream["plt"], tmp)
    steps = {"generate_s": gen_s}
    t1 = time.perf_counter()
    reset_counts()
    cold = {}
    for k, (tool, args) in runs.items():
        with contextlib.redirect_stdout(io.StringIO()) as said:
            cold[k] = run_tool_counted(tool, args, ())
        if k == "fcompare" and "PLOTFILES AGREE" not in said.getvalue():
            raise AssertionError("fcompare of the template copy")
    launches = counts()
    steps["cold_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    # (the warm re-run of each verb and its read / compute / write split
    # were cut to keep the script's time; PERF.md keeps the numbers
    # measured before)
    tools = {k: {"cold_s": cold[k]} for k in runs}
    # device time in one profiler session; the distance verbs' comes from
    # sdf_split, layer by layer (a trace of either holds ~0.76 M kernels
    # of the sweeps' graphs and loses events); plt2npz's is its copies
    # (68-78 ms of a 4-6 s host zlib wall on an H100 80GB HBM3 at
    # 700 W), left out to keep the script's time
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        profs = kernel_profiles({
            k: (lambda a=args, t=tool: cli.main([t, *a]))
            for k, (tool, args) in runs.items()
            if k not in ("buildDistance", "isosurface_distance",
                         "plt2npz_levels", "plt2npz_flat")})
    for k, prof in profs.items():
        tools[k].update({f: prof[f] for f in ("device_ms", "copy_ms",
                                              "kernels", "trace_whole")})
        tools[k]["profiled_wall_ms"] = prof["wall_ms"]
    steps["profile_s"] = time.perf_counter() - t1
    with contextlib.redirect_stdout(io.StringIO()) as said:
        run_wall("doctor", [])
    doctor = said.getvalue().splitlines()
    if not (any(ln.strip().startswith("card:") and "W" in ln
                for ln in doctor)
            and all(any(f"kernel {k}: OK" in ln for ln in doctor)
                    for k in ("grad_mag", "stream_march", "stats_hist"))):
        raise AssertionError(f"doctor: {doctor}")
    t1 = time.perf_counter()
    checks = tools84_checks(plt, tmp, n_seeds, dev)
    split = sdf_split(plt, mef, dev)
    steps["checks_and_split_s"] = time.perf_counter() - t1
    for p in os.listdir(tmp):
        if p.startswith("t84_"):
            p = os.path.join(tmp, p)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    t1 = time.perf_counter()
    cmp = tools84_card_vs_cpu(tmp, stream)
    steps["card_vs_cpu_s"] = time.perf_counter() - t1
    emit({"phase": "tools84", "cases": {
        "production": PROD_CASE, "ensemble": TOOLS84_EXTRA,
        "interp_points": INTERP_POINTS, "mef_nodes": n_seeds},
        "steps": steps, "launches": launches, "tools": tools,
        "doctor": doctor, "checks": checks, "sdf_split": split,
        "card_vs_cpu": cmp,
        "seconds": time.perf_counter() - t0})
    return launches

# -- phase 15 -------------------------------------------------------------------
BIN_RANDOM_TRIS = 1_000_000       # the 3-coordinate case of test_mef_tools.py
BIN_RANDOM_CPU = 100_000          # its card-vs-CPU subset
BIN_RANDOM_MAX = 1.004
TOOLS86_BINS = "16 16 16"


def fields_mef(src: str, path: str, names, fns) -> MEF:
    """``src``'s surface with the node fields fns[i](x, y, z) named
    names[i] (coordinates relative to the sphere's centre 0.5), written to
    ``path``."""
    m = read_mef(src)
    p = m.positions() - 0.5
    cols = [fn(p[:, 0], p[:, 1], p[:, 2])[:, None] for fn in fns]
    out = MEF("sphere", ["X", "Y", "Z", *names],
              np.concatenate([m.positions(), *cols], axis=1), m.elements)
    write_mef(path, out)
    return out


def random_tris_mef(path: str, n: int, seed: int) -> MEF:
    """n random small triangles in [0, BIN_RANDOM_MAX]^3, unshared nodes
    (the 3-coordinate binning case of tests/test_mef_tools.py)."""
    rng = np.random.default_rng(seed)
    tris = rng.random((n, 1, 3)) + 0.004 * rng.random((n, 3, 3))
    m = MEF("random", ["X", "Y", "Z"], tris.reshape(-1, 3),
            np.arange(3 * n, dtype=np.int32).reshape(-1, 3))
    write_mef(path, m)
    return m


def tools86_runs(p: dict, o, d: str) -> dict:
    """The MEF and streamline post-processing verbs on the inputs ``p``
    (sphere with fields f, g; its copy with h; the production isosurface;
    random triangles; a StreamData), outputs named by ``o``: name -> (tool,
    args)."""
    dev = [f"device={d}"]
    bins = ["binComps=X Y Z", f"nBins={TOOLS86_BINS}"]
    sph_lo, sph_hi, r_hi = (" ".join([v] * 3) for v in (
        "0.35", "0.65", str(BIN_RANDOM_MAX)))
    return {
        "isoMEF": ("isoMEF", [f"infile={p['sph']}", "comp=f", "isoVal=0.3",
                              f"outfile={o('iso.mef')}", *dev]),
        "combineMEF": ("combineMEF", [f"infile1={p['sph']}",
                                      f"infile2={p['sph_h']}", "comps1=f g",
                                      "comps2=h", f"outfile={o('comb.mef')}",
                                      *dev]),
        "mergeMEF": ("mergeMEF", [f"infile1={p['iso']}",
                                  f"infile2={p['iso']}",
                                  f"outfile={o('merged.mef')}", *dev]),
        "multMEF": ("multMEF", [f"infile1={p['sph']}", f"infile2={p['sph']}",
                                "comps=f g", f"outfile={o('mult.mef')}",
                                *dev]),
        "scaleMEF": ("scaleMEF", [f"infile={p['sph']}", "comps=f g",
                                  "factors=2 -0.5",
                                  f"outfile={o('scaled.mef')}", *dev]),
        "sliceMEF": ("sliceMEF", [f"infile={p['iso']}", "dir=2",
                                  "locs=0.5 0.55", "write_tec=1",
                                  f"outfile_base={o('slice')}", *dev]),
        "smoothMEF": ("smoothMEF", [f"infile={p['sph']}", "comps=f g",
                                    "niter=3", f"outfile={o('smooth.mef')}",
                                    *dev]),
        "trimMEFgen": ("trimMEFgen", [f"infile={p['sph']}", "comps=f",
                                      "signs=+", "vals=0", "do_area_stats=1",
                                      f"outfile={o('trim.mef')}", *dev]),
        "binMEF_sphere": ("binMEF", [f"infile={p['sph']}", *bins,
                                     f"binMin={sph_lo}", f"binMax={sph_hi}",
                                     *dev]),
        "binMEF_random": ("binMEF", [f"infile={p['rand']}", *bins,
                                     "binMin=0 0 0", f"binMax={r_hi}",
                                     *dev]),
        "decimateMEF": ("decimateMEF", [f"infile={p['sph']}",
                                        f"outfile={o('dec.mef')}", *dev]),
        "surfMEFtoDAT": ("surfMEFtoDAT", [f"infile={p['iso']}",
                                          f"outfile={o('iso.dat')}", *dev]),
        "surfDATtoMEF": ("surfDATtoMEF", [f"infile={o('iso.dat')}",
                                          f"outfile={o('iso_rt.mef')}",
                                          *dev]),
        "checkIso": ("checkIso", [f"infile={p['sph']}", *dev]),
        "checkIso_decimated": ("checkIso", [f"infile={o('dec.mef')}", *dev]),
        "stream2plt": ("stream2plt", [
            f"infile={p['sd']}", f"outfile={o('lines.fab')}",
            "comps=X Y Z temp density", "maxComps=temp", "maxVals=1100",
            "maxSgns=+", "distComp=3", "distVal=1000", *dev]),
        "streamScatter": ("streamScatter", [
            f"infile={p['sd']}", "vars=X Y Z temp density", "condVar=temp",
            "condValMoreThan=1000", f"outfileBase={o('scatter')}", *dev]),
        "streamSub": ("streamSub", [f"infile={p['sd']}", "sElt=0",
                                    "nElt=20000", "comps=temp",
                                    f"outfile={o('sub')}", *dev]),
        "streamTubeStats": ("streamTubeStats", [
            f"infile={p['sd']}", "intComps=temp density",
            "avgComps=temp density", "gradComps=temp", "peakComp=temp",
            "FCRComp=3", "compsAtPeakFCR=density", "nSmooth=3",
            f"outfile={o('tube')}", *dev])}


def printed_bins(text: str) -> dict:
    """binMEF's sparse print: bin index tuple -> area."""
    out = {}
    for ln in text.splitlines():
        t = ln.split()
        if len(t) == 4 and all(x.isdigit() for x in t[:3]):
            out[tuple(int(x) for x in t[:3])] = float(t[3])
    return out


def printed_check(text: str) -> dict:
    return dict(ln.split(": ", 1) for ln in text.splitlines() if ": " in ln)


def tools86_checks(p: dict, o, said: dict) -> dict:
    """The closed forms: binMEF's bins add up to the surface's area;
    trimming the sphere at its centre keeps half its area; the equator
    slice of the production isosurface is one closed polyline of length
    2 pi ISO_R; the sphere and its decimation are watertight; the tubes'
    volumes are >= 0 and the seed surface's temp is 1000 K; the Tecplot
    round trip and the merge keep the surface."""
    out = {}
    sph, iso = read_mef(p["sph"]), read_mef(p["iso"])
    for k, m in (("binMEF_sphere", sph), ("binMEF_random",
                                          read_mef(p["rand"]))):
        bins = printed_bins(said[k])
        total = m.total_area()
        err = abs(sum(bins.values()) - total) / total
        if not err <= 1e-9:
            raise AssertionError(f"{k}: bins sum off the area by {err}")
        out[k] = {"bins_filled": len(bins), "area": total,
                  "sum_rel_err": err}
    trim = read_mef(o("trim.mef"))
    half = trim.total_area() / sph.total_area()
    if not abs(half - 0.5) <= 1e-6 or trim.positions()[:, 2].min() < 0.5 \
            - 1e-12:
        raise AssertionError(f"trimMEFgen at the centre kept {half}")
    out["trimMEFgen_area_fraction"] = half
    eq = read_mef(o("slice_0.5.mef"))
    # a degenerate triangle of the surface gives a zero-length segment:
    # chains of two nodes are left out, as tests/test_mef_tools.py does
    chains = [c for c in mef_tools.assemble_polylines(eq) if len(c) > 2]
    length = eq.total_area()
    lerr = length / (2 * np.pi * ISO_R) - 1
    if not (len(chains) == 1 and chains[0][0] == chains[0][-1]
            and abs(lerr) <= AREA_TOL):
        raise AssertionError(f"sliceMEF equator: {len(chains)} chains, "
                             f"length off 2 pi r by {lerr}")
    out["sliceMEF_equator"] = {"segments": eq.n_elts,
                               "length_rel_err": lerr}
    for k in ("checkIso", "checkIso_decimated"):
        rep = printed_check(said[k])
        if rep.get("watertight") != "True":
            raise AssertionError(f"{k}: {rep}")
        out[k] = rep
    dec = read_mef(o("dec.mef"))
    if not dec.n_elts <= sph.n_elts // 2:
        raise AssertionError(f"decimateMEF kept {dec.n_elts} faces")
    out["decimateMEF"] = {"faces": [sph.n_elts, dec.n_elts],
                          "area_ratio": dec.total_area() / sph.total_area()}
    tube = read_mef(o("tube.mef"))
    vol, tavg = tube.field("volume"), tube.field("temp_avg")
    terr = float(np.abs(tavg - ISO_VAL).max()) / ISO_VAL
    if not ((vol >= 0).all() and vol.max() > 0 and terr <= 0.01
            and np.isfinite(tube.nodes).all()):
        raise AssertionError(f"streamTubeStats: volumes or temp_avg off "
                             f"{ISO_VAL} by {terr}")
    out["streamTubeStats"] = {"elements": tube.n_elts,
                              "volume_total": float(vol[::3].sum()),
                              "temp_avg_max_rel_err": terr}
    rt = read_mef(o("iso_rt.mef"))
    if not (np.array_equal(rt.elements, iso.elements)
            and np.allclose(rt.nodes, iso.nodes, rtol=1e-11, atol=0)):
        raise AssertionError("surfMEFtoDAT -> surfDATtoMEF changed the "
                             "surface")
    if read_mef(o("merged.mef")).n_elts != 2 * iso.n_elts:
        raise AssertionError("mergeMEF element count")
    out["iso_prod"] = {"nodes": iso.n_nodes, "elements": iso.n_elts}
    return out


def close_mefs(a: str, b: str) -> dict:
    """Same names and connectivity, nodes within 1e-12 of each column's
    largest value."""
    ma, mb = read_mef(a), read_mef(b)
    if ma.names != mb.names or not np.array_equal(ma.elements, mb.elements):
        raise AssertionError(f"{a} and {b}: names or connectivity differ")
    scale = np.maximum(np.abs(mb.nodes).max(axis=0, initial=0.0), 1e-300)
    err = float((np.abs(ma.nodes - mb.nodes) / scale).max(initial=0.0))
    if not err <= 1e-12:
        raise AssertionError(f"{a} vs {b}: {err} of the column scale")
    return {"elements": ma.n_elts, "nodes": ma.n_nodes, "max_err": err}


def tools86_card_vs_cpu(p: dict, tmp: str, repo_sd: str) -> dict:
    """Every verb with device=cuda and with device=cpu on the same input:
    the MEF verbs on the production sphere and isosurface (binMEF's random
    triangles cut to BIN_RANDOM_CPU), the streamline verbs on the repo
    case's StreamData.  Element counts and connectivity equal, values
    within 1e-12 of each column's largest; the host verbs' files byte for
    byte, checkIso's printout equal."""
    q = dict(p, sd=repo_sd, rand=os.path.join(tmp, "t86_rand_cpu.mef"))
    random_tris_mef(q["rand"], BIN_RANDOM_CPU, 7)
    said, walls = {}, {}
    for who in ("card", "cpu"):
        o = lambda name, w=who: os.path.join(tmp, f"cc86_{w}_{name}")  # noqa
        runs = tools86_runs(q, o, "cuda" if who == "card" else "cpu")
        t0 = time.perf_counter()
        for k, (tool, args) in runs.items():
            with contextlib.redirect_stdout(io.StringIO()) as out:
                run_wall(tool, args)
            said[who, k] = out.getvalue()
        walls[who] = time.perf_counter() - t0
    o = lambda who, name: os.path.join(tmp, f"cc86_{who}_{name}")  # noqa
    res = {"wall_s": walls}
    for k in ("iso.mef", "comb.mef", "mult.mef", "scaled.mef",
              "slice_0.5.mef", "slice_0.55.mef", "smooth.mef", "trim.mef",
              "tube.mef"):
        res[k] = close_mefs(o("card", k), o("cpu", k))
    for k in ("merged.mef", "dec.mef", "iso.dat", "iso_rt.mef",
              "slice_0.5.dat"):
        if not filecmp.cmp(o("card", k), o("cpu", k), shallow=False):
            raise AssertionError(f"{k}: card and CPU files differ")
        res[k] = "bytes equal"
    res["streamSub"] = {"files": same_tree(o("card", "sub"),
                                           o("cpu", "sub"))}
    for k in ("binMEF_sphere", "binMEF_random"):
        a, b = printed_bins(said["card", k]), printed_bins(said["cpu", k])
        scale = max(b.values())
        err = max(abs(a[i] - b[i]) for i in b) / scale
        if a.keys() != b.keys() or not err <= 1e-12:
            raise AssertionError(f"{k}: card vs CPU bins {err}")
        res[k] = {"bins_filled": len(b), "max_err": err}
    for k in ("checkIso", "checkIso_decimated", "trimMEFgen",
              "decimateMEF"):
        if said["card", k] != said["cpu", k]:
            raise AssertionError(f"{k}: printouts differ")
    with open(o("card", "lines.fab"), "rb") as fa, \
            open(o("cpu", "lines.fab"), "rb") as fb:
        (ba, xa), (bb, xb) = read_fab(fa), read_fab(fb)
    if ba != bb:
        raise AssertionError("stream2plt: FAB boxes differ")
    res["stream2plt"] = {"lines": ba.shape[0], "max_err": close_scaled(
        np.moveaxis(xa, 0, -1), np.moveaxis(xb, 0, -1), "stream2plt")}
    xa, xb = (np.loadtxt(o(w, "scatter.dat"), ndmin=2) for w in ("card",
                                                                 "cpu"))
    if xa.shape != xb.shape:
        raise AssertionError("streamScatter: row counts differ")
    res["streamScatter"] = {"rows": len(xa),
                            "max_err": close_scaled(xa, xb, "streamScatter")}
    return res


def phase_tools86(tmp: str, stream: dict) -> dict:
    """The MEF tools and the streamline post-processing verbs on the card
    at full size (the 130,052-node sphere MEF of phase 5b with fields, the
    production isosurface of phase 7c, 1 M random triangles binned 16^3
    over 3 coordinates, phase 5b's StreamData of 130,052 lines with
    elements): launches counted (counts set to 0 just before the cold
    runs, read just after: none of the five kernels runs on this path),
    warm walls split into read / compute / write with peak device memory
    and device time, the closed forms, and every verb card against CPU."""
    t0 = time.perf_counter()
    o = lambda name: os.path.join(tmp, f"t86_{name}")  # noqa: E731
    src = os.path.join(tmp, "seeds_prod.mef")
    p = {"sph": o("sphere.mef"), "sph_h": o("sphere_h.mef"),
         "iso": os.path.join(tmp, "iso_prod.mef"), "rand": o("rand.mef"),
         "sd": os.path.join(tmp, "sd_prod")}
    sph = fields_mef(src, p["sph"], ["f", "g"], [
        lambda x, y, z: z / STREAM_R, lambda x, y, z: x * y / STREAM_R ** 2])
    fields_mef(src, p["sph_h"], ["h"], [lambda x, y, z: x + y])
    random_tris_mef(p["rand"], BIN_RANDOM_TRIS, 5)
    steps = {"generate_s": time.perf_counter() - t0}
    runs = tools86_runs(p, o, "cuda")
    t1 = time.perf_counter()
    reset_counts()
    cold, said = {}, {}
    for k, (tool, args) in runs.items():
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cold[k] = run_tool_counted(tool, args, ())
        said[k] = out.getvalue()
    launches = counts()
    steps["cold_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    tools = {}
    for k, (tool, args) in runs.items():
        with contextlib.redirect_stdout(io.StringIO()):
            tools[k] = {"cold_s": cold[k], **tool_cost(tool, args, False)}
    steps["warm_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        profs = kernel_profiles({
            k: (lambda a=args, t=tool: cli.main([t, *a]))
            for k, (tool, args) in runs.items()})
    for k, prof in profs.items():
        tools[k].update({f: prof[f] for f in ("device_ms", "copy_ms",
                                              "kernels", "trace_whole")})
        tools[k]["profiled_wall_ms"] = prof["wall_ms"]
    steps["profile_s"] = time.perf_counter() - t1
    checks = tools86_checks(p, o, said)
    t1 = time.perf_counter()
    cmp = tools86_card_vs_cpu(p, tmp, stream["sd"])
    steps["card_vs_cpu_s"] = time.perf_counter() - t1
    for f in os.listdir(tmp):
        if f.startswith(("t86_", "cc86_")):
            f = os.path.join(tmp, f)
            shutil.rmtree(f) if os.path.isdir(f) else os.remove(f)
    emit({"phase": "tools86", "cases": {
        "sphere_nodes": sph.n_nodes, "sphere_elements": sph.n_elts,
        "random_triangles": BIN_RANDOM_TRIS, "bins": TOOLS86_BINS,
        "stream_data": p["sd"], "repo_stream_data": stream["sd"]},
        "steps": steps, "launches": launches, "tools": tools,
        "checks": checks, "card_vs_cpu": cmp,
        "seconds": time.perf_counter() - t0})
    return launches


# -- phase 16 -------------------------------------------------------------------
# drm19's species (PelePhysics' drm19 mechanism); the script writes 84
# atom-balanced reactions over them (testing.synthetic_mechanism)
DRM19 = ("H2 H O O2 OH H2O HO2 CH2 CH2(S) CH3 CH4 CO CO2 HCO CH2O CH3O "
         "C2H4 C2H5 C2H6 N2 AR").split()
DRM19_REACTIONS = 84
# GRI-Mech 3.0's 53 species and its 325 reactions' count
GRI30 = ("H2 H O O2 OH H2O HO2 H2O2 C CH CH2 CH2(S) CH3 CH4 CO CO2 HCO CH2O "
         "CH2OH CH3O CH3OH C2H C2H2 C2H3 C2H4 C2H5 C2H6 HCCO CH2CO HCCOH N "
         "NH NH2 NH3 NNH NO NO2 N2O HNO CN HCN H2CN HCNN HCNO HOCN HNCO NCO "
         "N2 AR C3H7 C3H8 CH2CHO CH3CHO").split()
GRI30_REACTIONS = 325
KIN_CPU_CELLS = 1_000_000
# flops of one cell's evaluation besides the products: ~10 transcendental
# operations (log, exp, pow) a reaction
KIN_TRANSCENDENTALS = 10
QPD_FIRST = ["CH4 + OH => CH3 + H2O   1.0E08 1.6 3120."]
SCO2_COMPS = "comps=adv_0 adv_1 temp density X(CH4) vfrac"
QPD_RTOL = 1e-10


CHEM_NAMES = [f"X({s})" for s in DRM19] + ["temp", "density", "adv_0",
                                             "adv_1", "vfrac"]


def chem_level(x, y, z, nan_cells: bool) -> torch.Tensor:
    """The chemistry case's fields (CHEM_NAMES) on the cell centres x, y, z
    (tensors): drm19's 21 mole fractions summing to 1 (as
    testing.fraction_fields), temp and density of testing.default_fields,
    sCO2's adv_0, adv_1 in [0, 1] and vfrac; with ``nan_cells`` adv_0 holds
    bands of NaN, +-inf and +-1e30 cells."""
    ns = len(DRM19)
    phi = 2 * np.pi * (x + 2 * y + 3 * z)
    out = [(1.0 + 0.5 * torch.sin(phi + 2 * np.pi * k / ns)) / ns
           for k in range(ns)]
    g = torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
                  / 0.15 ** 2)
    adv0 = torch.clamp(x + 0.2 * torch.sin(5 * y), 0.0, 1.0)
    if nan_cells:
        band = y < 0.25
        for (lo, hi), bad in (((0.40, 0.42), np.nan), ((0.60, 0.62), np.inf),
                              ((0.70, 0.72), -np.inf), ((0.80, 0.82), 1e30),
                              ((0.20, 0.22), -1e30)):
            adv0 = torch.where(band & (x > lo) & (x < hi), bad, adv0)
    out += [300.0 + 1500.0 * g, 1.0 / (1.0 + 4.0 * g), adv0,
            torch.clamp(1.1 * z - 0.05, 0.0, 1.0), 0.5 + 0.5 * torch.cos(x * y)]
    return torch.stack(out)


def write_chem_plotfile(path: str, case: dict, dev,
                        nan_cells: bool = False) -> None:
    """``case``'s hierarchy (testing.make_amr_hierarchy) with the fields of
    ``chem_level`` made on ``dev`` and written by the device writer."""
    geoms, bas, ratios = make_amr_hierarchy(**case)
    meta = AmrMeta(geoms, bas, ratios, 0.5)
    lmeta = _level_metas(meta)
    data = []
    for lm in lmeta:
        c = [torch.tensor(v, device=dev) for v in cell_centers(lm.bbox,
                                                               lm.geom)]
        data.append(chem_level(*torch.meshgrid(*c, indexing="ij"),
                               nan_cells))
    DenseAmrState(meta, CHEM_NAMES, data, lmeta, dev).to_plotfile(path)


def tools88_runs(plt: str, mech: str, o, d: str) -> dict:
    """The seven chemistry verbs on the plotfile ``plt`` with the
    mechanism ``mech``, outputs named by ``o``: name -> (tool, args)."""
    dev = [f"device={d}"]
    return {
        "plotXtoY": ("plotXtoY", [f"infile={plt}", f"outfile={o('Y')}",
                                  *dev]),
        "plotYtoX": ("plotYtoX", [f"infile={o('Y')}", f"outfile={o('X')}",
                                  *dev]),
        "plotTransportCoeff": ("plotTransportCoeff", [
            f"infile={plt}", f"outfile={o('tr')}", *dev]),
        "plotTYtoLe": ("plotTYtoLe", [f"infile={plt}", f"outfile={o('le')}",
                                      *dev]),
        "plotQPD": ("plotQPD", [f"mech_file={mech}", f"infile={plt}",
                                "QPDatom=C", "fuelSpec=CH4",
                                f"QPDfileName={o('qpd.dat')}", *dev]),
        "sCO2": ("sCO2", [f"infile={plt}", SCO2_COMPS, "planeCoord=0",
                          "nBins=64", "nBinPlanes=10",
                          f"output_dir={o('sco2')}", *dev]),
        "buildPMF": ("buildPMF", [f"infile={o('flame.dat')}",
                                  f"outfile={o('pmf.dat')}",
                                  f"fortran={o('pmf.f90')}", *dev])}


def write_flame_table(path: str, n: int = 2000) -> None:
    """A 1-D premixed-flame table of n points (x, T, 21 mole fractions)
    for buildPMF."""
    x = np.linspace(0.0, 2.0, n)
    prog = 0.5 * (1.0 + np.tanh((x - 1.0) / 0.05))
    cols = [x, 300.0 + 1700.0 * prog] + [
        (1.0 + 0.5 * np.sin(3 * x + k)) / len(DRM19) for k in range(
            len(DRM19))]
    with open(path, "w") as f:
        f.write('VARIABLES = "X" "T" ' + " ".join(f'"X({s})"' for s in DRM19)
                + "\n")
        np.savetxt(f, np.column_stack(cols))


def remove(*paths) -> None:
    for p in paths:
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)


def qpd_edges(path: str):
    """(species line, edge tokens, [n, 2] values) of a plotQPD file."""
    lines = open(path).read().splitlines()
    rows = [ln.split() for ln in lines[2:]]
    return lines[1], [r[:2] for r in rows], np.array(
        [[float(v) for v in r[2:]] for r in rows]).reshape(-1, 2)


def normval(said: str) -> float:
    return float(said.split("NormVal: ")[1].split()[0])


def close_qpd(a: str, b: str, said_a: str, said_b: str) -> dict:
    """Two plotQPD runs: species and edge tokens equal, each value and the
    NormVal printout within QPD_RTOL relative."""
    sa, ea, va = qpd_edges(a)
    sb, eb, vb = qpd_edges(b)
    if sa != sb or ea != eb:
        raise AssertionError(f"{a} vs {b}: edges differ")
    err = float((np.abs(va - vb) / np.maximum(np.abs(vb), 1e-300))
                .max(initial=0.0))
    nerr = abs(normval(said_a) - normval(said_b)) / abs(normval(said_b))
    if not (err <= QPD_RTOL and nerr <= QPD_RTOL):
        raise AssertionError(f"plotQPD: edges {err}, NormVal {nerr}")
    return {"edges": len(ea), "max_rel_err": err, "normval_rel_err": nerr}


def close_sco2(a: str, b: str) -> dict:
    """Two sCO2 output directories: the same files, mean.dat and mcmt.dat
    values and every bins2d array within 1e-12 of each one's largest."""
    names = sorted(os.listdir(b))
    if sorted(os.listdir(a)) != names:
        raise AssertionError(f"{a} and {b} hold other files")
    worst = 0.0
    for n in names:
        x = np.loadtxt(os.path.join(a, n)) if n.endswith(".dat") \
            else np.load(os.path.join(a, n))
        y = np.loadtxt(os.path.join(b, n)) if n.endswith(".dat") \
            else np.load(os.path.join(b, n))
        err = float(np.abs(x - y).max()) / max(float(np.abs(y).max()), 1e-300)
        if x.shape != y.shape or not err <= 1e-12:
            raise AssertionError(f"sCO2 {n}: {err}")
        worst = max(worst, err)
    return {"files": len(names), "max_err": worst}


def prod_checks(name: str, o, said: str) -> dict:
    """What a production run wrote, read back: the plotfiles' layout, the
    mass fractions' sum of 1 and finiteness on level 0 (plotXtoY), finite
    plotQPD sums and NormVal, 52 finite sCO2 slabs, buildPMF's files."""
    if name in ("plotXtoY", "plotYtoX", "plotTransportCoeff", "plotTYtoLe"):
        path = o({"plotXtoY": "Y", "plotYtoX": "X", "plotTransportCoeff": "tr",
                  "plotTYtoLe": "le"}[name])
        r = PlotfileReader(path)
        lev0 = np.stack(r.read_level(0))
        out = {"names": len(r.var_names), "levels": r.meta.n_levels,
               "level0_finite": bool(np.isfinite(lev0).all())}
        if name == "plotXtoY":
            ny = sum(n.startswith("Y(") for n in r.var_names)
            out["level0_sum_err"] = float(np.abs(
                lev0[:, :ny].sum(axis=1) - 1.0).max())
            if not out["level0_sum_err"] <= 1e-12:
                raise AssertionError(f"plotXtoY: Y sums {out}")
        if r.meta.n_levels != 3 or not out["level0_finite"]:
            raise AssertionError(f"{name}: {out}")
        return out
    if name == "plotQPD":
        _, edges, vals = qpd_edges(o("qpd.dat"))
        out = {"edges": len(edges), "normval": normval(said)}
        if not (edges and np.isfinite(vals).all()
                and np.isfinite(out["normval"])):
            raise AssertionError(f"plotQPD: {out}")
        return out
    if name == "sCO2":
        mean = np.loadtxt(os.path.join(o("sco2"), "mean.dat"))
        bins = [f for f in os.listdir(o("sco2")) if f.startswith("bins2d")]
        if mean.shape != (52, 4) or len(bins) != 52 \
                or not np.isfinite(mean).all():
            raise AssertionError(f"sCO2: {mean.shape}, {len(bins)} bins")
        return {"slabs": len(bins)}
    return {"bytes": os.path.getsize(o("pmf.dat"))
            + os.path.getsize(o("pmf.f90"))}


def tools88_outputs(name: str, o) -> list:
    """The files a verb writes (plotYtoX's input, plotXtoY's output, goes
    with plotYtoX's)."""
    return {"plotXtoY": [], "plotYtoX": [o("Y"), o("X")],
            "plotTransportCoeff": [o("tr")], "plotTYtoLe": [o("le")],
            "plotQPD": [o("qpd.dat")], "sCO2": [o("sco2")],
            "buildPMF": [o("pmf.dat"), o("pmf.f90")]}[name]


def tools88_checks(tmp: str, o, mech: str, dev) -> dict:
    """The closed forms on the card's outputs at the repo case (``o`` names
    them): the mass fractions sum to 1 and Y -> X gives back the plotfile's
    X within 1e-12 (renormalised over the species found), Le = 1 within
    1e-12 (lewis=1); plotQPD of uniform
    fields integrates Q x V_domain; every sCO2 slab's bins and volume count
    its cells (vfrac = 1), the slabs add to the domain."""
    out = {}
    ry, rx, src = (PlotfileReader(p) for p in (o("Y"), o("X"), o("plt")))
    # species found by their X(name) variables: X(CH2(S)) is not one
    # (chem.mechanism.Mechanism.from_plotfile_vars, as in the JAX package)
    ns = sum(n.startswith("Y(") for n in ry.var_names)
    comps = [src.var_index(n.replace("Y(", "X(", 1))
             for n in ry.var_names[:ns]]
    sum_err = rt_err = 0.0
    for lev in range(src.meta.n_levels):
        for y, x, s in zip(ry.read_level(lev), rx.read_level(lev),
                           src.read_level(lev, comps)):
            sum_err = max(sum_err, float(np.abs(y[:ns].sum(axis=0)
                                                - 1.0).max()))
            s = s / s.sum(axis=0)       # over the species found
            rt_err = max(rt_err, float((np.abs(x[:ns] - s)
                                        / np.abs(s)).max()))
    le_err = max(float(np.abs(f - 1.0).max())
                 for lev in range(src.meta.n_levels)
                 for f in PlotfileReader(o("le")).read_level(lev))
    out.update(y_sum_err=sum_err, x_round_trip_rel_err=rt_err,
               lewis_one_err=le_err)
    if not (sum_err <= 1e-12 and rt_err <= 1e-12 and le_err <= 1e-12):
        raise AssertionError(f"chemistry closed forms: {out}")
    # a uniform field: each reaction's integral is Q x V_domain
    sp = ["CH4", "CH3", "H2O", "OH", "O2", "CO", "CO2", "H"]
    Xv = np.array([0.1, 0.01, 0.05, 0.02, 0.2, 0.1, 0.02, 0.5])
    fields = {f"X({s})": (lambda x, y, z, v=v: v + 0 * x)
              for s, v in zip(sp, Xv)}
    fields["temp"] = lambda x, y, z: 1000.0 + 0 * x
    fields["density"] = lambda x, y, z: 0.5 + 0 * x
    uni, umech = o("uniform"), o("uniform.inp")
    write_synthetic_plotfile(uni, n_cell=32, n_levels=3, fields=fields)
    with open(umech, "w") as f:
        f.write("SPECIES\n" + " ".join(sp) + "\nEND\nREACTIONS\n"
                "CH4 + OH => CH3 + H2O    1.0E12  0.0  0.\n"
                "CO + OH => CO2 + H       2.0E12  0.0  0.\nEND\n")
    with contextlib.redirect_stdout(io.StringIO()) as said:
        run_wall("plotQPD", [f"mech_file={umech}", f"infile={uni}",
                             "QPDatom=C", f"QPDfileName={o('uqpd.dat')}"])
    W = np.array([molecular_weight(s) for s in sp])
    C = Xv * 0.5e-3 / (Xv @ W)
    q1, q2 = 1.0e12 * C[0] * C[3], 2.0e12 * C[5] * C[3]
    _, edges, vals = qpd_edges(o("uqpd.dat"))
    got = dict(zip(map(tuple, edges), vals[:, 0]))
    errs = {"normval_vs_1/(q1 V)": abs(normval(said.getvalue()) * q1 - 1.0),
            "CO->CO2": abs(got[("CO", "CO2")] / (q2 / q1) - 1.0)}
    out["qpd_uniform"] = errs
    if not max(errs.values()) <= QPD_RTOL:
        raise AssertionError(f"plotQPD uniform field: {errs}")
    # sCO2's slabs: with vfrac = 1 every bin set counts each cell once,
    # NaN/inf/huge adv cells in bin 0 included
    ds = DenseAmrState.from_plotfile(o("plt"), dev,
                                     names=["adv_0", "adv_1", "temp",
                                            "density", "X(CH4)", "vfrac"],
                                     dtype=torch.float64)
    dense = flatten_to_level(ds, ds.meta.n_levels - 1)
    dense[5] = 1.0
    rbin = torch.zeros(dense.shape[2:], dtype=torch.int64, device=dev)
    sums = slab_sums(dense, rbin, 64, 10)
    nb2 = 64 * 64
    cells = np.array([min(10, dense.shape[1] - c0) * dense.shape[2]
                      * dense.shape[3] for c0 in range(0, dense.shape[1],
                                                       10)])
    counts_ = [sums[:, nb2:2 * nb2].sum(axis=1),
               sums[:, 2 * nb2 + 65: 2 * nb2 + 130].sum(axis=1), sums[:, -1]]
    out["sco2_slabs"] = {"slabs": len(cells), "domain_cells":
                         int(cells.sum()), "nan_cells": int(
                             torch.isnan(dense[0]).sum())}
    if not all(np.array_equal(c, cells) for c in counts_) \
            or cells.sum() != dense[0].numel():
        raise AssertionError("sCO2 slabs do not add up to the domain")
    del ds, dense
    remove(uni, umech, o("uqpd.dat"))
    return out


def tools88_card_vs_cpu(tmp: str, mech: str, dev) -> dict:
    """Every verb with device=cuda and with device=cpu on the repo case
    (adv_0 with NaN, +-inf and +-1e30 cells): plotfiles within 1e-12 of
    each component's largest, plotQPD's edges within 1e-10, sCO2 within
    1e-12, buildPMF byte for byte; then the card's closed forms."""
    plt = os.path.join(tmp, "cc88_plt")
    write_chem_plotfile(plt, REPO_CASE, dev, nan_cells=True)
    res, said, walls = {}, {}, {}
    for who in ("card", "cpu"):
        o = lambda name, w=who: os.path.join(tmp, f"cc88_{w}_{name}")  # noqa
        write_flame_table(o("flame.dat"))
        t0 = time.perf_counter()
        for k, (tool, args) in tools88_runs(plt, mech, o, "cuda" if who ==
                                            "card" else "cpu").items():
            with contextlib.redirect_stdout(io.StringIO()) as out:
                run_wall(tool, args)
            said[who, k] = out.getvalue()
        walls[who] = time.perf_counter() - t0
    o = lambda who, name: os.path.join(tmp, f"cc88_{who}_{name}")  # noqa
    res["wall_s"] = walls
    for k in ("Y", "X", "tr", "le"):
        res[k] = close_plotfiles(o("card", k), o("cpu", k), 1e-12)
    res["plotQPD"] = close_qpd(o("card", "qpd.dat"), o("cpu", "qpd.dat"),
                               said["card", "plotQPD"],
                               said["cpu", "plotQPD"])
    res["sCO2"] = close_sco2(o("card", "sco2"), o("cpu", "sco2"))
    for k in ("pmf.dat", "pmf.f90"):
        if not filecmp.cmp(o("card", k), o("cpu", k), shallow=False):
            raise AssertionError(f"buildPMF {k}: card and CPU differ")
    res["buildPMF"] = "bytes equal"
    res["checks"] = tools88_checks(
        tmp, lambda name: plt if name == "plt" else o("card", name), mech,
        dev)
    for f in os.listdir(tmp):
        if f.startswith("cc88_"):
            remove(os.path.join(tmp, f))
    return res


def kinetics_alone(tmp: str, dev) -> dict:
    """qf_qr_sums of a GRI-Mech 3.0-sized mechanism (53 species, 325
    reactions, written by the script) on 19,447,296 random states made on
    the card: CUDA-event ms of a call after a 1 M-cell warm-up, peak
    memory, chunk, the bound;
    the same function on the CPU for KIN_CPU_CELLS of them, held to the
    card's sums of those cells."""
    path = os.path.join(tmp, "t88_gri.inp")
    with open(path, "w") as f:
        f.write(synthetic_mechanism(GRI30, GRI30_REACTIONS, seed=1))
    kin = Kinetics(*parse_chemkin(path)).to(dev)
    ns, nr, n = len(kin.species), kin.n_reactions, PROD_CELLS
    g = torch.Generator(device=dev).manual_seed(16)
    T = 300.0 + 2200.0 * torch.rand(n, generator=g, device=dev,
                                    dtype=torch.float64)
    X = torch.rand(n, ns, generator=g, device=dev,
                   dtype=torch.float64) ** 3
    X /= X.sum(dim=1, keepdim=True)
    rho = 1e-4 + 1.1e-3 * torch.rand(n, generator=g, device=dev,
                                     dtype=torch.float64)
    kin.qf_qr_sums(T[:KIN_CPU_CELLS], rho[:KIN_CPU_CELLS],
                   X[:KIN_CPU_CELLS])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    qf, qr = kin.qf_qr_sums(T, rho, X)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() - base
    if not (torch.isfinite(qf).all() and torch.isfinite(qr).all()):
        raise AssertionError("GRI-sized kinetics: non-finite sums")
    # bytes: T, rho and X read once; operations: the four products (lnC
    # with nuf and nur, g/RT with nu_net, C with the efficiencies) and the
    # transcendentals
    nbytes = n * (2 + ns) * 8 + 2 * nr * 8
    flops = n * (4 * 2 * ns * nr + KIN_TRANSCENDENTALS * nr)
    bound_ms, bound_by = bound(nbytes, flops, torch.float64)
    sub = [t[:KIN_CPU_CELLS] for t in (T, rho, X)]
    card = [s.cpu().numpy() for s in kin.qf_qr_sums(*sub)]
    host = [t.cpu() for t in sub]
    t0 = time.perf_counter()
    cpu = [s.numpy() for s in kin.qf_qr_sums(*host)]
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    err = max(float(np.abs(a - b).max() / np.abs(b).max())
              for a, b in zip(card, cpu))
    if not err <= QPD_RTOL:
        raise AssertionError(f"GRI-sized kinetics: card vs CPU {err}")
    del T, X, rho, sub
    remove(path)
    return {"species": ns, "reactions": nr, "cells": n,
            "falloff": int(kin.fo_mask.sum()), "chunk": kin.chunk_cells(dev),
            "cpu_chunk": kin.chunk_cells("cpu"),
            "ms": ms, "peak_bytes": peak, "bytes": nbytes,
            "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms,
            "cpu_cells": KIN_CPU_CELLS, "cpu_ms": cpu_ms,
            "card_vs_cpu_rel_err": err}


def phase_tools88(tmp: str, dev) -> dict:
    """The chemistry verbs on the card at production size (drm19's 21
    species, temp, density and sCO2's fields on the 19.4 M-cell case; 84
    reactions): launches counted (counts set to 0 just before the cold
    runs, read just after: none of the five kernels runs on this path),
    device time and kernels of each cold run from one profiler session,
    each output read back and deleted; the closed forms and every verb
    card against CPU at the repo case; qf_qr_sums alone at GRI-Mech 3.0's
    size against its bound."""
    t0 = time.perf_counter()
    o = lambda name: os.path.join(tmp, f"t88_{name}")  # noqa: E731
    mech = o("drm19.inp")
    with open(mech, "w") as f:
        f.write(synthetic_mechanism(DRM19, DRM19_REACTIONS, first=QPD_FIRST))
    plt = o("plt")
    write_chem_plotfile(plt, PROD_CASE, dev)
    write_flame_table(o("flame.dat"))
    steps = {"generate_s": time.perf_counter() - t0}
    runs = tools88_runs(plt, mech, o, "cuda")
    t1 = time.perf_counter()
    cold, said, checks = {}, {}, {}

    def cold_run(k, tool, args):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cold[k] = run_tool_counted(tool, args, ())
        said[k] = out.getvalue()
        checks[k] = prod_checks(k, o, said[k])
        remove(*tools88_outputs(k, o))

    reset_counts()
    profs = kernel_profiles({
        k: (lambda k=k, t=tool, a=args: cold_run(k, t, a))
        for k, (tool, args) in runs.items()})
    launches = counts()
    steps["cold_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    tools = {}
    for k, (tool, args) in runs.items():
        with contextlib.redirect_stdout(io.StringIO()):
            # (the warm re-run and its split were cut to keep the script's
            # time; PERF.md keeps the numbers measured before)
            tools[k] = {"cold_s": cold[k],
                        **{f: profs[k][f] for f in (
                            "device_ms", "copy_ms", "kernels",
                            "trace_whole")},
                        "profiled_wall_ms": profs[k]["wall_ms"]}
        remove(*tools88_outputs(k, o))
    steps["collect_s"] = time.perf_counter() - t1
    remove(plt)
    t1 = time.perf_counter()
    cmp = tools88_card_vs_cpu(tmp, mech, dev)
    steps["card_vs_cpu_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    kin = kinetics_alone(tmp, dev)
    steps["kinetics_s"] = time.perf_counter() - t1
    remove(mech, o("flame.dat"))
    emit({"phase": "tools88", "cases": {
        "cells": PROD_CELLS, "species": len(DRM19),
        "reactions": DRM19_REACTIONS, "components": len(CHEM_NAMES)},
        "steps": steps, "launches": launches, "tools": tools,
        "checks": checks, "card_vs_cpu": cmp, "kinetics": kin,
        "seconds": time.perf_counter() - t0})
    return launches


# -- phase 17 -------------------------------------------------------------------
PIPE_NAMES = ("temp", "density", "progress", "x_velocity", "y_velocity",
              "z_velocity")
PIPE_SERIES = 4
PIPE_CM = ["binComp=temp", "avgComps=density", "nBins=64", "binMin=300",
           "binMax=1801"]
PIPE_JPDF = ["vars=temp progress", "nBins=64", "useminmax1=300 1801",
             "useminmax2=0 1", "output_gnuplot=1", "output_plotfile=0"]


def chain_stages(plt: str, out: str, iso_write: bool = True) -> list:
    """The production chain of the JAX bench's ``sec_cli32``
    (bench.py:835): grad, curvature, the temp = 1000 K isosurface, and
    streamlines along the velocity seeded from its nodes."""
    return [["grad", f"infile={plt}", "gradVar=temp", f"outfile={out}_g"],
            ["curvature", f"infile={plt}", "progressName=temp",
             f"outfile={out}_K"],
            ["isosurface", f"infile={plt}", "isoCompName=temp",
             f"isoVal={ISO_VAL:g}", f"outfile_base={out}_iso"]
            + ([] if iso_write else ["write=0"]),
            ["stream", f"plotfile={plt}", "traceAlongV=1",
             f"isoFile={out}_iso.mef", *STREAM_KEYS,
             f"outFile={out}_lines.dat"]]


def pipeline_argv(stages) -> list:
    argv = ["pipeline"]
    for st in stages:
        argv += st + ["--"]
    return argv[:-1]


class ChainCounters:
    """Within the block: the plotfile reads (count and host seconds of
    ``load_plotfile_fabs``, on whichever thread), the host's wait in each
    final ``Session.flush_writes()``, and the peak device memory of each
    pipeline stage (``cli.main`` with a session)."""

    def __init__(self):
        from peleanalysis_tpu_torch import session
        self.session = session
        self.reads, self.read_s, self.flush_s = 0, 0.0, 0.0
        self.stage_peak, self.stage_s = [], []

    def __enter__(self):
        s, real_read = self.session, self.session.load_plotfile_fabs
        real_flush, real_main = s.Session.flush_writes, cli.main

        def read(*a, **k):
            t0 = time.perf_counter()
            try:
                return real_read(*a, **k)
            finally:
                self.reads += 1
                self.read_s += time.perf_counter() - t0

        def flush(sess, match=None):
            t0 = time.perf_counter()
            try:
                return real_flush(sess, match=match)
            finally:
                if match is None:
                    self.flush_s += time.perf_counter() - t0

        def main(argv=None, session=None):
            if session is None or argv[0] == "pipeline":
                return real_main(argv, session=session)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc = real_main(argv, session=session)
            torch.cuda.synchronize()
            self.stage_peak.append((argv[0],
                                    torch.cuda.max_memory_allocated()))
            self.stage_s.append((argv[0], time.perf_counter() - t0))
            return rc

        self._saved = [(s, "load_plotfile_fabs", real_read),
                       (s.Session, "flush_writes", real_flush),
                       (cli, "main", real_main)]
        s.load_plotfile_fabs, s.Session.flush_writes, cli.main = \
            read, flush, main
        return self

    def __exit__(self, *exc):
        for owner, name, real in self._saved:
            setattr(owner, name, real)
        return False

    def report(self) -> dict:
        return {"reads": self.reads, "read_s": self.read_s,
                "final_flush_wait_s": self.flush_s,
                "stage_peak_bytes": self.stage_peak,
                "stage_s": self.stage_s}


def start_server(sock: str):
    """``serve`` on a thread of this process; returns the thread once the
    socket answers."""
    from peleanalysis_tpu_torch.server import send_command, serve
    t = threading.Thread(target=serve, args=({"socket": [sock]},),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 30.0
    while True:
        try:
            if send_command(sock, cmd="ping", timeout=30.0)["rc"] == 0:
                return t
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def send_ok(sock: str, argv, **kw) -> dict:
    from peleanalysis_tpu_torch.server import send_command
    rep = send_command(sock, argv=argv, timeout=600.0, **kw)
    if rep["rc"] != 0:
        raise RuntimeError(f"server: {argv[0]} rc {rep['rc']}: "
                           f"{rep['err'][-2000:]}")
    return rep


def chain_run(way: str, plt: str, out: str, sock: str) -> dict:
    """One warm run of the chain: (a) ``file``, four cli.main calls; (b)
    ``pipeline``, one pipeline with write=0 on the isosurface stage; (c)
    ``server``, the four commands through the server (sync each).  Wall
    (host clock, ending in a synchronize), reads, the final flushes' wait,
    peak device memory, each stage's wall (in the pipeline and the server
    without the writes the stage leaves behind) and peak memory, and for
    (a) and (c) each command's wall with its writes."""
    stages = chain_stages(plt, out, iso_write=(way != "pipeline"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ChainCounters() as cc:
        t0 = time.perf_counter()
        commands = []
        if way == "pipeline":
            if cli.main(pipeline_argv(stages)) != 0:
                raise RuntimeError("pipeline failed")
        for st in (stages if way != "pipeline" else ()):
            t1 = time.perf_counter()
            if way == "file":
                if cli.main(st) != 0:
                    raise RuntimeError(f"{st[0]} failed")
                torch.cuda.synchronize()
            else:
                send_ok(sock, st, sync=True)
            commands.append((st[0], time.perf_counter() - t1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = max([torch.cuda.max_memory_allocated()]
               + [b for _, b in cc.stage_peak])
    return {"wall_s": wall, **cc.report(), "command_s": commands,
            "max_memory_allocated": peak}


def same_files(a: str, b: str) -> None:
    if os.path.isdir(a):
        if same_tree(a, b) == 0:
            raise AssertionError(f"{a}: empty")
    elif not filecmp.cmp(a, b, shallow=False):
        raise AssertionError(f"{a} and {b} differ")


def subprocess_server(tmp: str, plt: str, dev) -> dict:
    """``python -m peleanalysis_tpu_torch serve`` as a child process: one
    ``send`` of grad at the repo case, its files equal to a direct run's,
    then ``shutdown``: the child exits 0 within its deadline."""
    from peleanalysis_tpu_torch.server import send_command
    sock = os.path.join(tmp, "p17_child.sock")
    env = dict(os.environ, PYTHONPATH=ROOT)
    log = os.path.join(tmp, "p17_child.log")
    # this process's allocator keeps the earlier phases' blocks reserved:
    # hand them back so the child finds the card's memory free
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with open(log, "wb") as err:
        child = subprocess.Popen([sys.executable, "-m",
                                  "peleanalysis_tpu_torch", "serve",
                                  f"socket={sock}"], cwd=ROOT, env=env,
                                 stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline = time.monotonic() + 120.0
        while True:
            try:
                send_command(sock, cmd="ping", timeout=30.0)
                break
            except OSError:
                if child.poll() is not None or time.monotonic() > deadline:
                    with open(log) as fh:
                        raise RuntimeError("child server did not answer: "
                                           + fh.read()[-2000:])
                time.sleep(0.1)
        up_s = time.perf_counter() - t0
        out_s, out_d = (os.path.join(tmp, f"p17_child_{k}") for k in "sd")
        grad = ["grad", f"infile={plt}", "gradVar=temp", f"device={dev}"]
        t1 = time.perf_counter()
        send_ok(sock, grad + [f"outfile={out_s}"], sync=True)
        send_s = time.perf_counter() - t1
        run_wall(grad[0], grad[1:] + [f"outfile={out_d}"])
        cells = same_tree(out_s, out_d)
        if send_command(sock, cmd="shutdown", timeout=60.0)["rc"] != 0:
            raise RuntimeError("child server: shutdown failed")
        rc = child.wait(timeout=60)
        if rc != 0:
            raise RuntimeError(f"child server exited {rc}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    shutil.rmtree(out_s)
    shutil.rmtree(out_d)
    return {"start_to_first_reply_s": up_s, "send_grad_s": send_s,
            "files_equal_direct": cells, "exit_code": rc}


def series_walls(plts, tmp: str) -> dict:
    """conditionalMean and one jpdf pair over the series, prefetch=0 and
    prefetch=1 in turns (min of 2 each), outputs byte-equal."""
    files = " ".join(plts)
    out = {}
    for tool, keys in (("conditionalMean", PIPE_CM), ("jpdf", PIPE_JPDF)):
        walls, text = {"0": [], "1": []}, {}
        for rep in range(2):
            for pre in ("0", "1"):
                cm = os.path.join(tmp, f"p17_cm{pre}.dat")
                args = [f"infile={files}", *keys, f"prefetch={pre}"]
                if tool == "conditionalMean":
                    args.append(f"outfile={cm}")
                with contextlib.redirect_stdout(io.StringIO()):
                    walls[pre].append(run_wall(tool, args))
                text[pre] = (open(cm, "rb").read()
                             if tool == "conditionalMean" else
                             [open(os.path.join(p, "Pdf_temp_progress.gpd"),
                                   "rb").read() for p in plts])
        if text["0"] != text["1"]:
            raise AssertionError(f"{tool}: prefetch=1 output differs")
        out[tool] = {"prefetch0_s": min(walls["0"]),
                     "prefetch1_s": min(walls["1"]),
                     "walls_s": walls, "outputs_equal": True}
    return out


def deferred_fetches(plt: str, dev) -> dict:
    """The H100's numbers for the deferred fetches at production size:
    DeferredSurface.positions() (xyz only) against its full copy
    (to_mef(), what the eager engine copies), and DeferredLines.finish()
    (one packed copy) against one copy a level (the eager path), each
    bitwise equal to the eager engine's result."""
    from peleanalysis_tpu_torch.stream.trace import _decode_compressed
    ds = DenseAmrState.from_plotfile(plt, dev, names=[
        "temp", "x_velocity", "y_velocity", "z_velocity"],
        dtype=torch.float64)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    eager = extract_isosurface(ds, "temp", ISO_VAL)
    res = {}
    for rep in range(2):
        surf = extract_isosurface(ds, "temp", ISO_VAL, defer=True)
        xyz, pos_s = timed(surf.positions)
        mef, full_s = timed(surf.to_mef)
        if not (np.array_equal(xyz, eager.positions())
                and np.array_equal(mef.nodes, eager.nodes)
                and np.array_equal(mef.elements, eager.elements)):
            raise AssertionError("DeferredSurface differs from the eager MEF")
        res.setdefault("positions_s", []).append(pos_s)
        res.setdefault("full_copy_s", []).append(full_s)
    surface = {"nodes": eager.n_nodes, "elements": eager.n_elts,
               "positions_bytes": eager.n_nodes * 3 * 8,
               "full_bytes": eager.nodes.nbytes + eager.elements.nbytes,
               "positions_s": min(res["positions_s"]),
               "full_copy_s": min(res["full_copy_s"])}
    seeds = eager.positions()
    kw = dict(trace_field=None, sample_names=["temp"])
    lines = trace_streamlines(ds, seeds, 51, 0.5, **kw)
    res = {}
    for rep in range(2):
        dl = trace_streamlines(ds, seeds, 51, 0.5, defer=True, **kw)
        (got, _), finish_s = timed(dl.finish)
        per = trace_streamlines(ds, seeds, 51, 0.5, defer=True, **kw)

        def per_level():
            out = np.zeros_like(lines)
            for sel, p in per._pending:
                if per._compress:
                    _decode_compressed(p.cpu().numpy(), sel, out,
                                       per._n_half, per._nf, per._h_phys)
                else:
                    out[sel] = p.cpu().numpy()
            return out

        got2, per_s = timed(per_level)
        if not (np.array_equal(got, lines) and np.array_equal(got2, lines)):
            raise AssertionError("DeferredLines differs from the eager lines")
        res.setdefault("finish_s", []).append(finish_s)
        res.setdefault("per_level_s", []).append(per_s)
    lines_out = {"lines": len(seeds), "levels": len(dl._pending),
                 "bytes": lines.nbytes, "finish_s": min(res["finish_s"]),
                 "per_level_copies_s": min(res["per_level_s"])}
    return {"surface": surface, "lines": lines_out}


def phase_pipeline(tmp: str, stream: dict, dev) -> dict:
    """The production chain three ways (file-chained, pipeline, server),
    its outputs byte-equal, the session's memory back to its level after
    reset, a child-process server, the series read-ahead and the deferred
    fetches; launches counted over the timed runs, every kernel then held
    against its plain version on one pipeline and one series run of each
    stats tool."""
    t0 = time.perf_counter()
    f = default_fields()
    plt = os.path.join(tmp, "p17_plt")
    bas = write_synthetic_plotfile(
        plt, fields={n: f[n] for n in PIPE_NAMES}, **PROD_CASE)[1]
    plts = [plt]
    for i in range(1, PIPE_SERIES):
        plts.append(os.path.join(tmp, f"p17_plt{i}"))
        shutil.copytree(plt, plts[-1])
    steps = {"generate_s": time.perf_counter() - t0}
    from peleanalysis_tpu_torch.server import send_command
    sock = os.path.join(tmp, "p17.sock")
    server = start_server(sock)
    o = lambda tag: os.path.join(tmp, f"p17_{tag}")  # noqa: E731
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        chain_run("file", plt, o("cold"), sock)        # builds, first loads
    steps["cold_s"] = time.perf_counter() - t1
    # the timed runs: every count set to 0 just before, read just after
    reset_counts()
    runs = {"file": [], "pipeline": [], "server": []}
    t1 = time.perf_counter()
    for rep in range(2):
        for way in runs:
            with contextlib.redirect_stdout(io.StringIO()):
                runs[way].append(chain_run(way, plt, o(f"{way}{rep}"), sock))
            if way == "server":
                # each timed server run starts from an empty session, and
                # no other run shares the card with the server's
                send_command(sock, cmd="reset", timeout=600.0)
    launches = counts()
    steps["timed_s"] = time.perf_counter() - t1
    # a warm server session: the same four commands twice, no reset
    with contextlib.redirect_stdout(io.StringIO()):
        chain_run("server", plt, o("server_warm"), sock)
        warm_session = chain_run("server", plt, o("server_warm"), sock)
    send_command(sock, cmd="reset", timeout=600.0)
    ways = {w: {"wall_s": min(r["wall_s"] for r in rs),
                "walls_s": [r["wall_s"] for r in rs], "runs": rs}
            for w, rs in runs.items()}
    ways["server_warm_session"] = warm_session
    # (b) and (c) against (a), byte for byte (the first timed round)
    checks = {}
    for way in ("pipeline", "server"):
        for rep in range(1):
            a, b = o(f"file{rep}"), o(f"{way}{rep}")
            for suffix in ("_g", "_K", "_lines.dat"):
                same_files(a + suffix, b + suffix)
            if way == "server":
                same_files(a + "_iso.mef", b + "_iso.mef")
            if way == "pipeline" and os.path.exists(b + "_iso.mef"):
                raise AssertionError("pipeline wrote its write=0 surface")
        checks[way] = "plotfiles and lines byte-equal to file-chained" + (
            ", MEF too" if way == "server" else "")
    send_command(sock, cmd="shutdown", timeout=600.0)
    server.join(timeout=60)
    if server.is_alive():
        raise RuntimeError("in-process server did not stop")
    # the session's memory: back to its level after reset
    from peleanalysis_tpu_torch.session import Session
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    sess = Session(async_writes=True)
    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(pipeline_argv(chain_stages(plt, o("mem"), False)),
                    session=sess) != 0:
            raise RuntimeError("pipeline failed")
    held_by_session = torch.cuda.memory_allocated() - before
    sess.reset()
    del sess
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    memory = {"before_bytes": before, "session_holds_bytes": held_by_session,
              "after_reset_bytes": after}
    if after != before:
        raise AssertionError(f"reset left {after - before} bytes allocated")
    for tag in ["cold", "mem", "server_warm"] + [
            f"{w}{r}" for w in runs for r in range(2)]:
        for suffix in ("_g", "_K", "_iso.mef", "_lines.dat"):
            p = o(tag) + suffix
            if os.path.isdir(p):
                shutil.rmtree(p)
            elif os.path.exists(p):
                os.remove(p)
    steps["chain_total_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    reset_counts()
    series = series_walls(plts, tmp)
    for k, v in counts().items():
        launches[k] += v
    steps["series_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    deferred = deferred_fetches(plt, dev)
    steps["deferred_s"] = time.perf_counter() - t1
    # every kernel of the phase held against its plain version
    t1 = time.perf_counter()
    with HeldAgainstPlain() as held, \
            contextlib.redirect_stdout(io.StringIO()):
        if cli.main(pipeline_argv(chain_stages(plt, o("held"), False))) != 0:
            raise RuntimeError("held pipeline failed")
        files = " ".join(plts)
        run_wall("conditionalMean", [f"infile={files}", *PIPE_CM,
                                     f"outfile={o('held_cm.dat')}"])
        run_wall("jpdf", [f"infile={files}", *PIPE_JPDF])
    missing = [k for k in counts() if held.seen[k]["calls"] == 0]
    if missing or any(v == 0 for v in launches.values()):
        raise AssertionError(f"pipeline phase: no launch or held call of "
                             f"{missing or launches}")
    steps["held_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    child = subprocess_server(tmp, stream["plt"], dev)
    steps["child_server_s"] = time.perf_counter() - t1
    for p in plts[1:]:
        shutil.rmtree(p)
    emit({"phase": "pipeline", "case": PROD_CASE,
          "cells": sum(b.total_cells() for b in bas),
          "chain": [st[0] for st in chain_stages(plt, "x")],
          "ways": ways, "checks": checks, "session_memory": memory,
          "child_server": child, "series": {"files": PIPE_SERIES, **series},
          "deferred": deferred, "launches": launches, "steps": steps,
          "kernels_vs_plain": {"tolerance": "as phases 3, 3b and 3c",
                               "calls": held.report()},
          "seconds": time.perf_counter() - t0})
    return launches, {k: v["max_abs_err"] for k, v in held.report().items()}


# -- phase 18 -------------------------------------------------------------------
SHARDS = 4
SHARD_KEYS = [f"ndevices={SHARDS}", "mesh_shape=2 2"]


def window_levels(meta, mesh, halo, dtype) -> dict:
    """The window partition of ``meta`` over ``mesh``: the largest window's
    bytes of one component against the whole state's, and the window
    levels summed over the shards (one grad_mag launch each)."""
    sd = ShardedDenseState(meta, ["temp"], None, mesh, halo, dtype)
    big = max(sd.window_bytes(s) for s in range(mesh.size))
    return {"largest_window_bytes": big, "state_bytes": sd.state_bytes(),
            "share": big / sd.state_bytes(),
            "window_levels": sum(p.n_levels for p in sd.plans)}


def sharded_runs(name: str, argv, out_key: str, ext: str, counted: dict,
                 expect=None, keys=tuple(SHARD_KEYS), held=None) -> dict:
    """``argv`` with ndevices=1 and with ``keys``, each twice (cold, warm;
    peak device memory over the warm run), the sharded cold run's launches
    counted (set to 0 just before, read just after); the outputs byte for
    byte equal.  With ``held`` (a HeldAgainstPlain), the sharded run once
    more under it."""
    res = {}
    for way, keys in (("one", []), ("sharded", list(keys))):
        out = f"{argv[0]}_{name}_{way}"
        args = [*argv[1:], f"{out_key}={out}", *keys]
        if way == "sharded":
            reset_counts()
            cold = run_wall(argv[0], args)
            got = counts()
            for k, v in got.items():
                counted[k] += v
            if expect is not None and got != expect:
                raise AssertionError(f"{name}: sharded launches {got}, "
                                     f"expected {expect}")
        else:
            cold = run_wall(argv[0], args)
        torch.cuda.reset_peak_memory_stats()
        warm = run_wall(argv[0], args)
        res[way] = {"cold_s": cold, "warm_s": warm,
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if way == "sharded" and held is not None:
            with held:
                res[way]["held_s"] = run_wall(argv[0], args)
    one, sharded = (f"{argv[0]}_{name}_{w}{ext}" for w in ("one", "sharded"))
    same_files(one, sharded)
    res["byte_equal"] = True
    return res


def plotfile_diff(a: str, b: str) -> dict:
    """The largest difference of each component of two plotfiles of one
    layout over its largest value (finite cells), and whether their NaN
    sets are equal."""
    ra, rb = PlotfileReader(a), PlotfileReader(b)
    if ra.var_names != rb.var_names or ra.meta.n_levels != rb.meta.n_levels:
        raise AssertionError(f"{a} and {b} differ in layout")
    err = {n: 0.0 for n in rb.var_names}
    scale = dict(err)
    nan_equal = True
    for lev in range(rb.meta.n_levels):
        for fa, fb in zip(ra.read_level(lev), rb.read_level(lev)):
            for c, n in enumerate(rb.var_names):
                nan_equal &= bool(np.array_equal(np.isnan(fa[c]),
                                                 np.isnan(fb[c])))
                ok = np.isfinite(fb[c]) & np.isfinite(fa[c])
                err[n] = max(err[n], float(np.abs(fa[c][ok] - fb[c][ok])
                                           .max(initial=0.0)))
                scale[n] = max(scale[n], float(np.abs(fb[c][ok])
                                               .max(initial=0.0)))
    rel = {n: err[n] / max(scale[n], 1e-300) for n in err}
    return {"max_rel": max(rel.values()), "by_component": rel,
            "nan_sets_equal": nan_equal}


# the sharded smoothing solve is not byte-equal to one device (its dots
# sum in another order): float32 within the JAX package's own 5e-5
SMOOTH_SHARDED_TOL = 5e-5


def sharded_smooth(plt: str, counted: dict, zero: dict, held, mesh) -> dict:
    """curvature do_smooth=1 (composite) at production, ndevices=1 against
    ndevices=4 mesh_shape=2 2: cold and warm walls, the CG iterations and
    peak device memory of each, the sharded cold run's launches (7
    grad_mag a window level), the largest relative difference and the NaN
    sets, one iteration's halo update (bytes, copies), and the sharded run
    once more under ``held``."""
    argv = ["curvature", f"infile={plt}", "progressName=temp", "do_smooth=1",
            "do_gaussCurv=1"]
    sd = ShardedDenseState(load_plotfile_fabs(plt, ["temp"])[0], ["temp"],
                           None, mesh, stencil_halo(CURVATURE_STAGES,
                                                    "quadratic"),
                           torch.float32)
    expect = {**zero, "grad_mag": 7 * sum(p.n_levels for p in sd.plans)}
    cells, copies = WindowHalo(sd).volume()
    res = {"halo_update": {"cells": cells, "copies": copies,
                           "bytes": cells * 4,
                           "note": "one per CG iteration (the operator's "
                           "average-down, every level) and one after "
                           "the solve; float32, one component"}}
    for way, keys in (("one", []), ("sharded", list(SHARD_KEYS))):
        args = [*argv[1:], f"outfile=curvature_smooth_{way}", *keys]
        solve.ITERATIONS.clear()
        reset_counts()
        cold = run_wall(argv[0], args)
        got = counts()
        iters = list(solve.ITERATIONS)
        if way == "sharded":
            for k, v in got.items():
                counted[k] += v
            if got != expect:
                raise AssertionError(f"sharded smoothing launches {got}, "
                                     f"expected {expect}")
        torch.cuda.reset_peak_memory_stats()
        solve.ITERATIONS.clear()
        warm = run_wall(argv[0], args)
        if list(solve.ITERATIONS) != iters:
            raise AssertionError(f"{way}: CG iterations {iters} then "
                                 f"{solve.ITERATIONS}")
        res[way] = {"cold_s": cold, "warm_s": warm, "cg_iterations": iters,
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if way == "sharded":
            with held:
                res[way]["held_s"] = run_wall(argv[0], args)
    if res["one"]["cg_iterations"] != res["sharded"]["cg_iterations"]:
        raise AssertionError(f"CG iterations {res['one']['cg_iterations']} "
                             f"(1 device) vs {res['sharded']['cg_iterations']}")
    diff = plotfile_diff("curvature_smooth_sharded", "curvature_smooth_one")
    if not diff["nan_sets_equal"] or diff["max_rel"] > SMOOTH_SHARDED_TOL:
        raise AssertionError(f"sharded smoothing differs: {diff}")
    res["vs_one_device"] = {"tolerance": SMOOTH_SHARDED_TOL, **diff}
    res["launches"] = expect["grad_mag"]
    return res


# a DIM=2 hierarchy at production: 1024^2 at level 0, two levels of
# ratio 2 (each over half the coarser one's extent), 64^2 boxes; its
# 1000 K contour is a circle inside the finest level
DIM2_CASE = dict(n_cell=1024, n_levels=3, max_grid_size=64, ndim=2)
DIM2_ISO = 1000.0


def sharded_dim2(tmp: str, counted: dict, zero: dict, held, mesh) -> dict:
    """grad, curvature and the iso-lines of ``DIM2_CASE`` (written here,
    from the 2-D default fields), ndevices=1 against ndevices=4
    mesh_shape=2 2: byte-equal files, walls, peak memory and launches
    (grad_mag: one a window level for grad, 7 for curvature)."""
    plt = os.path.join(tmp, "plt_dim2")
    t0 = time.perf_counter()
    write_synthetic_plotfile(plt, **DIM2_CASE)
    write_s = time.perf_counter() - t0
    meta = load_plotfile_fabs(plt, ["temp"])[0]
    wl = {k: window_levels(meta, mesh, h, dt)["window_levels"]
          for k, h, dt in (("grad", stencil_halo(GRAD_STAGES, "quadratic"),
                            torch.float32),
                           ("curvature", stencil_halo(CURVATURE_STAGES,
                                                      "quadratic"),
                            torch.float32))}
    return {
        "case": DIM2_CASE, "cells": sum(ba.total_cells() for ba in meta.bas),
        "write_s": write_s,
        "grad": sharded_runs("dim2", ["grad", f"infile={plt}",
                                      "gradVar=temp"], "outfile", "",
                             counted, {**zero, "grad_mag": wl["grad"]},
                             held=held),
        "curvature": sharded_runs(
            "dim2", ["curvature", f"infile={plt}", "progressName=temp"],
            "outfile", "", counted,
            {**zero, "grad_mag": 7 * wl["curvature"]}, held=held),
        "isosurface": sharded_runs(
            "dim2", ["isosurface", f"infile={plt}", "isoCompName=temp",
                     f"isoVal={DIM2_ISO}"], "outfile_base", ".mef", counted,
            zero)}


def sharded_distance(plt: str, counted: dict, zero: dict) -> dict:
    """isosurface build_distance_function=1 at production, ndevices=1
    against ndevices=4 mesh_shape=2 2: the distance plotfiles byte-equal,
    walls and peak memory."""
    res = {}
    for way, keys in (("one", []), ("sharded", list(SHARD_KEYS))):
        args = [f"infile={plt}", "isoCompName=temp", "isoVal=1000",
                "build_distance_function=1", f"outfile_base=dist_{way}",
                f"dist_outfile=dist_{way}_plt", *keys]
        reset_counts()
        cold = run_wall("isosurface", args)
        got = counts()
        if got != zero:
            raise AssertionError(f"distance launches {got}")
        torch.cuda.reset_peak_memory_stats()
        warm = run_wall("isosurface", args)
        res[way] = {"cold_s": cold, "warm_s": warm,
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
    same_files("dist_one_plt", "dist_sharded_plt")
    same_files("dist_one.mef", "dist_sharded.mef")
    res["byte_equal"] = True
    return res


def halo_grad_vs_plain(dev) -> dict:
    """``parallel/halo.py`` halo_grad over 2 x 2 shards on the card (the
    grad_mag kernel on each grown shard) against the plain version of the
    global gradient on the card: gradients bitwise, magnitude <= 1 ulp."""
    gen = torch.Generator().manual_seed(18)
    out = {}
    for dtype in (torch.float32, torch.float64):
        field = torch.randn((1, 248, 248, 248), generator=gen,
                            dtype=torch.float64).to(dev, dtype)
        mesh = make_spatial_mesh(SHARDS, (2, 2), "cuda")
        specs = ("x", "y", None)
        shards = split_blocks(field, mesh, specs)
        dx = (0.1, 0.2, 0.3)
        k = join_blocks(halo_grad(shards, dx, mesh, specs), mesh, specs)
        g = field[0]
        for d in range(3):
            idx = [slice(None)] * 3
            lo, hi = list(idx), list(idx)
            lo[d], hi[d] = slice(0, 1), slice(-1, None)
            g = torch.cat([g[tuple(lo)], g, g[tuple(hi)]], dim=d)
        p = gk.grad_mag_torch(g.contiguous(), dx, True)
        torch.cuda.synchronize()
        if not torch.equal(k[:3], p[:3]):
            raise AssertionError(f"halo_grad gradient differs from plain "
                                 f"({dtype})")
        ulps = ulp_diff(k[3], p[3])
        if ulps > 1:
            raise AssertionError(f"halo_grad magnitude {ulps} ulp off")
        out[str(dtype)[6:]] = {
            "max_abs_err": float((k - p).abs().max()), "mag_ulps": ulps,
            "ms": cuda_ms(lambda: halo_grad(shards, dx, mesh, specs), n=5),
            "plain_ms": cuda_ms(lambda: gk.grad_mag_torch(
                g.contiguous(), dx, True), n=5)}
    return out


def march_blocks_vs_plain(dev) -> dict:
    """The march kernel over a window of a volume (``march`` with
    ``origin=`` and ``shape=``) against the plain version on the same
    window on the card, bitwise, in every variant: 4 x-blocks of a 256 x 96 x 96 vortex field, each block's
    halo one step's reach, one step of 200,000 lines a block."""
    gen = torch.Generator().manual_seed(181)
    shape = (256, 96, 96)
    dx = [1.0 / s for s in shape]
    x, y = (torch.arange(n, dtype=torch.float64) + 0.5 for n in shape[:2])
    X = (x * dx[0])[:, None, None].expand(shape)
    Y = (y * dx[1])[None, :, None].expand(shape)
    vec = torch.stack([1.0 + 0.3 * torch.sin(2 * np.pi * Y),
                       0.5 * torch.cos(2 * np.pi * X) + 0.2,
                       0.3 * torch.sin(2 * np.pi * (X + Y))]).to(dev)
    h = 0.9 * dx[0]
    core, halo = shape[0] // SHARDS, int(np.ceil(h / dx[0])) + 2
    out, worst = {}, 0.0
    for tag, (fdt, pdt) in MARCH_VARIANTS.items():
        for b in range(SHARDS):
            lo = max(0, b * core - halo)
            hi = min(shape[0], (b + 1) * core + halo)
            field = mk.prepare_field(vec[:, lo:hi].to(fdt))
            u = torch.rand((200_000, 3), generator=gen, dtype=torch.float64)
            seeds = torch.stack([(b * core + u[:, 0] * core) * dx[0],
                                 u[:, 1], u[:, 2]], 1).to(dev, pdt)
            dirs = torch.where(u[:, 0] < 0.5, 1.0, -1.0).to(dev, pdt)
            k = mk.march(field, [0.0] * 3, dx, h, seeds, 1, dirs, (lo, 0, 0),
                         shape)
            p = mk.march_torch(field, [0.0] * 3, dx, h, seeds, 1, dirs,
                               (lo, 0, 0), shape)
            torch.cuda.synchronize()
            if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
                raise AssertionError(f"march {tag} block {b} differs from "
                                     "plain")
            worst = max(worst, float((k[0] - p[0]).abs().max()))
        out[tag] = {"lines": 200_000, "blocks": SHARDS,
                    "ms": cuda_ms(lambda: mk.march(
                        field, [0.0] * 3, dx, h, seeds, 1, dirs, (lo, 0, 0),
                        shape), n=5)}
    out["max_abs_err"] = worst
    return out


def phase_sharded(tmp: str, dev) -> tuple:
    """ndevices=4 (2 x 2 blocks, every shard on the one card) against
    ndevices=1 at production size and on the sparse parity case, partStream
    with the production seeds, the smoothed curvature (``sharded_smooth``),
    a DIM=2 hierarchy (``sharded_dim2``) and the isosurface's distance
    (``sharded_distance``), and the kernels held to their plain versions at
    the sharded paths' shapes."""
    t0 = time.perf_counter()
    plt = os.path.join(tmp, "p17_plt")
    sparse = os.path.join(tmp, "plt_sparse")
    mef = os.path.join(tmp, "seeds_prod_tools.mef")
    cwd = os.getcwd()
    os.chdir(tmp)
    counted = {k: 0 for k in counts()}
    zero = dict(counted)
    held = HeldAgainstPlain()
    try:
        meta = load_plotfile_fabs(plt, ["temp"])[0]
        mesh = make_spatial_mesh(SHARDS, (2, 2), "cuda")
        layout = {
            "grad": window_levels(meta, mesh, stencil_halo(
                GRAD_STAGES, "quadratic"), torch.float32),
            "curvature": window_levels(meta, mesh, stencil_halo(
                CURVATURE_STAGES, "quadratic"), torch.float32),
            "isosurface": window_levels(meta, mesh, ISO_HALO, torch.float64)}
        tools = {
            "grad": sharded_runs("prod", ["grad", f"infile={plt}",
                                          "gradVar=temp"], "outfile", "",
                                 counted, {**zero, "grad_mag": layout[
                                     "grad"]["window_levels"]}, held=held),
            "curvature": sharded_runs(
                "prod", ["curvature", f"infile={plt}", "progressName=temp",
                         "do_gaussCurv=1"], "outfile", "", counted,
                {**zero, "grad_mag": 7 * layout["curvature"][
                    "window_levels"]}, held=held),
            "isosurface": sharded_runs(
                "prod", ["isosurface", f"infile={plt}", "isoCompName=temp",
                         "isoVal=1000"], "outfile_base", ".mef", counted,
                zero),
            "partStream": sharded_runs(
                "prod", ["partStream", f"infile={plt}", f"isoFile={mef}",
                         *PART_KEYS], "outFile", "", counted,
                keys=SHARD_KEYS[:1], held=held)}
        smeta = load_plotfile_fabs(sparse, ["temp"])[0]
        n_cl = len(cluster_boxes(smeta.bas[-1]))
        # the clustered path: the clusters dealt over a 1-D mesh
        one_d = SHARD_KEYS[:1]
        tools["sparse"] = {
            "grad": sharded_runs("sparse", ["grad", f"infile={sparse}",
                                            "gradVar=temp"], "outfile", "",
                                 counted, {**zero, "grad_mag": 1 + n_cl},
                                 one_d, held),
            "curvature": sharded_runs(
                "sparse", ["curvature", f"infile={sparse}",
                           "progressName=temp"], "outfile", "", counted,
                {**zero, "grad_mag": 7 + 14 * n_cl}, one_d, held),
            "isosurface": sharded_runs(
                "sparse", ["isosurface", f"infile={sparse}",
                           "isoCompName=temp", f"isoVal={SPARSE_ISO}"],
                "outfile_base", ".mef", counted, zero, one_d)}
        t1 = time.perf_counter()
        tools["curvature_smooth"] = sharded_smooth(plt, counted, zero, held,
                                                   mesh)
        tools["curvature_smooth"]["seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        tools["dim2"] = sharded_dim2(tmp, counted, zero, held, mesh)
        tools["dim2"]["seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        tools["distance"] = sharded_distance(plt, counted, zero)
        tools["distance"]["seconds"] = time.perf_counter() - t1
    finally:
        os.chdir(cwd)
    if counted["stream_march"] == 0 or (counted["stream_march_order_key"]
                                        != counted["stream_march"]):
        raise AssertionError(f"sharded partStream launches: {counted}")
    kernels = ("grad_mag", "stream_march", "stream_march_order_key")
    missing = [k for k in kernels if held.seen[k]["calls"] == 0]
    if missing:
        raise AssertionError(f"sharded runs held no call of {missing}")
    halo = halo_grad_vs_plain(dev)
    windows = march_blocks_vs_plain(dev)
    emit({"phase": "sharded", "shards": SHARDS, "keys": SHARD_KEYS,
          "case": PROD_CASE, "cells": sum(ba.total_cells()
                                          for ba in meta.bas),
          "sparse_clusters": n_cl, "layout": layout, "tools": tools,
          "launches": counted,
          "kernels_vs_plain": {"tolerance": "as phases 3 and 3b",
                               "calls": held.report()},
          "halo_grad_vs_plain": {"tolerance": "gradients bitwise, "
                                 "magnitude <= 1 ulp", **halo},
          "march_blocks_vs_plain": {"tolerance": "bitwise", **windows},
          "seconds": time.perf_counter() - t0})
    err = {k: held.seen[k]["max_abs_err"] for k in kernels}
    err["grad_mag"] = max([err["grad_mag"]]
                          + [v["max_abs_err"] for v in halo.values()])
    err["stream_march"] = max(err["stream_march"], windows["max_abs_err"])
    return counted, err


def main() -> int:
    t_start = time.perf_counter()
    spent = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        spent[name] = time.perf_counter() - t
        return out

    smi = phase_device()
    dev = torch.device("cuda")
    timed("build", phase_build)
    kern = timed("kernel", phase_kernel, dev)
    march = timed("march", phase_march_kernel, dev)
    stats_k = timed("stats", phase_stats_kernel, dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        launches = timed("main", phase_main, tmp)
        stream = timed("stream", phase_stream, tmp)
        timed("prod", phase_prod, tmp, dev)
        timed("stream_prod", phase_stream_prod, tmp, dev)
        timed("cpu", phase_cpu, tmp, dev)
        timed("stream_cpu", phase_stream_cpu, stream, dev)
        iso = timed("iso", phase_iso, tmp, dev)
        timed("iso_cpu", phase_iso_cpu, iso, dev)
        timed("iso_prod", phase_iso_prod, tmp, dev)
        timed("main_path", phase_main_path, tmp, dev)
        timed("smooth", phase_smooth, tmp, dev)
        stats_launches, stats_err = timed("stats_tools", phase_stats, tmp,
                                          dev)
        timed("host_io", phase_host_io, tmp, dev)
        sparse, sparse_err = timed("sparse", phase_sparse, tmp)
        sparse_err["grad_mag"] = max(
            sparse_err["grad_mag"],
            timed("sparse_scale", phase_sparse_scale, tmp, dev))
        tools8, tools8_err = timed("tools8", phase_tools8, tmp, stream, dev)
        tools84 = timed("tools84", phase_tools84, tmp, stream, dev)
        tools86 = timed("tools86", phase_tools86, tmp, stream)
        tools88 = timed("tools88", phase_tools88, tmp, dev)
        pipe, pipe_err = timed("pipeline", phase_pipeline, tmp, stream, dev)
        shard, shard_err = timed("sharded", phase_sharded, tmp, dev)
    for k, err in stats_err.items():
        stats_k[k]["max_abs_err"] = max(stats_k[k]["max_abs_err"], err)
    # the kernels held at the sparse paths' shapes (phases 12 and 12b) and
    # at the tools8 phase's (13)
    kern["max_abs_err"] = max(kern["max_abs_err"], sparse_err["grad_mag"],
                              tools8_err["grad_mag"], pipe_err["grad_mag"],
                              shard_err["grad_mag"])
    march["max_abs_err"] = max(march["max_abs_err"],
                               sparse_err["stream_march"],
                               tools8_err["stream_march"],
                               pipe_err["stream_march"],
                               shard_err["stream_march"])
    march["key"]["max_abs_err"] = max(march["key"]["max_abs_err"],
                                      tools8_err["stream_march_order_key"],
                                      pipe_err["stream_march_order_key"],
                                      shard_err["stream_march_order_key"])
    for k in ("binned", "joint"):
        stats_k[k]["max_abs_err"] = max(stats_k[k]["max_abs_err"],
                                        sparse_err[f"stats_{k}"],
                                        pipe_err[f"stats_{k}"])
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_seconds": spent})
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "grad_mag", "route": "cuda",
        "source": "peleanalysis_tpu_torch/csrc/grad_mag.cu",
        "replaces": "peleanalysis_tpu/ops/pallas_kernels.py:36",
        "launches": launches, "launches_sparse": sparse["grad_mag"],
        "launches_tools8": tools8["grad_mag"],
        "launches_tools84": tools84["grad_mag"],
        "launches_tools86": tools86["grad_mag"],
        "launches_tools88": tools88["grad_mag"],
        "launches_pipeline": pipe["grad_mag"],
        "launches_sharded": shard["grad_mag"],
        **{k: kern[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}}, {
        "name": "stream_march", "route": "cuda",
        "source": "peleanalysis_tpu_torch/csrc/stream_march.cu",
        "replaces": "peleanalysis_tpu/stream/pallas_march.py:72",
        "launches": stream["launches"]["stream_march"],
        "launches_sparse": sparse["stream_march"],
        "launches_tools8": tools8["stream_march"],
        "launches_tools84": tools84["stream_march"],
        "launches_tools86": tools86["stream_march"],
        "launches_tools88": tools88["stream_march"],
        "launches_pipeline": pipe["stream_march"],
        "launches_sharded": shard["stream_march"],
        **{k: march[k] for k in ("max_abs_err", "ms", "batch_ms", "plain_ms",
                                 "bound_ms", "bound_by")},
        "library_ms": None}, {
        # part of the march's port: the locality order of a float64 march
        "name": "stream_march_order_key", "route": "cuda",
        "source": "peleanalysis_tpu_torch/csrc/stream_march.cu",
        "replaces": "peleanalysis_tpu/stream/pallas_march.py:72",
        "launches": stream["launches"]["stream_march_order_key"],
        "launches_sparse": sparse["stream_march_order_key"],
        "launches_tools8": tools8["stream_march_order_key"],
        "launches_tools84": tools84["stream_march_order_key"],
        "launches_tools86": tools86["stream_march_order_key"],
        "launches_tools88": tools88["stream_march_order_key"],
        "launches_pipeline": pipe["stream_march_order_key"],
        "launches_sharded": shard["stream_march_order_key"],
        **{k: march["key"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by")},
        "library_ms": None}, {
        # no Pallas kernel: the XLA one-hot contractions of binned_stats
        "name": "stats_binned", "route": "cuda",
        "source": "peleanalysis_tpu_torch/csrc/stats_hist.cu",
        "replaces": "peleanalysis_tpu/ops/stats.py:30",
        "launches": stats_launches["stats_binned"],
        "launches_sparse": sparse["stats_binned"],
        "launches_tools84": tools84["stats_binned"],
        "launches_tools86": tools86["stats_binned"],
        "launches_tools88": tools88["stats_binned"],
        "launches_pipeline": pipe["stats_binned"],
        "launches_sharded": shard["stats_binned"], **stats_k["binned"]}, {
        # no Pallas kernel: the one-hot contractions of joint_pdf(_multi)
        "name": "stats_joint", "route": "cuda",
        "source": "peleanalysis_tpu_torch/csrc/stats_hist.cu",
        "replaces": "peleanalysis_tpu/ops/stats.py:184",
        "launches": stats_launches["stats_joint"],
        "launches_sparse": sparse["stats_joint"],
        "launches_tools84": tools84["stats_joint"],
        "launches_tools86": tools86["stats_joint"],
        "launches_tools88": tools88["stats_joint"],
        "launches_pipeline": pipe["stats_joint"],
        "launches_sharded": shard["stats_joint"], **stats_k["joint"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
