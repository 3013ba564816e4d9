"""The stats histogram kernel (``csrc/stats_hist.cu``) against an earlier
version of its source, in turns on one CUDA card.  Run from the repository
root:

    mkdir -p build                       # gitignored
    git show 3495674:peleanalysis_tpu_torch/csrc/stats_hist.cu \\
        > build/stats_hist_old.cu
    python3 stats_variants.py --old build/stats_hist_old.cu

The --old source must have that commit's C interface (the parameter structs
of ``OldBinnedParams`` / ``OldJointParams`` below).  Five configurations,
float32: binned moments of one averaged component in 64 bins, the same with
min/max, the joint pdf of one pair in 64 bins, of three pairs, and of one
pair in 256 bins.  Two inputs:
  random - the 19,447,296 cells of chip_smoke.py phase 3c (stats_fields,
           seed 2: a third of them on bin edges or one ulp from them);
  smooth - the production plotfile of phase 10 (3 levels, 128^3, 128^3 and a
           248^3 patch of testing.default_fields), level by level as the
           tools call the kernel: one "call" is the three levels' calls.
Two columns:
  old - the --old source, built with ops/cuda_build.py's nvcc flags into
        build/stats_variants/ and called as its wrapper called it;
  new - ops/stats_kernels.binned_moments / joint_hist.
Each column is held against the plain version with phase 3c's tolerances
(chip_smoke.check_stats).  Times are CUDA events: per call (around one
call, the host's work before its launches included, median of 10) and per
batch (the mean over 10 back-to-back calls, median of 5), taken in turns
(old, new, new, old) three times.  Then each column's device time by
kernel name under torch.profiler (10 calls in one window held whole by
chip_smoke.profiled), the bytes bound and each time's share of it, the
registers and shared memory of every kernel (ptxas) and the SASS opcodes
of each (cuobjdump).  Prints JSON lines and writes them all to --out.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs
from peleanalysis_tpu_torch.amr.dense import DenseAmrState
from peleanalysis_tpu_torch.ops import cuda_build
from peleanalysis_tpu_torch.ops import stats_kernels as sk
from peleanalysis_tpu_torch.testing import (default_fields,
                                            write_synthetic_plotfile)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "stats_variants")
OLD_MAXC, OLD_MAXV, OLD_MAXP, OLD_THREADS = 32, 16, 120, 512


class OldBinnedParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong), ("ncomp", ctypes.c_int),
                ("nbins", ctypes.c_int), ("clamp", ctypes.c_int),
                ("minmax", ctypes.c_int), ("has_w", ctypes.c_int),
                ("nblocks", ctypes.c_int), ("divide", ctypes.c_int),
                ("wscal", ctypes.c_double), ("lo", ctypes.c_double),
                ("scale", ctypes.c_double), ("bin_ptr", ctypes.c_ulonglong),
                ("avg_ptr", ctypes.c_ulonglong * OLD_MAXC),
                ("w_ptr", ctypes.c_ulonglong), ("mask_ptr", ctypes.c_ulonglong),
                ("shift_ptr", ctypes.c_ulonglong)]


class OldJointParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong), ("nv", ctypes.c_int),
                ("npairs", ctypes.c_int), ("nbins", ctypes.c_int),
                ("has_w", ctypes.c_int), ("nblocks", ctypes.c_int),
                ("divide", ctypes.c_int), ("wscal", ctypes.c_double),
                ("lo", ctypes.c_double * OLD_MAXV),
                ("scale", ctypes.c_double * OLD_MAXV),
                ("pi", ctypes.c_int * OLD_MAXP), ("pj", ctypes.c_int * OLD_MAXP),
                ("v_ptr", ctypes.c_ulonglong * OLD_MAXV),
                ("w_ptr", ctypes.c_ulonglong), ("mask_ptr", ctypes.c_ulonglong),
                ("shift_ptr", ctypes.c_ulonglong)]


def nvcc_build(src: str, name: str):
    """(library, ptxas report per kernel: registers, shared bytes) of a
    source built with the port's nvcc flags into build/stats_variants/."""
    os.makedirs(OUT_DIR, exist_ok=True)
    so = os.path.join(OUT_DIR, f"lib{name}.so")
    res = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                          src], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    report = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'[^\n]*\n"
                         r"(?:[^\n]*\n)*?[^\n]*Used (\d+) registers"
                         r"([^\n]*)", res.stdout + res.stderr):
        smem = re.search(r"(\d+) bytes smem", m.group(3))
        report[demangle(m.group(1))] = {
            "registers": int(m.group(2)),
            "static_smem": int(smem.group(1)) if smem else 0}
    return ctypes.CDLL(so), so, report


def demangle(name: str) -> str:
    """A kernel's name, mangled or as the profiler prints it, cut to its
    function and template arguments (enough to tell instantiations
    apart)."""
    m = re.match(r"_Z(\d+)", name)
    if not m:
        return re.sub(r"^void ", "", name).split("(")[0]
    end = m.end() + int(m.group(1))
    fn, rest = name[m.end():end], name[end:]
    return f"{fn}<{rest[1:rest.find('EE')]}>" if rest.startswith("I") else fn


def sass_counts(so: str) -> dict:
    """Static SASS opcode counts of each kernel in a built library
    (cuobjdump): the total, the atomics and the twelve commonest."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = demangle(func.split("\n", 1)[0].strip())
        ops = collections.Counter(
            m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                func))
        atoms = {k: v for k, v in ops.items()
                 if k.startswith(("ATOM", "RED", "ATOMS"))}
        short = collections.Counter()
        for k, v in ops.items():
            short[k.split(".")[0]] += v
        out[name] = {"instructions": sum(ops.values()), "atomics": atoms,
                     "top": dict(short.most_common(12))}
    return out


# ---------------------------------------------------------------------------
# the old source's calls, as its wrapper (ops/stats_kernels.py at 3495674)
# made them
def old_sig(lib):
    ptrs = [ctypes.c_void_p] * 7
    for name, args in (
            ("stats_binned_f32", [OldBinnedParams, ctypes.c_int, *ptrs,
                                  ctypes.c_void_p]),
            ("stats_joint_f32", [OldJointParams, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int


def old_blocks(n: int, target: int) -> int:
    return max(1, min(-(-n // (8 * OLD_THREADS)), target),
               -(-n // ((1 << 24) - 1)))


def old_binned(lib, bv, av, weight, mask, edges, nbins, clamp, minmax,
               shift):
    """3495674's _launch_binned for a scalar weight and one call (ncomp <=
    32): the same grid, scratch and outputs."""
    dev, T = bv.device, bv.dtype
    n, ncomp = bv.numel(), av.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    es = 4
    shared = (es * nbins * (1 + 2 * ncomp)
              + (2 * es * nbins * ncomp if minmax else 0)
              <= sk.max_shared_bytes())
    nblocks = old_blocks(n, 4 * sms) if shared else \
        max(1, min(-(-n // OLD_THREADS), 8 * sms))
    wscal = float(torch.tensor(float(weight), dtype=T))
    p = OldBinnedParams(n=n, ncomp=ncomp, nbins=nbins, clamp=int(clamp),
                        minmax=int(minmax), has_w=0, nblocks=nblocks,
                        divide=int(edges[2]), wscal=wscal, lo=edges[0],
                        scale=edges[1], bin_ptr=bv.data_ptr(), w_ptr=0,
                        mask_ptr=mask.data_ptr(), shift_ptr=shift.data_ptr())
    comps = [av[k].contiguous() for k in range(ncomp)]
    for k, c in enumerate(comps):
        p.avg_ptr[k] = c.data_ptr()
    nacc, nmm = nbins * (1 + 2 * ncomp), nbins * ncomp
    if shared:
        scratch = torch.empty((nblocks, nacc), dtype=T, device=dev)
        mm = torch.empty((nblocks, 2, nmm) if minmax else (0,),
                         dtype=torch.int32, device=dev)
    else:
        scratch = torch.empty(nacc, dtype=torch.float64, device=dev)
        mm = torch.empty((2, nmm) if minmax else (0,), dtype=torch.int32,
                         device=dev)
    hits = torch.empty(nbins, dtype=T, device=dev)
    sums = torch.empty((nbins, ncomp), dtype=T, device=dev)
    sumsq = torch.empty((nbins, ncomp), dtype=T, device=dev)
    mins = torch.empty((nbins, ncomp) if minmax else (0,), dtype=T,
                       device=dev)
    maxs = torch.empty_like(mins)
    err = lib.stats_binned_f32(p, int(shared), scratch.data_ptr(),
                               mm.data_ptr(), hits.data_ptr(),
                               sums.data_ptr(), sumsq.data_ptr(),
                               mins.data_ptr(), maxs.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"old stats_binned: cudaError {err}")
    # the old dispatcher's torch.cat of its one part
    cat = [torch.cat([t], dim=1) for t in
           ((sums, sumsq, mins, maxs) if minmax else (sums, sumsq))]
    return (hits, *cat) if minmax else (hits, *cat, None, None)


def old_joint(lib, vals, weight, mask, edges, nbins, pairs, shifts):
    """3495674's joint_hist / _launch_joint for a scalar weight (<= 120
    pairs): the same grid, scratch and outputs."""
    dev, T = vals[0].device, vals[0].dtype
    n, P = vals[0].numel(), len(pairs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shared = 3 * nbins * nbins * 4 <= sk.max_shared_bytes()
    nblocks = old_blocks(n, max(1, 2 * sms // P)) if shared else \
        max(1, min(-(-n // OLD_THREADS), max(1, 8 * sms // P)))
    wscal = float(torch.tensor(float(weight), dtype=T))
    sh = shifts.to(T).contiguous()
    p = OldJointParams(n=n, nv=len(vals), npairs=P, nbins=nbins, has_w=0,
                       nblocks=nblocks, divide=int(edges[0][2]), wscal=wscal,
                       w_ptr=0, mask_ptr=mask.data_ptr(),
                       shift_ptr=sh.data_ptr())
    for k, (v, e) in enumerate(zip(vals, edges)):
        p.v_ptr[k] = v.data_ptr()
        p.lo[k], p.scale[k] = e[0], e[1]
    for q, (i, j) in enumerate(pairs):
        p.pi[q], p.pj[q] = i, j
    nb2 = nbins * nbins
    scratch = (torch.empty((P, nblocks, 3 * nb2), dtype=T, device=dev)
               if shared else
               torch.empty((P, 3 * nb2), dtype=torch.float64, device=dev))
    out = torch.empty((3, P, nbins, nbins), dtype=T, device=dev)
    err = lib.stats_joint_f32(p, int(shared), scratch.data_ptr(),
                              out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"old stats_joint: cudaError {err}")
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
def random_inputs(dev):
    (v0, v1, v2), mask = cs.stats_fields(cs.PROD_CELLS, torch.float32, dev, 2)
    return [([v0, v1, v2], mask, 8.0,
             torch.tensor([0.5], device=dev),
             torch.tensor([1000.0, 0.5, 0.7], device=dev))]


def smooth_inputs(dev, tmp: str):
    """The production plotfile's levels: [temp, progress, density] (the
    binned entry bins temp and averages progress), the valid masks, the
    tools' weights 8^-lev and shifts (masked means)."""
    f = default_fields()
    plt = os.path.join(tmp, "plt_stats_production")
    write_synthetic_plotfile(plt, fields={k: f[k] for k in (
        "temp", "progress", "density")}, **cs.PROD_CASE)
    ds = DenseAmrState.from_plotfile(plt, dev, names=["temp", "progress",
                                                      "density"])
    out = []
    for lev, d in enumerate(ds.data):
        vals = [d[ds.comp(n)] for n in ("temp", "progress", "density")]
        m = ds.valid_mask(lev)
        sh = torch.stack([v[m].mean() for v in vals])
        out.append((vals, m, 8.0 ** -lev, sh[1:2].clone(), sh))
    return out


def summary(v) -> dict:
    return {"median_ms": statistics.median(v), "min_ms": min(v),
            "max_ms": max(v)}


def device_split(fn) -> dict:
    """Device ms per call of fn (10 calls in one profiled window) by kernel
    name, and their sum."""
    def ten():
        for _ in range(10):
            fn()
    _, _, evs, whole = cs.profiled(ten)
    by = collections.defaultdict(float)
    for e in evs:
        by[demangle(e.name())] += (e.end_ns() - e.start_ns()) / 1e7
    return {"device_ms": sum(by.values()), "by_kernel": dict(by),
            "trace_whole": whole}


def run_case(case: str, inputs, old_lib) -> dict:
    res = {}
    for config in cs.STATS_CONFIGS:
        calls, nbytes = {}, 0
        per_level = []
        for vals, mask, w, shb, shj in inputs:
            entry, args, b = cs.stats_config_call(vals, mask, w, shb, shj,
                                                  config)
            nbytes += b
            per_level.append((entry, args))
        entry = per_level[0][0]
        plain = sk.binned_moments_torch if entry == "binned" \
            else sk.joint_hist_torch
        new = sk.binned_moments if entry == "binned" else sk.joint_hist
        old = (lambda *a: old_binned(old_lib, *a)) if entry == "binned" \
            else (lambda *a: old_joint(old_lib, *a))
        calls = {"old": lambda: [old(*a) for _, a in per_level],
                 "new": lambda: [new(*a) for _, a in per_level]}
        errs = {}
        refs = [plain(*a) for _, a in per_level]
        for col, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            errs[col] = max(cs.check_stats(k, p, torch.float32,
                                           f"{case} {config} {col}")[1]
                            for k, p in zip(got, refs))
        del refs
        per_call = {k: [] for k in calls}
        batch = {k: [] for k in calls}
        for _ in range(3):
            for k in ("old", "new", "new", "old"):
                per_call[k].append(cs.cuda_ms(calls[k], n=10, warmup=2))
                batch[k].append(cs.batch_ms(calls[k], reps=5, warmup=1))
        bound_ms, bound_by = cs.bound(nbytes, 0.0, torch.float32)
        out = {"bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
               "levels": len(per_level)}
        for col in calls:
            split = device_split(calls[col])
            pc, bt = summary(per_call[col]), summary(batch[col])
            out[col] = {"max_err_over_scale": errs[col], "per_call": pc,
                        "batch": bt, **split,
                        "share_of_bound": {
                            "per_call": bound_ms / pc["median_ms"],
                            "batch": bound_ms / bt["median_ms"],
                            "device": bound_ms / split["device_ms"]}}
        res[config] = out
        print(json.dumps({"case": case, "config": config, "bound_ms":
                          bound_ms, **{c: {
                              "per_call": out[c]["per_call"]["median_ms"],
                              "batch": out[c]["batch"]["median_ms"],
                              "device": out[c]["device_ms"],
                              "by_kernel": out[c]["by_kernel"],
                              "err": out[c]["max_err_over_scale"]}
                              for c in calls}}), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="an earlier stats_hist.cu (3495674's C interface)")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "results.json"),
                    help="where to write the results (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stats_variants.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    old_lib, old_so, old_rep = nvcc_build(args.old, "stats_hist_old")
    old_sig(old_lib)
    _, new_so, new_rep = nvcc_build(
        str(cuda_build.CSRC / "stats_hist.cu"), "stats_hist_new")
    sk.load_library()
    dev = torch.device("cuda")
    res = {"device": smi, "torch": torch.__version__,
           "ptxas": {"old": old_rep, "new": new_rep},
           "sass": {"old": sass_counts(old_so), "new": sass_counts(new_so)},
           "cases": {}}
    print(json.dumps({"ptxas": res["ptxas"]}), flush=True)
    print(json.dumps({"sass_atomics": {c: {k: v["atomics"] for k, v in
                                           res["sass"][c].items()}
                                       for c in ("old", "new")}}),
          flush=True)
    res["cases"]["random"] = run_case("random", random_inputs(dev), old_lib)
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        res["cases"]["smooth"] = run_case("smooth", smooth_inputs(dev, tmp),
                                          old_lib)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
