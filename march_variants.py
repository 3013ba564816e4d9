"""``march()`` against an earlier version of the streamline-march kernel, at
the production shape of chip_smoke.py phase 3b (260,104 lines x 25 steps
over a 276^3 field).  Needs one CUDA card; run from the repository root:

    mkdir -p build                       # gitignored
    git show <commit>:peleanalysis_tpu_torch/csrc/stream_march.cu \\
        > build/stream_march_old.cu
    python3 march_variants.py --old build/stream_march_old.cu

Three columns, each checked bitwise against march_torch:
  old      - the --old source, built with ops/cuda_build.py's nvcc flags
             into build/march_variants/ and called as its march() called
             it: the field unpadded, [SX, SY, SZ, 3], and no line order;
  new      - march() itself;
  flipped  - the new kernel with the locality order flipped where the
             positions are float64: off where march_kernels.ORDERED sorts,
             on where it does not.
Times are CUDA events, per call (around one call, the host's work before
its launches included) and per batch (the mean over 10 back-to-back
calls), 6 samples of each, taken in turns (old, new, flipped, flipped,
new, old).  Then march()'s device time split under torch.profiler, its
time at half and twice the lines, the registers of each kernel and the
static SASS instruction counts of the new one (cuobjdump).  Prints JSON
lines and writes them all to --out.
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

import torch

import chip_smoke as cs
from peleanalysis_tpu_torch.ops import cuda_build
from peleanalysis_tpu_torch.stream import march_kernels as mk

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "march_variants")
SIG = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 5 + [ctypes.c_double] * 7
       + [ctypes.c_void_p])
OLD_SIG = SIG[:3] + SIG[4:]          # no order argument


def build_old(src: str):
    """(the old source's library, registers of each of its march_kernel
    instantiations from ptxas' report)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    so = os.path.join(OUT_DIR, "libstream_march_old.so")
    res = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                          src], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    regs = re.findall(r"Compiling entry function '\S*march_kernelI(\S+?)"
                      r"EEv\S*'[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used (\d+) "
                      r"registers", res.stdout + res.stderr)
    return ctypes.CDLL(so), {k: int(v) for k, v in regs}


def kernel_call(lib, sig, entry, field, plo, dx, h, seeds, n, dirs,
                ordered: bool):
    """One march through a library's entry point, as march() calls it:
    the outputs, the order (key kernel and torch.argsort) and the launch."""
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = sig, ctypes.c_int
    N, (SX, SY, SZ) = seeds.shape[0], field.shape[:3]

    def call():
        out = torch.empty((n + 1, N, 3), dtype=seeds.dtype,
                          device=seeds.device)
        alive = torch.empty(N, dtype=torch.bool, device=seeds.device)
        order = (torch.argsort(mk.order_key((SX, SY, SZ), plo, dx, seeds,
                                            dirs)) if ordered else None)
        args = [field.data_ptr(), seeds.data_ptr(), dirs.data_ptr()]
        if sig is SIG:
            args.append(None if order is None else order.data_ptr())
        err = fn(*args, out.data_ptr(), alive.data_ptr(), N, n, SX, SY, SZ,
                 *plo, *dx, h, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry}: cudaError {err}")
        return out, alive
    return call


def sass_counts(so: str) -> dict:
    """Static SASS instruction counts of each march_kernel instantiation in
    a built library (cuobjdump): the total and the ten commonest opcodes.
    The kernel body holds the 4 stages of a step once."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        kind = re.search(r"march_kernelI(.+?)EEv", func.split("\n", 1)[0])
        if not kind:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                func))
        out[kind.group(1)] = {"instructions": sum(ops.values()),
                              "top": dict(ops.most_common(10))}
    return out


def summary(v) -> dict:
    return {"median_ms": statistics.median(v), "min_ms": min(v),
            "max_ms": max(v)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="an earlier stream_march.cu to time against")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "results.json"),
                    help="where to write the results (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("march_variants.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    mk.build()
    old_lib, old_regs = build_old(args.old)
    new_lib = mk.load_library()

    dev = torch.device("cuda")
    nc, dxs = 276, 1 / 512
    plo, dx, h, n = (0.5 - 0.5 * nc * dxs,) * 3, (dxs,) * 3, 0.5 / 512, 25
    field64 = cs.radial_gradient((nc,) * 3, plo, dx, dev)

    def lines(n_theta, n_phi):
        pts = torch.from_numpy(cs.sphere_mef(n_theta, n_phi, 0.131)[0])
        k = len(pts)
        return (torch.cat([pts, pts]).to(dev),
                torch.cat([torch.ones(k), -torch.ones(k)]).to(dev,
                                                              torch.float64))

    seeds64, dirs64 = lines(256, 510)
    res = {"device": smi, "lines": seeds64.shape[0], "steps": n,
           "registers": {"old": old_regs, "new": {
               var: mk.kernel_report(*fs)
               for var, fs in cs.MARCH_VARIANTS.items()}},
           "sass": sass_counts(str(mk.library_path())), "variants": {},
           "device_split": {}, "scaling": {}}
    print(json.dumps({"registers": res["registers"], "sass": res["sass"]}),
          flush=True)
    for var, (fdt, sdt) in cs.MARCH_VARIANTS.items():
        s, d = seeds64.to(sdt), dirs64.to(sdt)
        cur = mk.prepare_field(field64.movedim(-1, 0), fdt)
        old_field = field64.to(fdt).contiguous()
        ref = mk.march_torch(cur, plo, dx, h, s, n, d)
        entry = mk._ENTRY[(fdt, sdt)]
        calls = {
            "old": kernel_call(old_lib, OLD_SIG, entry, old_field, plo, dx,
                               h, s, n, d, False),
            "new": lambda: mk.march(cur, plo, dx, h, s, n, d)}
        if sdt == torch.float64:
            calls["flipped"] = kernel_call(
                new_lib, SIG, entry, cur, plo, dx, h, s, n, d,
                (fdt, sdt) not in mk.ORDERED)
        for name, call in calls.items():
            got = call()
            if not (torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                raise AssertionError(f"{name} {var} differs from march_torch")
        per_call = {k: [] for k in calls}
        batch = {k: [] for k in calls}
        for k in calls:
            cs.batch_ms(calls[k], launches=2, reps=1)
        for _ in range(3):
            for k in list(calls) + list(calls)[::-1]:
                per_call[k].append(cs.cuda_ms(calls[k], n=10, warmup=1))
                batch[k].append(cs.batch_ms(calls[k], reps=1, warmup=0))
        res["variants"][var] = {k: {"per_call": summary(per_call[k]),
                                    "batch": summary(batch[k])}
                                for k in calls}
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(10):
                mk.march(cur, plo, dx, h, s, n, d)
            torch.cuda.synchronize()
        ev = prof.key_averages()

        def device_ms(part):
            return sum(e.device_time_total for e in ev if part in e.key) / 1e4
        res["device_split"][var] = {
            "march_kernel_ms": device_ms("march_kernel"),
            "order_key_ms": device_ms("order_key_kernel"),
            "sort_ms": device_ms("RadixSort")}
        if var in ("f64", "bf16_f64"):
            ns = seeds64.shape[0] // 2
            half = (torch.cat([s[:ns // 2], s[ns:ns + ns // 2]]),
                    torch.cat([d[:ns // 2], d[ns:ns + ns // 2]]))
            big = tuple(t.to(sdt) for t in lines(362, 720))
            res["scaling"][var] = {}
            for label, (ss, dd) in (("N/2", half), ("N", (s, d)),
                                    ("2N", big)):
                ss, dd = ss.contiguous(), dd.contiguous()
                res["scaling"][var][label] = {
                    "lines": ss.shape[0], "batch_ms": cs.batch_ms(
                        lambda: mk.march(cur, plo, dx, h, ss, n, dd))}
        print(json.dumps({"variant": var, **{
            k: {m: v[m]["median_ms"] for m in v}
            for k, v in res["variants"][var].items()},
            **res["device_split"][var],
            "scaling": res["scaling"].get(var)}), flush=True)
        del cur, old_field, ref
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
