"""``doctor`` — the port's environment, for support and bug reports.

Counterpart of ``peleanalysis_tpu/tools/doctor.py``: what runs the port
here.  It reports the package path, the torch and numpy versions, whether
CUDA is available and which card (``torch.cuda``), the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, the g++ build of the native host
library (``native.get_lib()``), ``nvcc``, and the nvcc build and load of
the three CUDA kernels (``ops/cuda_build.py``: grad_mag, stream_march,
stats_hist).  Every probe that touches the driver or a compiler runs in a
subprocess with a timeout (``probe_timeout=``, seconds), so the tool never
hangs on the condition it exists to diagnose; on a machine without a card
or ``nvcc`` it says so and exits 0.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

from ..parmparse import ParmParse

_CUDA_PROBE = """
import json, torch
out = {"available": torch.cuda.is_available(),
       "count": torch.cuda.device_count(), "cuda": torch.version.cuda}
if out["available"]:
    out["name"] = torch.cuda.get_device_name(0)
print(json.dumps(out))
"""

_KERNEL_PROBE = """
import json
from peleanalysis_tpu_torch.ops import grad_kernels, stats_kernels
from peleanalysis_tpu_torch.stream import march_kernels
out = {}
for name, mod in (("grad_mag", grad_kernels), ("stream_march", march_kernels),
                  ("stats_hist", stats_kernels)):
    try:
        mod.build()
        mod.load_library()
        out[name] = "OK (" + str(mod.library_path().name) + ")"
    except Exception as e:
        out[name] = "FAILED (" + type(e).__name__ + ": " + str(e)[:200] + ")"
print(json.dumps(out))
"""


def _probe(code: str, timeout: float):
    """(json result, None) of ``code`` run in a fresh interpreter, or
    (None, reason)."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    try:
        r = subprocess.run([sys.executable, "-c", code], timeout=timeout,
                           capture_output=True, text=True, env=env)
    except subprocess.TimeoutExpired:
        return None, f"no answer within {timeout:g}s"
    if r.returncode != 0:
        tail = (r.stderr.strip().splitlines() or ["?"])[-1]
        return None, f"exit {r.returncode}: {tail}"
    return json.loads(r.stdout.strip().splitlines()[-1]), None


def main(args: dict) -> None:
    """CLI: doctor [probe_timeout=120]"""
    import numpy as np
    import torch

    import peleanalysis_tpu_torch

    timeout = ParmParse(args).query_float("probe_timeout", 120.0)
    print("peleanalysis_tpu_torch doctor")
    print(f"  package:   {os.path.dirname(peleanalysis_tpu_torch.__file__)}")
    print(f"  torch:     {torch.__version__} (CUDA build "
          f"{torch.version.cuda})")
    print(f"  numpy:     {np.__version__}")
    cuda, why = _probe(_CUDA_PROBE, timeout)
    if cuda is None:
        print(f"  cuda:      UNAVAILABLE (probe {why})")
    elif not cuda["available"]:
        print("  cuda:      not available (no card; tools need device=cpu)")
    else:
        print(f"  cuda:      available ({cuda['count']} device(s): "
              f"{cuda['name']})")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], timeout=timeout,
                             capture_output=True, text=True)
        card = (smi.stdout.strip() if smi.returncode == 0
                else f"nvidia-smi exit {smi.returncode}")
    except FileNotFoundError:
        card = "nvidia-smi not found"
    except subprocess.TimeoutExpired:
        card = f"nvidia-smi gave no answer within {timeout:g}s"
    print(f"  card:      {card}")
    try:
        from ..native import get_lib
        print(f"  native lib: OK ({os.path.basename(get_lib()._name)})")
    except Exception as e:
        print(f"  native lib: build failed ({type(e).__name__}: {e})")
    from ..ops.cuda_build import nvcc
    try:
        path = nvcc()
    except FileNotFoundError:
        print("  nvcc:      not found (the CUDA kernels cannot be built)")
        return
    print(f"  nvcc:      {path}")
    kernels, why = _probe(_KERNEL_PROBE, timeout)
    if kernels is None:
        print(f"  kernels:   probe failed ({why})")
        return
    for name, state in kernels.items():
        print(f"  kernel {name}: {state}")
