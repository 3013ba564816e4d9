"""Nothing the harness runs loads JAX or the JAX package, compared by whole
top-level names; the reference loads nothing of the program."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
import types

from portbench import spec
from portbench.serve_child import forbidden_modules

ROOT = os.path.dirname(spec.HERE)


def _imports(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(spec.HERE, sub)):
        if os.sep + "tests" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("peleanalysis_tpu_torch", "peleanalysis_tpu_torch.cli",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not set(forbidden_modules()) & {"jaxtyping", "flaxen",
                                           "peleanalysis_tpu_torch"}
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("j"))
    monkeypatch.setitem(sys.modules, "peleanalysis_tpu.cli",
                        types.ModuleType("p"))
    assert {"jax", "peleanalysis_tpu"} <= set(forbidden_modules())


def test_harness_sources_import_no_jax():
    bad = {"jax", "jaxlib", "flax", "peleanalysis_tpu"}
    for path in _sources():
        assert not set(_imports(path)) & bad, path


def test_reference_imports_nothing_of_the_program():
    """The references, the kinds' generators and reference states, and
    the checks."""
    paths = [p for sub in ("reference", "kinds", "checks")
             for p in _sources(sub)]
    assert len(paths) >= 6
    for path in paths:
        assert "peleanalysis_tpu_torch" not in set(_imports(path)), path
        assert "peleanalysis_tpu" not in set(_imports(path)), path


def test_harness_process_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.harness, portbench.control, "
            "peleanalysis_tpu_torch.cli; "
            "from portbench.serve_child import forbidden_modules; "
            "print(forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert out.strip() == "[]"


def test_run_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench, a run
    exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "flame-series", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
