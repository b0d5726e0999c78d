"""No JAX and no JAX package: in the harness's sources, and in a run."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark import guard

from conftest import REPO

BENCH = Path(REPO) / "benchmark"


def imported_names(path: Path) -> set:
    """Top-level names of every module a Python file imports (absolute
    imports; a relative one stays inside its own package)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(guard.top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(guard.top(node.module))
    return out


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def test_sources_import_no_jax():
    for path in sources():
        found = imported_names(path) & guard.FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        names = imported_names(path)
        assert guard.PROGRAM not in names, path
        assert not names & guard.FORBIDDEN, path
        assert names <= {"__future__", "math", "typing", "numpy", "torch",
                         "benchmark"}, (path, names)


def test_names_compare_whole():
    mods = ["multipathnet_tpu_torch", "multipathnet_tpu_torch.ops.nms",
            "jaxtyping", "flaxen", "torch"]
    assert guard.loaded_jax_modules(mods) == []
    assert guard.loaded_jax_modules(mods + ["jax.numpy", "multipathnet_tpu",
                                            "multipathnet_tpu.ops"]) == [
        "jax.numpy", "multipathnet_tpu", "multipathnet_tpu.ops"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run on the CPU in a fresh process, then sys.modules."""
    code = f"""
import json, sys, time, torch
sys.path[:0] = [{REPO!r}, {str(BENCH / 'tests')!r}]
from conftest import tiny_root
from benchmark import guard, harness
root = tiny_root({str(tmp_path)!r})
harness.run_cell(root, "tiny", 3, 0.05, False, torch.device("cpu"),
                 time.perf_counter())
print(json.dumps([guard.loaded_jax_modules(),
                  "multipathnet_tpu_torch.eval.detect" in sys.modules]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True]


def test_without_the_program_a_run_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and benchmark/ prints no
    result and exits non-zero."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "serve_int8svd_p1000", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
