"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: ``disimpy_tpu_torch`` begins with ``disimpy_tpu`` and is another
package."""

import ast
import os
import subprocess
import sys

import pytest

import run
from harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "disimpy_tpu"}
PROGRAM = "disimpy_tpu_torch"


def _modules():
    for dirpath, dirnames, files in os.walk(manifest.BENCH_DIR):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, manifest.BENCH_DIR))
def test_no_jax_anywhere(path):
    assert not _imported(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(manifest.BENCH_DIR, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            imported = _imported(os.path.join(ref, name))
            assert PROGRAM not in imported
            assert imported <= {"math", "numpy", "torch"}


def test_the_run_time_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "disimpy_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "disimpy_tpu.engine", sys)
    assert run.forbidden_modules() == ["disimpy_tpu"]


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the command exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(manifest.root_of(), "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".home", ".cache", "out"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cylinder.fused",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
