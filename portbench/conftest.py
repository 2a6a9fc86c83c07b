"""pytest settings of the benchmark's own tests (``portbench/tests``).

The ``card`` marker marks a test that needs a CUDA card; the ``card``
fixture skips it, with its reason, where there is none. Whether there is a
card is decided inside the fixture, never while a module is imported.
"""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
for path in (BENCH_DIR, os.path.dirname(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips with a reason without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.fixture
def fresh_home(tmp_path, monkeypatch):
    """An empty HOME, so the program's pack cache starts empty."""
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path
