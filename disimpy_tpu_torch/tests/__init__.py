"""Test runner for the port: the counterpart of ``disimpy_tpu.tests``.

The port's tests are the repository's ``tests/test_torch_*.py`` files, so
:func:`test_all` works from a repository checkout only.
"""

import glob
import os

__all__ = ["test_all"]


def test_all(extra_args=()):
    """Run the port's tests (``tests/test_torch_*.py``) with pytest and
    return its exit code.

    ``extra_args`` are more pytest arguments (e.g. ``["-x", "-q"]``). On a
    machine without a GPU the tests run the kernels' plain versions.
    Raises ``RuntimeError`` when the package is not inside a checkout.
    """
    import pytest

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    files = sorted(glob.glob(os.path.join(root, "tests", "test_torch_*.py")))
    if not files:
        raise RuntimeError(
            "cannot find tests/test_torch_*.py next to the package; run "
            "pytest from a repository checkout instead"
        )
    return pytest.main([*files, *extra_args])
