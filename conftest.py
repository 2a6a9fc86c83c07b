"""How pytest-xdist hands test files to its workers.

Under ``--dist loadfile`` every test file is one work unit, so one worker runs
all of its tests in turn. ``tests/test_fused.py`` holds the JAX package's 20
Pallas interpret-mode tests, ~2,800 s one after another on one worker, past
the suite's 1,470 s limit while the other workers sit idle. Each test of the
files in ``SPLIT_FILES`` is therefore its own work unit; every other file stays
whole on one worker. The file itself is not split into smaller files because
it belongs to the JAX reference, which predates the PyTorch port and is kept
as it was.

This file loads before ``tests/conftest.py`` sets JAX to the CPU, so it imports
neither torch nor JAX.
"""

import pytest

SPLIT_FILES = ("tests/test_fused.py",)


def work_unit(nodeid):
    """The xdist work unit of ``nodeid`` under ``--dist loadfile``."""
    path = nodeid.split("::", 1)[0]
    return nodeid if path in SPLIT_FILES else path


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getoption("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitFileScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return work_unit(nodeid)

    return SplitFileScheduling(config, log)
