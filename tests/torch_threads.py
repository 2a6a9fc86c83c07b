"""Torch's thread count in pytest-xdist workers, for the port's tests.

Every ``test_torch_*.py`` imports this module for its effect. Under xdist,
each worker's torch would open OpenMP regions on all cores at once, and the
workers then wait on threads that are not running: a plain-torch fused epoch
measured 16 s on 8 threads and 0.25 s on 1 on a loaded 8-core box. So each
worker gets its share of the cores the process may use. A single-process run
keeps torch's default.
"""

import os

import torch


def threads_per_worker():
    """Torch threads for one xdist worker, or None outside xdist."""
    n_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if n_workers is None:
        return None
    if hasattr(os, "sched_getaffinity"):
        cores = len(os.sched_getaffinity(0))
    else:
        cores = os.cpu_count() or 1
    return max(1, cores // int(n_workers))


if threads_per_worker() is not None:
    torch.set_num_threads(threads_per_worker())
