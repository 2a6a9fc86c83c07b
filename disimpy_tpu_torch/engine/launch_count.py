"""Launch counts of the port's CUDA kernels.

``counts`` maps each kernel's name to its launches since import (or since
:func:`reset`). A kernel's wrapper calls :func:`add` where it launches the
kernel and nowhere else, so a run can show that its main path went through
the kernel. A launch made while the current CUDA stream captures a graph
runs only when the graph is replayed: it goes into the tally that
:func:`capture` opened in this thread, and the graph's owner adds that
tally at each replay (:func:`replayed`). A launch captured with no tally
open is not counted.
"""

import collections
import contextlib
import threading

import torch

KERNELS = ("fused_epoch", "krng_draw", "mesh_hit", "analytic_step",
           "mesh_later", "mesh_bounce", "mesh_cell", "mesh_cell_later")
counts = dict.fromkeys(KERNELS, 0)
# Guards the counts: the parts of a split run launch from several threads.
_lock = threading.Lock()
_open = threading.local()


def add(name):
    """Count one launch of kernel ``name``."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        tally = getattr(_open, "tally", None)
        if tally is not None:
            tally[name] += 1
        return
    with _lock:
        counts[name] += 1


def reset():
    """Set every count to 0."""
    with _lock:
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def capture():
    """Collect the launches captured in this thread into a Counter, which
    is yielded: the launches that one replay of the graph makes."""
    tally = _open.tally = collections.Counter()
    try:
        yield tally
    finally:
        _open.tally = None


def replayed(tally):
    """Count the launches of one replay of a graph whose capture tallied
    ``tally``."""
    with _lock:
        for name, k in tally.items():
            counts[name] += k
