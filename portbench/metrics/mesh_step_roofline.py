"""The classic mesh step's share of its roofline (%): the least time of the
work the inputs need over the device time of the step's kernels, per call.

Kernels summed (csrc/mesh_hit.cu): on the halo layout K2's sort and first
pass (``cell_pass``, ``scan_pass``, ``scatter_pass``, ``hit_pass``) and
K9 (``relist_*``, ``later_pass``, ``bounce_pass``, ``finish_pass``); on
the per-cell layout K10 (``stencil_cells``, ``stencil_sums``,
``stencil_scan``, ``stencil_scatter``, ``stencil_pass``), the second check
(``stencil_recheck``) and the remainder (``bounce_pass``,
``finish_pass``).

Work, counted by the reference's walk of the compared calls: every record
test of a segment against a triangle whose bounding box overlaps the
segment's (52 operations each), and per step each spin's position read and
written and its direction read once, and each tested triangle's record (12
values) read once. The least time of a step is the larger of its bytes
over the memory rate and its operations over the peak; a call's is the sum
over its steps.
"""

import numpy as np

from harness import roofline

KERNELS = ("cell_pass", "scan_pass", "scatter_pass", "hit_pass",
           "relist_cells", "relist_scan", "relist_scatter", "later_pass",
           "bounce_pass", "finish_pass", "stencil_cells", "stencil_sums",
           "stencil_scan", "stencil_scatter", "stencil_pass",
           "stencil_recheck")
FLOPS_PER_TEST = 52
RECORD_VALUES = 12
SPIN_VALUES = 9


def least_call_seconds(tests, records, n_walkers, dtype):
    """Least time of one call from its per-step tests and records."""
    size = 8 if dtype == "float64" else 4
    total = 0.0
    for t, r in zip(tests, records):
        n_bytes = size * (SPIN_VALUES * n_walkers + RECORD_VALUES * int(r))
        total += roofline.least_seconds(n_bytes, FLOPS_PER_TEST * int(t),
                                        dtype)[0]
    return total


def read(ctx):
    from harness.trace import kernel_id

    seconds = sum(s for name, (s, _) in ctx.kernels.items()
                  if kernel_id(name) in KERNELS)
    works = [out.work for out in ctx.reference.values()
             if out.work is not None]
    if not seconds or not works:
        return None
    least = np.mean([least_call_seconds(tests, records, ctx.n_walkers,
                                        ctx.dtype)
                     for tests, records in works])
    return roofline.share(least, seconds / len(ctx.calls))
