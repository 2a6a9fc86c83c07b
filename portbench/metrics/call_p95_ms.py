"""The 95th percentile of the wall time of every call in the window (host
clock, from entering ``simulation()`` to its return after
``torch.cuda.synchronize()``)."""

from harness import stats


def read(ctx):
    return stats.percentile([wall for _, wall, _ in ctx.calls], 95) * 1e3
