"""Spin-steps completed per second: n_walkers x n_t of every call that
completed in the window, over the window's whole wall time."""

from harness import stats


def read(ctx):
    work = [ctx.n_walkers * ctx.n_t for _ in ctx.calls]
    return stats.rate(work, ctx.window_s)
