"""Seconds from the process's start to the first timed call: imports, CUDA,
the kernels' build or load, the substrate, the pack and the warm-up call."""


def read(ctx):
    return ctx.setup_s
