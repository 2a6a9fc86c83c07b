"""K1's share of its roofline (%): the least time of the epoch kernel's
work over its device time, per call.

Kernel summed: ``fused_epoch_kernel`` (csrc/fused_epoch.cu). Work: the
64-triangle units that the kernel's counting variant folds on the first
traced call's seed (the same count as its plain version, whatever
implements K1), each 64 x 40 float32 operations; bytes: per epoch the
table read once and each spin's inputs (position, J directions, corner,
four int32 words) and outputs (J positions, J transit counts, one flag).
"""

from harness import roofline

KERNELS = ("fused_epoch_kernel",)
UNIT_TRIANGLES = 64
FLOPS_PER_TRIANGLE = 40


def _k1(ctx):
    from harness.trace import kernel_id

    hits = [(s, c) for name, (s, c) in ctx.kernels.items()
            if kernel_id(name) in KERNELS]
    return sum(s for s, _ in hits), sum(c for _, c in hits)


def prepare(ctx):
    """Count the units with the counting variant on the first traced
    call's seed, while the program is loaded."""
    if not _k1(ctx)[1]:
        return
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import config

    config.fused_count_units = True
    try:
        ctx.call(ctx.calls[0][0])
    finally:
        config.fused_count_units = False
    ctx.k1_units = int(simulations._STREAM_DIAG[0])
    spec = next(v for v in ctx.substrate._accel_cache.values()
                if hasattr(v, "table"))
    ctx.k1_table_bytes = spec.table.numel() * spec.table.element_size()
    ctx.k1_J = spec.resort_every


def read(ctx):
    seconds, launches = _k1(ctx)
    if not launches or not getattr(ctx, "k1_units", 0):
        return None
    calls = len(ctx.calls)
    epochs = launches / calls
    J, n = ctx.k1_J, ctx.n_walkers
    per_spin = 4 * (6 + 3 * J) + 16 + 16 * J + 1
    n_bytes = epochs * (ctx.k1_table_bytes + n * per_spin)
    flops = ctx.k1_units * UNIT_TRIANGLES * FLOPS_PER_TRIANGLE
    least, _ = roofline.least_seconds(n_bytes, flops, "float32")
    return roofline.share(least, seconds / calls)
