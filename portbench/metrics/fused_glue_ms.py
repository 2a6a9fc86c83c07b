"""Device milliseconds per call of the fused window's work other than K1
and K7: the epoch sort, the gathers and scatters, the phase product and
the signal's reduction."""

K1 = ("fused_epoch_kernel",)
K7 = ("directions_kernel",)


def read(ctx):
    from harness.trace import kernel_id

    k1 = [s for name, (s, _) in ctx.kernels.items() if kernel_id(name) in K1]
    if not k1:
        return None
    rest = sum(s for name, (s, _) in ctx.kernels.items()
               if kernel_id(name) not in K1 + K7)
    return rest * 1e3 / len(ctx.calls)
