"""Device events (kernels, copies, sets) per traced call."""


def read(ctx):
    if not ctx.events:
        return None
    return ctx.events / len(ctx.calls)
