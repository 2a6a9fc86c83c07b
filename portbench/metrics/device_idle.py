"""Share of the traced window (%) in which no operation ran on the device:
1 - busy / wall, busy being the sum of the device events' own times."""


def read(ctx):
    if not ctx.window_s > 0 or not ctx.busy_s > 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
