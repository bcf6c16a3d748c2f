"""device_idle.agg: the share (%) of the traced window in which no
operation ran on the device (union of the trace's device intervals)."""


def read(ctx):
    if ctx.trace is None or ctx.window.seconds <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window.seconds)
