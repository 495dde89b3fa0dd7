"""device_idle_pct (device): the share of the traced window in which no
operation runs on the device: 1 minus the union of the device's intervals
over the window's wall time."""
UNIT = "%"


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
