"""port_calls_per_round (kernels): calls into the program's kernels a round,
the sum of the kernel modules' call counters over the traced window."""
UNIT = "count"


def read(ctx):
    if ctx.rounds == 0 or ctx.trace is None:
        return None
    return sum(ctx.calls.values()) / ctx.rounds
