"""port_kernel_roofline_pct (kernels): the sum of the bounds of the work of
the program's own kernels in the traced window over the sum of their
device time.  A family's bound is max(operations / peak, bytes / HBM
bandwidth) of the work one round gives it (``counts/<family>.py``), times
the rounds, for each family whose call counter moved; the time is every
traced launch of a kernel that ``counts/`` names."""
from counts.peaks import bound_s
from fedbench.trace import family_of

UNIT = "%"


def read(ctx):
    if ctx.trace is None or ctx.rounds == 0:
        return None
    time_s = 0.0
    for name, a, b in ctx.trace.kernels():
        if family_of(name, ctx.families) is not None:
            time_s += b - a
    bound = 0.0
    for family, spec in ctx.families.items():
        work = spec["round_work"](family, ctx.cfg, ctx.traffic)
        if work is not None and ctx.calls.get(family, 0) > 0:
            bound += ctx.rounds * bound_s(work[0], work[1], ctx.cfg["dtype"])
    if time_s <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / time_s
