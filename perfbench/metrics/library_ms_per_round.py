"""library_ms_per_round (LM model): device time a round in kernels that are
not the program's own (cuBLAS products, PyTorch's elementwise operations
and reductions), summed over the traced window's kernels."""
from fedbench.trace import family_of

UNIT = "ms"


def read(ctx):
    if ctx.trace is None or ctx.rounds == 0 or not ctx.trace.ops:
        return None
    t = sum(b - a for name, a, b in ctx.trace.kernels()
            if family_of(name, ctx.families) is None)
    return 1e3 * t / ctx.rounds
