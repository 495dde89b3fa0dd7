"""peak_mem_gib (device): ``torch.cuda.max_memory_allocated()`` over the
window, the peak statistics reset at its start."""
UNIT = "GiB"


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2 ** 30
