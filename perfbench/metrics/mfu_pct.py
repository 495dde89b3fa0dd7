"""mfu_pct (whole step): the traced window's model FLOPs over the window's
time and the card's peak for the configuration's dtype (TF32's 494.7
TFLOP/s for fp32 work, bf16's 989.4 TFLOP/s for bf16).  Model FLOPs are
the forward and backward products of the rows trained
(``counts/model_flops.py``); recomputation and padded rows are not
counted."""
from counts.model_flops import train_flops
from counts.peaks import matmul_peak

UNIT = "%"


def read(ctx):
    if ctx.trace is None or ctx.rounds == 0:
        return None
    flops, _ = train_flops(ctx.cfg, ctx.rows_per_round,
                           ctx.traffic["seq_len"])
    return 100.0 * flops * ctx.rounds / (ctx.trace.window_s
                                         * matmul_peak(ctx.cfg["dtype"]))
