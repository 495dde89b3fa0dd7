"""B1: the fused ProdLDA decoder loss.  No round of an LM cell runs it;
its kernel is named so that its time counts as the port's."""
from __future__ import annotations

KERNELS = {"topic_decoder": ("decoder_kernel",)}


def round_work(family, cfg, traffic):
    return None
