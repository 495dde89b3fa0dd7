"""B2, B3 and B4: the federated operations over the ``(K, D)`` slab of the
round's messages (K clients, D parameters, fp32).

B2 (the Eq. (2) weighted sum): reads the slab, writes one row; K D
multiply-adds.  B4 (top-k with error feedback): reads the slab and the
clients' error rows, writes the sent slab and the new error rows; its
work is comparisons (0 FLOPs).  B3 (dp noise and secure masks) is not in
a round of these cells' traffic."""
from __future__ import annotations

from typing import Any, Mapping

from counts.work import clients, param_count

KERNELS = {
    "fed_weighted_sum": ("weighted_sum_kernel",),
    "fed_topk_ef": ("key_pass_kernel", "low_pass_kernel",
                    "write_pass_kernel"),
    "fed_dp_secure": ("dp_secure_kernel",),
}


def weighted_sum(k: int, d: int):
    return 2.0 * k * d, 4.0 * (k * d + d + k)


def topk_ef(k: int, d: int):
    return 0.0, 16.0 * k * d


def round_work(family: str, cfg: Mapping[str, Any],
               traffic: Mapping[str, Any]):
    k, d = clients(traffic), param_count(cfg)
    if family == "fed_weighted_sum":
        return weighted_sum(k, d)
    if family == "fed_topk_ef" and traffic.get("topk_frac"):
        return topk_ef(k, d)
    return None
