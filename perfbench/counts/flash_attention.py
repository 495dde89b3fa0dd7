"""B5 and B5-bwd: causal (sliding-window) grouped-query attention over the
folded batch, forward and backward.

Operations: 2 FLOPs a multiply-add over the (query, key) pairs the mask
lets through: forward ``Q K^T`` and ``P V``, backward ``dV = P^T dO``,
``dP = dO V^T``, ``dQ = dS K`` and ``dK = dS^T Q`` (the scores that a
fused backward recomputes are not counted).  Bytes: each input read once
and each output written once: forward q, k, v -> o, lse; backward q, k,
v, o, dO, lse -> dq, dk, dv."""
from __future__ import annotations

from typing import Any, Mapping, Tuple

from counts.work import itemsize, rows

KERNELS = {
    "flash_attention": ("flash_fwd_f32_kernel", "flash_fwd_tc_kernel"),
    "flash_attention_bwd": ("flash_bwd_dq_f32_kernel",
                            "flash_bwd_dkdv_f32_kernel",
                            "flash_bwd_dq_tc_kernel",
                            "flash_bwd_dkdv_tc_kernel",
                            "flash_bwd_group_sum_kernel"),
}


def pairs(seq: int, window: int = 0) -> int:
    """(query, key) pairs of a causal mask, within ``window`` if set."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def forward(b: int, s: int, hq: int, hkv: int, d: int, window: int,
            item: int) -> Tuple[float, float]:
    flops = 4.0 * b * pairs(s, window) * hq * d
    nbytes = item * b * s * d * (2 * hq + 2 * hkv) + 4 * b * hq * s
    return flops, float(nbytes)


def backward(b: int, s: int, hq: int, hkv: int, d: int, window: int,
             item: int) -> Tuple[float, float]:
    flops = 8.0 * b * pairs(s, window) * hq * d
    nbytes = item * b * s * d * (4 * hq + 4 * hkv) + 4 * b * hq * s
    return flops, float(nbytes)


def round_work(family: str, cfg: Mapping[str, Any],
               traffic: Mapping[str, Any]):
    """(FLOPs, bytes) of the family over one round, or None where the
    round runs none of it."""
    if cfg["kind"] not in ("hybrid", "dense") or not cfg["num_heads"]:
        return None
    fn = forward if family == "flash_attention" else backward
    f, n = fn(rows(traffic), traffic["seq_len"], cfg["num_heads"],
              cfg["num_kv_heads"], cfg["head_dim"],
              cfg.get("sliding_window", 0), itemsize(cfg))
    return f * cfg["num_layers"], n * cfg["num_layers"]
