"""B6 and B6-bwd: Mamba-2's SSD scan (one B/C group), forward and backward.

Operations of the chunked algorithm, per sequence of ``nc`` chunks of
``Q`` steps, H heads of P channels and state N, 2 FLOPs a multiply-add:
``C B^T`` over the causal pairs of a chunk (N each), the weighted sum of
x over them (H P each), the state each chunk leaves (Q H P N) and the
output read from the state entering it (Q H P N), and the pass over the
chunks (H P N a chunk).  The backward is twice the forward's products (each
product has two gradients).  Bytes: forward x, dt, a, B, C -> y, the last
state; backward x, dt, a, B, C, dy -> dx, ddt, da, dB, dC."""
from __future__ import annotations

from typing import Any, Mapping, Tuple

from counts.work import itemsize, rows

KERNELS = {
    "ssd_scan": ("ssd_chunk_state_f32_kernel", "ssd_chunk_state_kernel",
                 "ssd_state_pass_kernel", "ssd_chunk_scan_f32_kernel",
                 "ssd_chunk_scan_kernel"),
    "ssd_scan_bwd": ("ssd_bwd_rows_f32_kernel", "ssd_bwd_cols_f32_kernel",
                     "ssd_bwd_rows_tc_kernel", "ssd_bwd_cols_tc_kernel",
                     "ssd_bwd_state_pass_kernel", "ssd_bwd_reduce_kernel"),
}


def forward_flops(s: int, h: int, p: int, n: int, q: int) -> float:
    nc = -(-s // q)
    tri = q * (q + 1)            # 2 x the causal pairs of a chunk
    return float(nc * (tri * n + tri * h * p + 4 * q * h * p * n)
                 + 2 * nc * h * p * n)


def forward(b: int, s: int, h: int, p: int, n: int, q: int,
            item: int) -> Tuple[float, float]:
    nbytes = item * b * s * (2 * h * p + 2 * n) + 4 * b * (s * h + h * p * n)
    return b * forward_flops(s, h, p, n, q), float(nbytes + 4 * h)


def backward(b: int, s: int, h: int, p: int, n: int, q: int,
             item: int) -> Tuple[float, float]:
    nbytes = item * b * s * (3 * h * p + 4 * n) + 4 * b * s * 2 * h
    return 2 * b * forward_flops(s, h, p, n, q), float(nbytes + 8 * h)


def round_work(family: str, cfg: Mapping[str, Any],
               traffic: Mapping[str, Any]):
    if cfg["kind"] not in ("ssm", "hybrid"):
        return None
    d_in = cfg["ssm_expand"] * cfg["d_model"]
    h = d_in // cfg["ssm_head_dim"]
    fn = forward if family == "ssd_scan" else backward
    f, nb = fn(rows(traffic), traffic["seq_len"], h, cfg["ssm_head_dim"],
               cfg["ssm_state_dim"], cfg["ssm_chunk_size"], itemsize(cfg))
    return f * cfg["num_layers"], nb * cfg["num_layers"]
