"""Model FLOPs of a training step: a frozen copy of the closed form of
``repro_torch.launch.analytic`` (its per-layer forward FLOPs, 1
multiply-add = 2 FLOPs, attention as full windowed score work), kept here
so that the yardstick does not move when the program's copy does.
Training counts the forward and a backward of twice its work; the
attention core that a fused backward recomputes is returned apart and is
not model work.  ``cfg`` is a configuration file's dict."""
from __future__ import annotations

from typing import Any, Mapping, Tuple


def _attn_flops(cfg, t, s_kv):
    d, hd = cfg["d_model"], cfg["head_dim"]
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    if cfg.get("sliding_window"):
        s_kv = min(s_kv, cfg["sliding_window"])
    proj = 2 * t * d * (hq * hd + 2 * hkv * hd) + 2 * t * hq * hd * d
    core = 2 * t * s_kv * hq * hd * 2        # scores + p@v
    return proj + core


def _ffn_flops(cfg, t):
    mult = 6 if cfg.get("activation", "swiglu") == "swiglu" else 4
    return mult * t * cfg["d_model"] * cfg["d_ff"]


def _ssd_flops(cfg, t):
    d = cfg["d_model"]
    d_in = cfg["ssm_expand"] * d
    nh = d_in // cfg["ssm_head_dim"]
    n, p, q = cfg["ssm_state_dim"], cfg["ssm_head_dim"], cfg["ssm_chunk_size"]
    proj = 2 * t * d * (2 * d_in + 2 * n + nh) + 2 * t * d_in * d
    conv = 2 * t * (d_in + 2 * n) * cfg["ssm_conv_width"]
    core = 2 * t * q * n + 2 * t * q * nh * p + 4 * t * n * nh * p
    return proj + conv + core


def _layer_flops(cfg, t, s_kv):
    if cfg["kind"] == "ssm":
        return _ssd_flops(cfg, t)
    fl = _attn_flops(cfg, t, s_kv)
    if cfg["kind"] == "hybrid":
        fl += _ssd_flops(cfg, t)
    if cfg["kind"] not in ("hybrid", "dense"):
        raise ValueError(f"kind {cfg['kind']!r} has no frozen count here")
    return fl + _ffn_flops(cfg, t)


def train_flops(cfg: Mapping[str, Any], rows: int, seq: int
                ) -> Tuple[float, float]:
    """(model FLOPs, recomputed attention FLOPs) of one step over ``rows``
    sequences of ``seq`` tokens."""
    t = rows * seq
    fwd = cfg["num_layers"] * _layer_flops(cfg, t, seq) \
        + 2 * t * cfg["d_model"] * cfg["vocab_size"]
    recompute = 0.0
    if cfg["kind"] != "ssm":
        skv = min(seq, cfg["sliding_window"]) if cfg.get("sliding_window") \
            else seq
        recompute = cfg["num_layers"] * 2 * t * skv * cfg["num_heads"] \
            * cfg["head_dim"] * 2
    return float(3 * fwd), float(recompute)
