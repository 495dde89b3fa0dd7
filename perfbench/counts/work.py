"""Sizes of one federated round that the kernel families' counts share:
rows trained, parameters in a message, bytes of an element."""
from __future__ import annotations

from typing import Any, Mapping


def itemsize(cfg: Mapping[str, Any]) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[cfg["dtype"]]


def rows(traffic: Mapping[str, Any]) -> int:
    """Documents trained a round, over all clients and local epochs;
    padded rows are no work."""
    return sum(min(traffic["batch_size"], n)
               for n in traffic["docs_per_client"]) * traffic["local_epochs"]


def clients(traffic: Mapping[str, Any]) -> int:
    return len(traffic["docs_per_client"])


def _ssm_layer(cfg, d):
    n, p = cfg["ssm_state_dim"], cfg["ssm_head_dim"]
    d_in = cfg["ssm_expand"] * d
    nh = d_in // p
    conv = d_in + 2 * n
    return d * (2 * d_in + 2 * n + nh) + cfg["ssm_conv_width"] * conv \
        + conv + 3 * nh + d_in + d_in * d


def param_count(cfg: Mapping[str, Any]) -> int:
    """Entries of the weights: the width of one federated message."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    if cfg["kind"] == "ssm":
        layer = d + _ssm_layer(cfg, d)
    elif cfg["kind"] == "hybrid":
        hq, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        attn = d * (hq + 2 * hkv) * hd + hq * hd * d
        layer = 2 * d + attn + _ssm_layer(cfg, d) + 4 * d \
            + 3 * d * cfg["d_ff"]
    else:
        raise ValueError(f"kind {cfg['kind']!r} has no count here")
    head = 0 if cfg["tie_embeddings"] else d * v
    return cfg["num_layers"] * layer + v * d + head + d
