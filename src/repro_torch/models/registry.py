"""Model registry: one (init, loss, forward, prefill, decode) bundle per
arch.

The port of the reference's ``models/registry.py`` for the LM kinds the
port has (``dense``, ``ssm``, ``hybrid``, ``vlm``, ``audio``; an
encoder-only config's ``prefill``, ``decode_step`` and ``init_cache``
raise, as it has no decode path); the NTM runs through
``repro_torch.api``.  ``loss`` is the mean token loss and ``loss_sum``
its mask-aware ``(sum, count)`` form, which the federated stacked path
weights by (Eq. (2) sample counts).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as t


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]            # (threefry key) -> params
    loss: Callable[..., Any]            # (params, batch) -> scalar loss
    # (params, batch) -> (sum_loss, count), padded rows masked out
    loss_sum: Callable[..., Any]
    forward: Callable[..., Any]         # (params, batch) -> (logits, aux)
    prefill: Callable[..., Any]         # (params, batch) -> (logits, cache)
    decode_step: Callable[..., Any]     # (params, cache, tokens) -> same
    init_cache: Callable[..., Any]      # (batch, seq, device=) -> cache


def build_model(cfg: ModelConfig, *, dtype=None) -> ModelBundle:
    t.check_supported(cfg)

    def init(key):
        return t.init_params(key, cfg)

    def loss(params, batch, **kw):
        return t.train_loss(params, cfg, batch, dtype=dtype, **kw)

    def loss_sum(params, batch, **kw):
        return t.train_loss_sum(params, cfg, batch, dtype=dtype, **kw)

    def forward(params, batch, **kw):
        return t.forward_train(params, cfg, batch, dtype=dtype, **kw)

    def prefill(params, batch, **kw):
        return t.prefill(params, cfg, batch, dtype=dtype, **kw)

    def decode(params, cache, tokens, **kw):
        return t.decode_step(params, cfg, cache, tokens, dtype=dtype, **kw)

    def init_cache(batch_size, seq_len, **kw):
        return t.init_cache(cfg, batch_size, seq_len, dtype=dtype, **kw)

    return ModelBundle(cfg=cfg, init=init, loss=loss, loss_sum=loss_sum,
                       forward=forward, prefill=prefill, decode_step=decode,
                       init_cache=init_cache)
