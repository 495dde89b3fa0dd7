"""Contextualized Topic Models: CombinedTM and ZeroShotTM.

[Bianchi et al. 2021 x2]  Port of ``repro/core/ntm/ctm.py``.  Both reuse
the ProdLDA variational graph (``prodlda.py``) with another input:

* CombinedTM — ``concat(BoW, contextual embedding)`` (the paper's
  gFedNTM-CTM);
* ZeroShotTM — the contextual embedding alone.

The embedding is SBERT in the paper; the synthetic runs use the fixed
random projection of ``data.synthetic_lda.fake_contextual_embeddings``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ntm import prodlda


def _need_contextual(cfg: ModelConfig, what: str) -> None:
    if cfg.contextual_dim <= 0:
        raise ValueError(f"{what} needs contextual_dim > 0")


def init_combined(key: torch.Tensor, cfg: ModelConfig):
    _need_contextual(cfg, "CombinedTM")
    return prodlda.init_params(key, cfg, input_mode="combined")


def init_zeroshot(key: torch.Tensor, cfg: ModelConfig):
    _need_contextual(cfg, "ZeroShotTM")
    return prodlda.init_params(key, cfg, input_mode="zeroshot")


def loss_combined(params, cfg, batch, **kw):
    return prodlda.elbo_loss(params, cfg, batch, input_mode="combined", **kw)


def loss_zeroshot(params, cfg, batch, **kw):
    return prodlda.elbo_loss(params, cfg, batch, input_mode="zeroshot", **kw)


def get_topics(params):
    return prodlda.get_topics(params)


def infer_theta(params, cfg, bow, contextual, *, zeroshot=False):
    mode = "zeroshot" if zeroshot else "combined"
    return prodlda.infer_theta(params, cfg, bow, contextual, input_mode=mode)
