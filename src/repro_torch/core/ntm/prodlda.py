"""ProdLDA (AVITM) in PyTorch — the NTM the paper federates.

[Srivastava & Sutton 2017, arXiv:1703.01488]  An encoder MLP maps the
bag-of-words document to the mean/log-variance of a logistic-normal
posterior; the Dirichlet prior is its Laplace approximation in softmax
basis; the decoder is a product of experts ``p(w|theta) =
softmax(theta @ beta)`` with unnormalized topic-word weights beta.

The port of ``repro/core/ntm/prodlda.py`` for the ``bow`` input, without
batch norm and in evaluation mode (``train=False``: no dropout, the
posterior mean instead of a reparametrized sample) — the setting the
federation service and its parity tests run in.  The parameters live in
an ordered ``dict[str, Tensor]`` whose names are the reference tree's
paths (``encoder.0.w``, ``mu_head.b``, ``beta``, ``dec_scale``,
``prior_logvar`` ...), the names :class:`ProdLDA` registers its
parameters under; :func:`params_from_reference` /
:func:`params_to_reference` carry weights between the two layouts.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.init import dense_init

Params = Dict[str, torch.Tensor]

_HEADS = ("mu_head", "lv_head")
_VECTORS = ("beta", "mu_scale", "lv_scale", "dec_scale", "prior_mu",
            "prior_logvar")


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Parameter names and shapes, in the reference tree's order."""
    k, v = cfg.num_topics, cfg.vocab_size
    dims = [v] + list(cfg.ntm_hidden)
    shapes: Dict[str, Tuple[int, ...]] = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"encoder.{i}.w"] = (a, b)
        shapes[f"encoder.{i}.b"] = (b,)
    for head in _HEADS:
        shapes[f"{head}.w"] = (dims[-1], k)
        shapes[f"{head}.b"] = (k,)
    shapes.update(beta=(k, v), mu_scale=(k,), lv_scale=(k,),
                  dec_scale=(v,))
    if cfg.learn_priors:
        shapes.update(prior_mu=(k,), prior_logvar=(k,))
    return shapes


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device) -> Params:
    """Fresh ProdLDA weights (truncated-normal fan-in init, unit scales,
    the AVITM Dirichlet(1/K) Laplace prior when priors are learned)."""
    k = cfg.num_topics
    out: Params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(".w") or name == "beta":
            out[name] = dense_init(shape, generator=generator, device=device)
        elif name.endswith("_scale"):
            out[name] = torch.ones(shape, device=device)
        elif name == "prior_logvar":
            a = 1.0 / max(k, 1)
            var0 = (1.0 / a) * (1.0 - 2.0 / k) + 1.0 / (a * k)
            out[name] = torch.full(shape, math.log(var0), device=device)
        else:                                   # biases, prior_mu
            out[name] = torch.zeros(shape, device=device)
    return out


def dirichlet_prior(k: int, alpha: float):
    """Laplace approximation of Dirichlet(alpha) in softmax basis."""
    var = (1.0 / alpha) * (1.0 - 2.0 / k) + 1.0 / (k * alpha)
    return torch.zeros(k), torch.full((k,), math.log(var))


def encode(params: Mapping[str, torch.Tensor], cfg: ModelConfig, x):
    """x (B, V) -> (mu, logvar) of the logistic-normal posterior."""
    h = x
    for i in range(len(cfg.ntm_hidden)):
        h = F.softplus(h @ params[f"encoder.{i}.w"]
                       + params[f"encoder.{i}.b"])
    mu = h @ params["mu_head.w"] + params["mu_head.b"]
    lv = h @ params["lv_head.w"] + params["lv_head.b"]
    return mu * params["mu_scale"], lv * params["lv_scale"]


def decode(params: Mapping[str, torch.Tensor], theta):
    """theta (B, K) -> log word distribution (B, V): product of experts."""
    logits = (theta @ params["beta"]) * params["dec_scale"]
    return torch.log_softmax(logits, dim=-1)


def forward(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """dict(theta, mu, logvar, log_recon) for ``batch["bow"]`` (B, V)."""
    mu, lv = encode(params, cfg, batch["bow"])
    theta = torch.softmax(mu, dim=-1)
    return {"theta": theta, "mu": mu, "logvar": lv,
            "log_recon": decode(params, theta)}


def kl_to_prior(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                mu, lv):
    """KL(q(z|x) || p(z)) vs the (learned or fixed) Laplace-approx prior."""
    if cfg.learn_priors and "prior_mu" in params:
        pm, plv = params["prior_mu"], params["prior_logvar"]
    else:
        pm, plv = (t.to(mu.device) for t in
                   dirichlet_prior(cfg.num_topics, 1.0 / cfg.num_topics))
    diff = mu - pm
    return 0.5 * torch.sum(torch.exp(lv - plv) + diff * diff / torch.exp(plv)
                           - 1.0 + (plv - lv), dim=-1)


def elbo_parts(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
               batch: Mapping[str, torch.Tensor]):
    """Per-document (reconstruction, KL) terms, both (B,)."""
    out = forward(params, cfg, batch)
    recon = -torch.sum(batch["bow"] * out["log_recon"], dim=-1)
    return recon, kl_to_prior(params, cfg, out["mu"], out["logvar"])


class ProdLDA(nn.Module):
    """ProdLDA as a module: parameters registered under the reference
    tree's paths; ``forward(bow)`` is the per-document negative ELBO.

    The losses below evaluate it through ``torch.func.functional_call``
    on a weightless (``meta``) instance, with the federation's parameter
    dict swapped in — so a message, a server state and a model are all
    the same ``dict[str, Tensor]``.
    """

    def __init__(self, cfg: ModelConfig,
                 params: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__()
        self.cfg = cfg
        shapes = param_shapes(cfg)
        if params is None:
            params = {n: torch.empty(s, device="meta")
                      for n, s in shapes.items()}

        def dense(prefix):
            m = nn.Module()
            m.w = nn.Parameter(params[f"{prefix}.w"])
            m.b = nn.Parameter(params[f"{prefix}.b"])
            return m

        self.encoder = nn.ModuleList(
            dense(f"encoder.{i}") for i in range(len(cfg.ntm_hidden)))
        for head in _HEADS:
            setattr(self, head, dense(head))
        for name in _VECTORS:
            if name in shapes:
                setattr(self, name, nn.Parameter(params[name]))

    def forward(self, bow):
        recon, kl = elbo_parts(dict(self.named_parameters()), self.cfg,
                               {"bow": bow})
        return recon + kl


@functools.lru_cache(maxsize=None)
def _template(cfg: ModelConfig) -> ProdLDA:
    return ProdLDA(cfg)


def per_doc_loss(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                 bow) -> torch.Tensor:
    """Negative ELBO per document (B,), via ``functional_call``."""
    return torch.func.functional_call(_template(cfg), dict(params), (bow,))


def elbo_loss(params, cfg: ModelConfig, batch):
    """Per-document mean negative ELBO (the training loss)."""
    return per_doc_loss(params, cfg, batch["bow"]).mean()


def elbo_loss_sum(params, cfg: ModelConfig, batch):
    """(sum, count) form used by the exact Eq. (2) federated weighting."""
    per_doc = per_doc_loss(params, cfg, batch["bow"])
    mask = batch.get("doc_mask")
    if mask is not None:
        return torch.sum(per_doc * mask), torch.sum(mask)
    return torch.sum(per_doc), torch.tensor(float(per_doc.shape[0]))


def get_topics(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Normalized topic-word distributions beta (K, V) for evaluation."""
    return torch.softmax(params["beta"], dim=-1)


def infer_theta(params: Mapping[str, torch.Tensor], cfg: ModelConfig, bow):
    """Posterior-mean document-topic mixtures (no sampling)."""
    return forward(params, cfg, {"bow": bow})["theta"]


# ---------------------------------------------------------------------------
# the weight carrier: reference tree <-> port dict
# ---------------------------------------------------------------------------
def params_from_reference(tree: Mapping[str, Any], *,
                          device="cpu") -> Params:
    """The reference's nested dict/list tree (``prodlda.init_params``
    layout, numpy leaves) -> the port's ordered parameter dict.  Bitwise:
    every leaf is copied as float32 without arithmetic."""
    flat: Dict[str, Any] = {}
    for i, layer in enumerate(tree["encoder"]):
        flat[f"encoder.{i}.w"] = layer["w"]
        flat[f"encoder.{i}.b"] = layer["b"]
    for head in _HEADS:
        flat[f"{head}.w"] = tree[head]["w"]
        flat[f"{head}.b"] = tree[head]["b"]
    for name in _VECTORS:
        if name in tree:
            flat[name] = tree[name]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in flat.items()}


def params_to_reference(params: Mapping[str, torch.Tensor]
                        ) -> Dict[str, Any]:
    """Inverse of :func:`params_from_reference` (numpy leaves)."""
    host = {k: v.detach().cpu().numpy() for k, v in params.items()}
    n_enc = sum(1 for k in host if k.startswith("encoder.") and
                k.endswith(".w"))
    tree: Dict[str, Any] = {
        "encoder": [{"w": host[f"encoder.{i}.w"], "b": host[f"encoder.{i}.b"]}
                    for i in range(n_enc)]}
    for head in _HEADS:
        tree[head] = {"w": host[f"{head}.w"], "b": host[f"{head}.b"]}
    for name in _VECTORS:
        if name in host:
            tree[name] = host[name]
    return tree
