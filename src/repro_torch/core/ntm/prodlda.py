"""ProdLDA (AVITM) in PyTorch — the NTM the paper federates.

[Srivastava & Sutton 2017, arXiv:1703.01488]  An encoder MLP maps the
document to the mean/log-variance of a logistic-normal posterior; the
Dirichlet prior is its Laplace approximation in softmax basis; the
decoder is a product of experts ``p(w|theta) = softmax(theta @ beta)``
with unnormalized topic-word weights beta.

The port of ``repro/core/ntm/prodlda.py``, its whole forward:

* ``input_mode`` — ``bow`` (ProdLDA), ``combined`` (``concat(BoW,
  contextual)``, CombinedTM) or ``zeroshot`` (the contextual embedding
  alone, ZeroShotTM); the first encoder layer is ``V``, ``V + C`` or
  ``C`` wide (:func:`infer_input_mode` picks ``combined`` when
  ``cfg.contextual_dim`` is set);
* ``use_batchnorm`` — batch norm (population variance, eps 1e-5) on mu,
  logvar and the decoder logits;
* ``train`` (default True, as in the reference) with a threefry key in
  ``batch["rng"]`` — ``split`` into a dropout key (a Bernoulli(1 - p)
  mask on the last hidden layer, rescaled) and a noise key (the
  reparametrized sample ``mu + exp(lv/2) * eps``).  Without a key, or
  with ``train=False``, nothing is drawn: no dropout, the posterior
  mean.  The draws are the reference's own (``core/prng.py``), so the
  train-mode loss matches it value for value.

The parameters live in an ordered ``dict[str, Tensor]`` whose names are
the reference tree's paths (``encoder.0.w``, ``mu_head.b``, ``beta``,
``dec_scale``, ``prior_logvar`` ...), the names :class:`ProdLDA`
registers its parameters under; :func:`params_from_reference` /
:func:`params_to_reference` carry weights between the two layouts, for
every input mode.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.checkpoint.checkpoint import host, to_tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models.layers.init import dense_init

Params = Dict[str, torch.Tensor]

_HEADS = ("mu_head", "lv_head")
_VECTORS = ("beta", "mu_scale", "lv_scale", "dec_scale", "prior_mu",
            "prior_logvar")


def _input_dim(cfg: ModelConfig, input_mode: str) -> int:
    if input_mode == "bow":
        return cfg.vocab_size
    if input_mode == "combined":
        return cfg.vocab_size + cfg.contextual_dim
    if input_mode == "zeroshot":
        return cfg.contextual_dim
    raise ValueError(input_mode)


def infer_input_mode(cfg: ModelConfig) -> str:
    return "combined" if cfg.contextual_dim else "bow"


def param_shapes(cfg: ModelConfig, input_mode: Optional[str] = None
                 ) -> Dict[str, Tuple[int, ...]]:
    """Parameter names and shapes, in the reference tree's order."""
    k, v = cfg.num_topics, cfg.vocab_size
    dims = [_input_dim(cfg, input_mode or infer_input_mode(cfg))] \
        + list(cfg.ntm_hidden)
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


def init_params(key: torch.Tensor, cfg: ModelConfig,
                input_mode: Optional[str] = None) -> Params:
    """Fresh ProdLDA weights (truncated-normal fan-in init, unit scales,
    the AVITM Dirichlet(1/K) Laplace prior when priors are learned) on
    the threefry ``key``'s device, on the reference's key schedule
    (``split(key, len(dims) + 3)``: encoder layer i from ``keys[i]``, the
    two heads and ``beta`` from the last three), so the weights are the
    reference's."""
    k = cfg.num_topics
    device = key.device
    keys = prng.split(key, len(cfg.ntm_hidden) + 4)
    key_of = {"mu_head.w": keys[-3], "lv_head.w": keys[-2],
              "beta": keys[-1]}
    out: Params = {}
    for name, shape in param_shapes(cfg, input_mode).items():
        if name.endswith(".w") or name == "beta":
            w_key = key_of.get(name)
            if w_key is None:                   # encoder.{i}.w
                w_key = keys[int(name.split(".")[1])]
            out[name] = dense_init(w_key, shape)
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


def _batchnorm(x, eps=1e-5):
    """Batch statistics over the documents, population variance."""
    mu = torch.mean(x, dim=0, keepdim=True)
    var = torch.var(x, dim=0, unbiased=False, keepdim=True)
    return (x - mu) * (var + eps) ** -0.5


def encode(params: Mapping[str, torch.Tensor], cfg: ModelConfig, x, *,
           dropout_rng=None, use_batchnorm=False, train=True):
    """x (B, input_dim) -> (mu, logvar) of the logistic-normal posterior;
    in train mode with a ``dropout_rng`` the last hidden layer is
    dropped out."""
    h = x
    for i in range(len(cfg.ntm_hidden)):
        h = F.softplus(h @ params[f"encoder.{i}.w"]
                       + params[f"encoder.{i}.b"])
    if train and dropout_rng is not None and cfg.ntm_dropout > 0:
        keep = prng.bernoulli(dropout_rng, 1 - cfg.ntm_dropout, h.shape)
        h = h * keep / (1 - cfg.ntm_dropout)
    mu = h @ params["mu_head.w"] + params["mu_head.b"]
    lv = h @ params["lv_head.w"] + params["lv_head.b"]
    if use_batchnorm:
        mu = _batchnorm(mu)
        lv = _batchnorm(lv)
    return mu * params["mu_scale"], lv * params["lv_scale"]


def decode(params: Mapping[str, torch.Tensor], theta, *,
           use_batchnorm=False):
    """theta (B, K) -> log word distribution (B, V): product of experts."""
    logits = theta @ params["beta"]
    if use_batchnorm:
        logits = _batchnorm(logits)
    return torch.log_softmax(logits * params["dec_scale"], dim=-1)


def forward(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor], *, use_batchnorm=False,
            train=True, input_mode: Optional[str] = None
            ) -> Dict[str, torch.Tensor]:
    """dict(theta, mu, logvar, log_recon) for a batch: ``bow`` (B, V),
    ``contextual`` (B, C) for the combined and zeroshot modes, and an
    optional ``rng`` key for the train-mode draws."""
    input_mode = input_mode or infer_input_mode(cfg)
    bow = batch["bow"]
    if input_mode == "bow":
        x = bow
    elif input_mode == "combined":
        x = torch.cat([bow, batch["contextual"]], dim=-1)
    else:
        x = batch["contextual"]
    rng = batch.get("rng")
    d_rng = s_rng = None
    if rng is not None:
        keys = prng.split(rng)
        d_rng, s_rng = keys[0], keys[1]
    mu, lv = encode(params, cfg, x, dropout_rng=d_rng,
                    use_batchnorm=use_batchnorm, train=train)
    if train and s_rng is not None:
        z = mu + torch.exp(0.5 * lv) * prng.normal(s_rng, mu.shape)
    else:
        z = mu
    theta = torch.softmax(z, dim=-1)
    return {"theta": theta, "mu": mu, "logvar": lv,
            "log_recon": decode(params, theta, use_batchnorm=use_batchnorm)}


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
               batch: Mapping[str, torch.Tensor], **kw):
    """Per-document (reconstruction, KL) terms, both (B,); ``kw`` are
    :func:`forward`'s."""
    out = forward(params, cfg, batch, **kw)
    recon = -torch.sum(batch["bow"] * out["log_recon"], dim=-1)
    return recon, kl_to_prior(params, cfg, out["mu"], out["logvar"])


class ProdLDA(nn.Module):
    """ProdLDA as a module: parameters registered under the reference
    tree's paths; ``forward(bow, contextual=None, rng=None, **kw)`` is
    the per-document negative ELBO (``kw``: :func:`forward`'s).

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

    def forward(self, bow, contextual=None, rng=None, **kw):
        batch = {"bow": bow}
        if contextual is not None:
            batch["contextual"] = contextual
        if rng is not None:
            batch["rng"] = rng
        recon, kl = elbo_parts(dict(self.named_parameters()), self.cfg,
                               batch, **kw)
        return recon + kl


@functools.lru_cache(maxsize=None)
def _template(cfg: ModelConfig) -> ProdLDA:
    return ProdLDA(cfg)


def per_doc_loss(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                 batch: Mapping[str, torch.Tensor], **kw) -> torch.Tensor:
    """Negative ELBO per document (B,), via ``functional_call``."""
    return torch.func.functional_call(
        _template(cfg), dict(params),
        (batch["bow"], batch.get("contextual"), batch.get("rng")), kw)


def elbo_loss(params, cfg: ModelConfig, batch, **kw):
    """Per-document mean negative ELBO (the training loss); ``kw`` are
    :func:`forward`'s (``train`` defaults to True)."""
    return per_doc_loss(params, cfg, batch, **kw).mean()


def elbo_loss_sum(params, cfg: ModelConfig, batch, **kw):
    """(sum, count) form used by the exact Eq. (2) federated weighting."""
    per_doc = per_doc_loss(params, cfg, batch, **kw)
    mask = batch.get("doc_mask")
    if mask is not None:
        return torch.sum(per_doc * mask), torch.sum(mask)
    return torch.sum(per_doc), torch.tensor(float(per_doc.shape[0]))


def get_topics(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Normalized topic-word distributions beta (K, V) for evaluation."""
    return torch.softmax(params["beta"], dim=-1)


def infer_theta(params: Mapping[str, torch.Tensor], cfg: ModelConfig, bow,
                contextual=None, input_mode: Optional[str] = None):
    """Posterior-mean document-topic mixtures (no sampling)."""
    batch = {"bow": bow}
    if contextual is not None:
        batch["contextual"] = contextual
    return forward(params, cfg, batch, train=False,
                   input_mode=input_mode)["theta"]


# ---------------------------------------------------------------------------
# the weight carrier: reference tree <-> port dict
# ---------------------------------------------------------------------------
def params_from_reference(tree: Mapping[str, Any], *,
                          device="cpu") -> Params:
    """The reference's nested dict/list tree (``prodlda.init_params``
    layout in any input mode, numpy leaves) -> the port's ordered
    parameter dict.  Bitwise: every leaf is copied as float32 without
    arithmetic."""
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
    return to_tree(params, host)
