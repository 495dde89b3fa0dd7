"""Decoder transformer assembly for the port's LM families.

The port of the reference's ``models/transformer.py`` for the kinds
``dense`` (GQA + SwiGLU), ``ssm`` (Mamba-2) and ``hybrid`` (Hymba); MoE,
MLA, M-RoPE, the audio and VLM frontends raise ``NotImplementedError``
naming ROADMAP.md A16.  Parameters keep the reference tree's names and
per-layer layout: ``{"embed": {"table"}, "lm_head": {"w"}, "final_norm":
{"scale"}, "layers": [...]}``, where the reference stacks the layers on
a leading ``num_layers`` axis for ``lax.scan`` and the port keeps a list
of per-layer dicts and loops over it in Python.  There is no mesh, so
the reference's ``constrain_batch`` is the identity here (ROADMAP.md
A17).  Positions are the implicit ``arange(S)`` of the serve path: a
``positions`` entry in the batch raises.  ``cfg.remat_layers`` recomputes
each layer in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` per layer).  Training differentiates the fp32
masters: the layers cast each weight at its use (``w.to(x.dtype)``), and
``activation_copy`` (bf16 copies for serving) is not for training.

Public entry points:
  * ``init_params``      — parameter tree (fp32 masters)
  * ``forward_train``    — full-sequence logits
  * ``xent_loss``, ``train_loss``, ``train_loss_sum`` — the training
                           objective (no MoE aux: no MoE kind is ported)
  * ``prefill``          — logits + populated decode cache
  * ``decode_step``      — ONE token against the cache (updated in place)
  * ``init_cache``       — zeroed decode cache for a given batch/seq
  * ``params_from_reference`` — the reference's tree -> this layout
  * ``stack_layers``, ``unstack_layers`` — this layout <-> one flat dict
                           of the reference's (layer-stacked) leaves
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import DENSE, HYBRID, SSM, ModelConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import hymba as hymba_lib
from repro_torch.models.layers import mamba2 as mamba_lib
from repro_torch.models.layers.embedding import (embed, embedding_init,
                                                 lm_head, lm_head_init,
                                                 lm_head_tied)
from repro_torch.models.layers.mlp import swiglu, swiglu_init
from repro_torch.models.layers.norms import rmsnorm, rmsnorm_init
from repro_torch.models.layers.rope import rope_angles

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every kind or field of ``cfg`` the port has no layer
    for yet."""
    missing = []
    if cfg.kind not in (DENSE, SSM, HYBRID):
        missing.append(f"kind {cfg.kind!r}")
    for flag in ("use_mla", "use_mrope", "encoder_only", "qkv_bias"):
        if getattr(cfg, flag):
            missing.append(flag)
    if cfg.kind != SSM and cfg.activation != "swiglu":
        missing.append(f"activation {cfg.activation!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not in the port yet "
            f"(ROADMAP.md A16)")


def _dtype(cfg: ModelConfig, dtype) -> torch.dtype:
    return dtype or getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_init(cfg: ModelConfig, kw) -> Params:
    d, dev = cfg.d_model, kw["device"]
    if cfg.kind == SSM:
        return {"norm": rmsnorm_init(d, device=dev),
                "mixer": mamba_lib.mamba2_init(cfg, **kw)}
    mixer = hymba_lib.hymba_init(cfg, **kw) if cfg.kind == HYBRID \
        else attn_lib.gqa_init(cfg, **kw)
    return {"attn_norm": rmsnorm_init(d, device=dev), "mixer": mixer,
            "ffn_norm": rmsnorm_init(d, device=dev),
            "ffn": swiglu_init(d, cfg.d_ff, **kw)}


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device) -> Params:
    """Fresh fp32 weights from ``generator`` (drawn on the CPU and moved,
    so a seed gives the same weights on every device)."""
    check_supported(cfg)
    kw = dict(generator=generator, device=device)
    params: Params = {
        "layers": [_layer_init(cfg, kw) for _ in range(cfg.num_layers)],
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
        "embed": embedding_init(cfg.vocab_size, cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = lm_head_init(cfg.d_model, cfg.vocab_size, **kw)
    return params


# weights the layers read only through a cast to the activation dtype
_CAST_ONLY = ("wq", "wk", "wv", "wo", "in_proj", "out_proj", "w_gate",
              "w_up", "w_down", "beta_attn")


def activation_copy(params: Params, cfg: ModelConfig, dtype) -> Params:
    """The tree with every weight that the layers only read cast to
    ``dtype`` (``x @ w.to(x.dtype)``) stored once in ``dtype``: the
    products see the same bits as the per-use casts of the fp32 masters,
    without a cast at every call.  Norm scales, the SSM's fp32 vectors,
    ``beta_ssm`` (it meets an fp32 branch) and a tied embedding (the head
    reads it in fp32) stay as they are."""
    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        return {k: (v.to(dtype) if k in _CAST_ONLY else
                    walk(v) if isinstance(v, (dict, list)) else v)
                for k, v in node.items()}
    out = walk(params)
    if not cfg.tie_embeddings:
        out["embed"] = {"table": params["embed"]["table"].to(dtype)}
    return out


# ---------------------------------------------------------------------------
# full-sequence application (forward / prefill)
# ---------------------------------------------------------------------------
def _block_full(cfg, lp, x, angles):
    """One layer over the full sequence.  Returns (x, cache entry)."""
    if cfg.kind == SSM:
        h = rmsnorm(lp["norm"], x, cfg.norm_eps)
        y, state = mamba_lib.mamba2_apply(lp["mixer"], cfg, h)
        return x + y.to(x.dtype), state
    h = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    if cfg.kind == HYBRID:
        y, ((k, v), (cs, ss)) = hymba_lib.hymba_full(lp["mixer"], cfg, h,
                                                     angles)
        cache = (k, v, cs, ss)
    else:
        y, cache = attn_lib.gqa_full(lp["mixer"], cfg, h, angles,
                                     causal=True)
    x = x + y.to(x.dtype)
    h = rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
    return x + swiglu(lp["ffn"], h).to(x.dtype), cache


def _positions(cfg, batch, b: int, s: int, device) -> torch.Tensor:
    if batch.get("positions") is not None:
        raise NotImplementedError(
            "explicit positions (left-padded prompts) are not in the port: "
            "kernel B5 takes the implicit arange(S) (ROADMAP.md A16)")
    return torch.arange(s, device=device)[None].expand(b, s)


def _angles_for(cfg, positions):
    if cfg.kind == SSM:
        return None          # no attention branch reads them
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _run_layers_full(params, cfg, x, angles, *, want_cache: bool):
    caches: List[Any] = []
    remat = cfg.remat_layers and not want_cache and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:
            x = checkpoint(lambda x, lp: _block_full(cfg, lp, x, angles)[0],
                           x, lp, use_reentrant=False)
            continue
        x, cache = _block_full(cfg, lp, x, angles)
        if want_cache:
            caches.append(cache)
    return x, caches


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        return lm_head_tied(params["embed"], x)
    return lm_head(params["lm_head"], x)


def forward_train(params, cfg: ModelConfig, batch, *, dtype=None):
    """Full-sequence forward.  Returns (logits fp32, aux fp32 zero — the
    reference's MoE aux term, always 0 for the ported kinds)."""
    check_supported(cfg)
    dtype = _dtype(cfg, dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(cfg, batch, b, s, tokens.device)
    x = embed(params["embed"], tokens, dtype)
    x, _ = _run_layers_full(params, cfg, x, _angles_for(cfg, positions),
                            want_cache=False)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), torch.zeros((), device=tokens.device)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def xent_loss(logits, labels, mask=None):
    """Masked token cross-entropy as ``(sum_loss, num_tokens)``: the pair,
    not the mean, is what lets the federated protocol weight clients by
    their token counts (Eq. 2)."""
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    mask = torch.ones_like(ll) if mask is None else mask.to(torch.float32)
    return -torch.sum(ll * mask), torch.sum(mask)


def train_loss(params, cfg: ModelConfig, batch, *, dtype=None):
    """Scalar mean token loss of a batch (``labels``, optional
    ``loss_mask``)."""
    logits, _ = forward_train(params, cfg, batch, dtype=dtype)
    s, n = xent_loss(logits, batch["labels"], batch.get("loss_mask"))
    return s / torch.clamp(n, min=1.0)


def train_loss_sum(params, cfg: ModelConfig, batch, *, dtype=None):
    """``(sum_loss, num_tokens)`` form of :func:`train_loss`: a
    ``doc_mask`` row mask (zero-padded cohort rows) multiplies into the
    token mask, so padded documents stay out of the objective and its
    gradient."""
    logits, _ = forward_train(params, cfg, batch, dtype=dtype)
    labels, mask = batch["labels"], batch.get("loss_mask")
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device) if mask is None \
        else mask.to(torch.float32)
    doc_mask = batch.get("doc_mask")
    if doc_mask is not None:
        mask = mask * doc_mask.to(torch.float32)[..., None]
    return xent_loss(logits, labels, mask)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------
def _cache_len(cfg, seq_len: int) -> int:
    return cfg.sliding_window if cfg.sliding_window else seq_len


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, dtype=None,
               *, device) -> Dict[str, Any]:
    """Zeroed decode cache covering ``seq_len`` positions."""
    check_supported(cfg)
    dtype = _dtype(cfg, dtype)
    nl = cfg.num_layers
    c = _cache_len(cfg, seq_len)
    out: Dict[str, Any] = {"pos": 0}
    if cfg.kind != SSM:
        shape = (nl, batch_size, c, cfg.num_kv_heads, cfg.resolved_head_dim)
        out["k"] = torch.zeros(shape, dtype=dtype, device=device)
        out["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.kind in (SSM, HYBRID):
        _, nh, conv_ch = mamba_lib.mamba2_dims(cfg)
        out["conv"] = torch.zeros((nl, batch_size, cfg.ssm.conv_width - 1,
                                   conv_ch), dtype=torch.float32,
                                  device=device)
        out["ssm"] = torch.zeros((nl, batch_size, nh, cfg.ssm.head_dim,
                                  cfg.ssm.state_dim), dtype=torch.float32,
                                 device=device)
    return out


def _fit(arr: torch.Tensor, c: int) -> torch.Tensor:
    """(B, S, ...) prefill keys/values -> (B, c, ...) in decode layout:
    with S > c (ring buffer) the last c positions, position p at slot
    p % c; with S < c zero headroom after them."""
    s = arr.shape[1]
    if s > c:
        return torch.roll(arr[:, s - c:], shifts=(s - c) % c, dims=1)
    if s < c:
        pad = torch.zeros((arr.shape[0], c - s) + arr.shape[2:],
                          dtype=arr.dtype, device=arr.device)
        return torch.cat([arr, pad], dim=1)
    return arr


def _cache_from_full(cfg, caches, seq_len: int, dtype,
                     max_len: Optional[int] = None) -> Dict[str, Any]:
    """Per-layer prefill outputs -> the decode cache (layers stacked on a
    leading axis, as the reference's).  ``max_len`` (>= seq_len) sets the
    capacity, so decode has headroom past the prefill."""
    c = _cache_len(cfg, max_len or seq_len)
    out: Dict[str, Any] = {"pos": seq_len}
    if cfg.kind == SSM:
        out["conv"] = torch.stack([cs for cs, _ in caches])
        out["ssm"] = torch.stack([ss for _, ss in caches])
        return out
    out["k"] = torch.stack([_fit(e[0].to(dtype), c) for e in caches])
    out["v"] = torch.stack([_fit(e[1].to(dtype), c) for e in caches])
    if cfg.kind == HYBRID:
        out["conv"] = torch.stack([e[2] for e in caches])
        out["ssm"] = torch.stack([e[3] for e in caches])
    return out


def prefill(params, cfg: ModelConfig, batch, *, dtype=None,
            max_len: Optional[int] = None):
    """Full-sequence forward that also returns the decode cache;
    ``max_len`` (>= seq_len) sets the cache capacity (default: the
    prefill length, no decode headroom)."""
    check_supported(cfg)
    dtype = _dtype(cfg, dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(cfg, batch, b, s, tokens.device)
    x = embed(params["embed"], tokens, dtype)
    x, caches = _run_layers_full(params, cfg, x, _angles_for(cfg, positions),
                                 want_cache=True)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, x)
    return logits, _cache_from_full(cfg, caches, s, dtype, max_len=max_len)


def _block_decode(cfg, lp, x, angles, cache, i: int, pos: int):
    """One layer, one token; writes layer ``i`` of ``cache`` in place."""
    if cfg.kind == SSM:
        h = rmsnorm(lp["norm"], x, cfg.norm_eps)
        y, (cs, ss) = mamba_lib.mamba2_decode(
            lp["mixer"], cfg, h, conv_state=cache["conv"][i],
            ssm_state=cache["ssm"][i])
        cache["conv"][i], cache["ssm"][i] = cs, ss
        return x + y.to(x.dtype)
    h = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    if cfg.kind == HYBRID:
        y, (_, _, cs, ss) = hymba_lib.hymba_decode(
            lp["mixer"], cfg, h, angles, cache_k=cache["k"][i],
            cache_v=cache["v"][i], pos=pos, conv_state=cache["conv"][i],
            ssm_state=cache["ssm"][i])
        cache["conv"][i], cache["ssm"][i] = cs, ss
    else:
        y, _ = attn_lib.gqa_decode(lp["mixer"], cfg, h, angles,
                                   cache_k=cache["k"][i],
                                   cache_v=cache["v"][i], pos=pos)
    x = x + y.to(x.dtype)
    h = rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
    return x + swiglu(lp["ffn"], h).to(x.dtype)


def decode_step(params, cfg: ModelConfig, cache, tokens, *, dtype=None):
    """Decode ONE token.  tokens (B, 1).  Returns (logits, cache): the
    cache's tensors are updated in place (the reference returns new
    arrays; the port saves a copy of every layer's cache per token) and
    the returned dict carries ``pos + 1``."""
    check_supported(cfg)
    dtype = _dtype(cfg, dtype)
    b = tokens.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((b, 1), pos, device=tokens.device)
    x = embed(params["embed"], tokens, dtype)
    angles = _angles_for(cfg, positions)
    for i, lp in enumerate(params["layers"]):
        x = _block_decode(cfg, lp, x, angles, cache, i, pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    out = dict(cache)
    out["pos"] = pos + 1
    return _logits(params, cfg, x), out


# ---------------------------------------------------------------------------
# the weight carrier: reference tree -> port tree
# ---------------------------------------------------------------------------
def params_from_reference(tree: Mapping[str, Any], cfg: ModelConfig, *,
                          device="cpu") -> Params:
    """The reference's transformer tree (``repro.models.transformer.
    init_params`` layout, numpy or array leaves, ``layers`` stacked on a
    leading ``num_layers`` axis) -> the port's tree (a list of per-layer
    dicts).  Bitwise: every leaf is copied as float32 without
    arithmetic."""
    check_supported(cfg)

    def conv(node, i=None):
        if isinstance(node, Mapping):
            return {k: conv(v, i) for k, v in node.items()}
        a = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(np.array(a if i is None else a[i])) \
            .to(device)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [conv(tree["layers"], i) for i in range(cfg.num_layers)]
    return out


def _leaf_paths(node, prefix=()):
    if isinstance(node, Mapping):
        for k in sorted(node):
            yield from _leaf_paths(node[k], prefix + (k,))
    else:
        yield prefix, node


def stack_layers(params: Params) -> Dict[str, torch.Tensor]:
    """The port's tree -> one flat dict of the reference's leaves: dotted
    paths in the reference's (sorted-key) order, each per-layer leaf
    stacked on a leading ``num_layers`` axis as the reference stacks it.
    The federation engine holds this form, so each of its per-leaf
    segments (top-k's count, the secure masks) is a leaf of the
    reference's tree."""
    out: Dict[str, torch.Tensor] = {}
    for key in sorted(params):
        if key != "layers":
            for path, leaf in _leaf_paths(params[key], (key,)):
                out[".".join(path)] = leaf
            continue
        per_layer = [dict(_leaf_paths(lp)) for lp in params["layers"]]
        for path in per_layer[0] if per_layer else ():
            out[".".join(("layers",) + path)] = torch.stack(
                [lp[path] for lp in per_layer])
    return out


def unstack_layers(flat: Mapping[str, torch.Tensor]) -> Params:
    """The inverse of :func:`stack_layers`, as views: each stacked leaf
    is unbound into its layers (under ``torch.func`` transforms too), so
    a gradient through the tree reaches the stacked leaf."""
    tree: Params = {"layers": []}

    def put(node, path, value):
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    for name, leaf in flat.items():
        path = name.split(".")
        if path[0] != "layers":
            put(tree, path, leaf)
            continue
        parts = leaf.unbind(0)
        if not tree["layers"]:
            tree["layers"] = [{} for _ in parts]
        for lp, part in zip(tree["layers"], parts):
            put(lp, path[1:], part)
    return tree
