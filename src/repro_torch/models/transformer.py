"""Decoder/encoder transformer assembly for the port's LM families.

The port of the reference's ``models/transformer.py`` for the kinds
``dense`` (GQA with optional q/k/v biases, or MLA; SwiGLU), ``ssm``
(Mamba-2), ``hybrid`` (Hymba), ``vlm`` (the language backbone with
M-RoPE and the patch-embedding merge) and ``audio`` (the encoder-only
HuBERT stack: frame projection, masked-frame and position embeddings,
LayerNorm, GELU MLP, bidirectional attention, the prediction head); the
``moe`` kind raises ``NotImplementedError`` naming ROADMAP.md A16b.  The
ViT and the audio feature extractor are stubs, as in the reference:
batches carry precomputed ``patch_embeds`` or ``frame_embeds``.
Parameters keep the reference tree's names and per-layer layout:
``{"embed": {"table"}, "lm_head": {"w"}, "final_norm": {"scale"},
"layers": [...]}`` (audio: ``frontend_proj``, ``mask_embed``,
``pos_embed``, ``pred_head`` in place of the token embedding and head),
where the reference stacks the layers on a leading ``num_layers`` axis
for ``lax.scan`` and the port keeps a list of per-layer dicts and loops
over it in Python.  There is no mesh, so the reference's
``constrain_batch`` is the identity here (ROADMAP.md A17).  Positions
are the implicit ``arange(S)`` of the serve path (M-RoPE's streams may
come with the batch): a ``positions`` entry in the batch raises.
``cfg.remat_layers`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per
layer).  Training differentiates the fp32
masters: the layers cast each weight at its use (``w.to(x.dtype)``), and
``activation_copy`` (bf16 copies for serving) is not for training.

Public entry points:
  * ``init_params``      — parameter tree (fp32 masters) from a threefry
                           key, the reference's values
  * ``forward_train``    — full-sequence logits
  * ``xent_loss``, ``train_loss``, ``train_loss_sum`` — the training
                           objective (next-token labels, or audio's
                           masked-frame ``targets``; no MoE aux: no MoE
                           kind is ported)
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

from repro_torch.configs.base import (AUDIO, DENSE, HYBRID, SSM, VLM,
                                      ModelConfig)
from repro_torch.core import prng
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import hymba as hymba_lib
from repro_torch.models.layers import mamba2 as mamba_lib
from repro_torch.models.layers.embedding import (
    embed, embedding_init, lm_head, lm_head_init, lm_head_tied,
    masked_prediction_embed, merge_patch_embeds)
from repro_torch.models.layers.init import dense_init
from repro_torch.models.layers.mlp import (gelu_mlp, gelu_mlp_init, swiglu,
                                           swiglu_init)
from repro_torch.models.layers.norms import (layernorm, layernorm_init,
                                             rmsnorm, rmsnorm_init)
from repro_torch.models.layers.rope import (mrope_angles, rope_angles,
                                            text_mrope_positions)

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a kind of ``cfg`` the port has no layer for yet (MoE,
    and the NTMs, which run through ``repro_torch.api``)."""
    if cfg.kind not in (DENSE, SSM, HYBRID, VLM, AUDIO):
        raise NotImplementedError(
            f"{cfg.name}: kind {cfg.kind!r} not in the port yet "
            f"(ROADMAP.md A16b)")


def _check_decoder(cfg: ModelConfig) -> None:
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode path "
                         f"(DESIGN.md §7)")


def _dtype(cfg: ModelConfig, dtype) -> torch.dtype:
    return dtype or getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _norm_init(cfg, dim: int, dev) -> Params:
    if cfg.kind == AUDIO:
        return layernorm_init(dim, device=dev)
    return rmsnorm_init(dim, device=dev)


def _apply_norm(cfg, p, x):
    if cfg.kind == AUDIO:
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


def _ffn(cfg, p, x):
    return gelu_mlp(p, x) if cfg.activation == "gelu" else swiglu(p, x)


def _layer_init(key: torch.Tensor, cfg: ModelConfig) -> Params:
    d, dev = cfg.d_model, key.device
    k1, k2 = prng.split(key)
    if cfg.kind == SSM:
        return {"norm": _norm_init(cfg, d, dev),
                "mixer": mamba_lib.mamba2_init(k1, cfg)}
    if cfg.kind == HYBRID:
        mixer = hymba_lib.hymba_init(k1, cfg)
    elif cfg.use_mla:
        mixer = attn_lib.mla_init(k1, cfg)
    else:
        mixer = attn_lib.gqa_init(k1, cfg)
    ffn = gelu_mlp_init(k2, d, cfg.d_ff) if cfg.activation == "gelu" \
        else swiglu_init(k2, d, cfg.d_ff)
    return {"attn_norm": _norm_init(cfg, d, dev), "mixer": mixer,
            "ffn_norm": _norm_init(cfg, d, dev), "ffn": ffn}


def init_params(key: torch.Tensor, cfg: ModelConfig) -> Params:
    """Fresh fp32 weights from the threefry ``key``
    (``prng.PRNGKey(seed)``) on the reference's key tree: ``split(key,
    8)``, layer i from ``split(keys[0], num_layers)[i]``, the embedding
    from ``keys[1]`` and the head from ``keys[2]`` (audio: the frame
    projection, mask embedding, position embedding and prediction head
    from ``keys[1..4]``).  Drawn on the key's device, leaf by leaf, so
    each hash's int64 temporaries are one leaf's; the values are the
    reference's (``core/prng.py``)."""
    check_supported(cfg)
    dev = key.device
    keys = prng.split(key, 8)
    unit_keys = prng.split(keys[0], cfg.num_layers)
    params: Params = {
        "layers": [_layer_init(unit_keys[i], cfg)
                   for i in range(cfg.num_layers)],
        "final_norm": _norm_init(cfg, cfg.d_model, dev),
    }
    if cfg.kind == AUDIO:
        d = cfg.d_model
        params["frontend_proj"] = {
            "w": dense_init(keys[1], (cfg.frontend_embed_dim, d))}
        params["mask_embed"] = 0.02 * prng.normal(keys[2], (d,))
        params["pos_embed"] = 0.02 * prng.normal(keys[3],
                                                 (cfg.max_seq_len, d))
        params["pred_head"] = lm_head_init(keys[4], d, cfg.vocab_size)
        return params
    params["embed"] = embedding_init(keys[1], cfg.vocab_size, cfg.d_model)
    if not cfg.tie_embeddings:
        params["lm_head"] = lm_head_init(keys[2], cfg.d_model,
                                         cfg.vocab_size)
    return params


# weights the layers read only through a cast to the activation dtype
_CAST_ONLY = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "in_proj",
              "out_proj", "w_gate", "w_up", "w_down", "b_up", "b_down",
              "beta_attn", "w_dq", "w_uq", "w_dkv", "w_kr", "w_ukv",
              "mask_embed", "pos_embed")


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
    if "embed" in params and not cfg.tie_embeddings:
        out["embed"] = {"table": params["embed"]["table"].to(dtype)}
    if "frontend_proj" in params:
        out["frontend_proj"] = {"w": params["frontend_proj"]["w"].to(dtype)}
    return out


# ---------------------------------------------------------------------------
# full-sequence application (forward / prefill)
# ---------------------------------------------------------------------------
def _block_full(cfg, lp, x, angles, causal: bool):
    """One layer over the full sequence.  Returns (x, cache entry)."""
    if cfg.kind == SSM:
        h = _apply_norm(cfg, lp["norm"], x)
        y, state = mamba_lib.mamba2_apply(lp["mixer"], cfg, h)
        return x + y.to(x.dtype), state
    h = _apply_norm(cfg, lp["attn_norm"], x)
    if cfg.kind == HYBRID:
        y, ((k, v), (cs, ss)) = hymba_lib.hymba_full(lp["mixer"], cfg, h,
                                                     angles)
        cache = (k, v, cs, ss)
    elif cfg.use_mla:
        y, cache = attn_lib.mla_full(lp["mixer"], cfg, h, angles,
                                     causal=causal)
    else:
        y, cache = attn_lib.gqa_full(lp["mixer"], cfg, h, angles,
                                     causal=causal)
    x = x + y.to(x.dtype)
    h = _apply_norm(cfg, lp["ffn_norm"], x)
    return x + _ffn(cfg, lp["ffn"], h).to(x.dtype), cache


def _positions(cfg, batch, b: int, s: int, device) -> torch.Tensor:
    if batch.get("positions") is not None:
        raise NotImplementedError(
            "explicit positions (left-padded prompts) are not in the port: "
            "kernel B5 takes the implicit arange(S) (ROADMAP.md A16)")
    return torch.arange(s, device=device)[None].expand(b, s)


def _seq_shape(cfg, batch):
    """(B, S) and the device of the batch's input."""
    x = batch["frame_embeds"] if cfg.kind == AUDIO else batch["tokens"]
    return x.shape[0], x.shape[1], x.device


def _embed_input(params, cfg, batch, dtype):
    """The input embedding per modality: audio frames through the
    frontend projection, the masked-frame and position embeddings;
    tokens, with a VLM batch's patch embeddings merged in."""
    if cfg.kind == AUDIO:
        x = torch.matmul(batch["frame_embeds"].to(dtype),
                         params["frontend_proj"]["w"].to(dtype))
        x = masked_prediction_embed({"mask_embed": params["mask_embed"]}, x,
                                    batch["frame_mask"])
        return x + params["pos_embed"][:x.shape[1]].to(dtype)
    x = embed(params["embed"], batch["tokens"], dtype)
    if cfg.kind == VLM and "patch_embeds" in batch:
        x = merge_patch_embeds(x, batch["patch_embeds"],
                               batch["patch_positions"])
    return x


def _angles_for(cfg, batch, positions):
    if cfg.kind in (SSM, AUDIO):
        return None          # no rotary branch reads them
    if cfg.use_mla:
        return rope_angles(positions, cfg.mla_rope_head_dim, cfg.rope_theta)
    if cfg.use_mrope:
        mpos = batch.get("mrope_positions")
        if mpos is None:
            mpos = text_mrope_positions(positions)
        return mrope_angles(mpos, cfg.resolved_head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _run_layers_full(params, cfg, x, angles, *, causal: bool,
                     want_cache: bool):
    caches: List[Any] = []
    remat = cfg.remat_layers and not want_cache and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:
            x = checkpoint(
                lambda x, lp: _block_full(cfg, lp, x, angles, causal)[0],
                x, lp, use_reentrant=False)
            continue
        x, cache = _block_full(cfg, lp, x, angles, causal)
        if want_cache:
            caches.append(cache)
    return x, caches


def _logits(params, cfg, x):
    if cfg.kind == AUDIO:
        return lm_head(params["pred_head"], x)
    if cfg.tie_embeddings:
        return lm_head_tied(params["embed"], x)
    return lm_head(params["lm_head"], x)


def forward_train(params, cfg: ModelConfig, batch, *, dtype=None):
    """Full-sequence forward (bidirectional for an encoder-only config).
    Returns (logits fp32, aux fp32 zero — the reference's MoE aux term,
    always 0 for the ported kinds)."""
    check_supported(cfg)
    dtype = _dtype(cfg, dtype)
    b, s, device = _seq_shape(cfg, batch)
    positions = _positions(cfg, batch, b, s, device)
    x = _embed_input(params, cfg, batch, dtype)
    x, _ = _run_layers_full(params, cfg, x,
                            _angles_for(cfg, batch, positions),
                            causal=not cfg.encoder_only, want_cache=False)
    x = _apply_norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, x), torch.zeros((), device=device)


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


def _labels_and_mask(cfg, batch):
    """Next-token ``labels`` and the optional ``loss_mask``; audio's
    masked-frame ``targets`` under its ``frame_mask``."""
    if cfg.kind == AUDIO:
        return batch["targets"], batch["frame_mask"]
    return batch["labels"], batch.get("loss_mask")


def train_loss(params, cfg: ModelConfig, batch, *, dtype=None):
    """Scalar mean token loss of a batch (``labels``, optional
    ``loss_mask``; audio: ``targets`` under ``frame_mask``)."""
    logits, _ = forward_train(params, cfg, batch, dtype=dtype)
    s, n = xent_loss(logits, *_labels_and_mask(cfg, batch))
    return s / torch.clamp(n, min=1.0)


def train_loss_sum(params, cfg: ModelConfig, batch, *, dtype=None):
    """``(sum_loss, num_tokens)`` form of :func:`train_loss`: a
    ``doc_mask`` row mask (zero-padded cohort rows) multiplies into the
    token mask, so padded documents stay out of the objective and its
    gradient."""
    logits, _ = forward_train(params, cfg, batch, dtype=dtype)
    labels, mask = _labels_and_mask(cfg, batch)
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
    """Zeroed decode cache covering ``seq_len`` positions (MLA: the
    latent ``ckv`` and the rope key ``kr``)."""
    check_supported(cfg)
    _check_decoder(cfg)
    dtype = _dtype(cfg, dtype)
    nl = cfg.num_layers
    c = _cache_len(cfg, seq_len)
    out: Dict[str, Any] = {"pos": 0}
    if cfg.use_mla:
        for key, width in (("ckv", cfg.mla_kv_lora_rank),
                           ("kr", cfg.mla_rope_head_dim)):
            out[key] = torch.zeros((nl, batch_size, c, width), dtype=dtype,
                                   device=device)
    elif cfg.kind != SSM:
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
    names = ("ckv", "kr") if cfg.use_mla else ("k", "v")
    for j, key in enumerate(names):
        out[key] = torch.stack([_fit(e[j].to(dtype), c) for e in caches])
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
    _check_decoder(cfg)
    dtype = _dtype(cfg, dtype)
    b, s, device = _seq_shape(cfg, batch)
    positions = _positions(cfg, batch, b, s, device)
    x = _embed_input(params, cfg, batch, dtype)
    x, caches = _run_layers_full(params, cfg, x,
                                 _angles_for(cfg, batch, positions),
                                 causal=True, want_cache=True)
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = _logits(params, cfg, x)
    return logits, _cache_from_full(cfg, caches, s, dtype, max_len=max_len)


def _block_decode(cfg, lp, x, angles, cache, i: int, pos: int):
    """One layer, one token; writes layer ``i`` of ``cache`` in place."""
    if cfg.kind == SSM:
        h = _apply_norm(cfg, lp["norm"], x)
        y, (cs, ss) = mamba_lib.mamba2_decode(
            lp["mixer"], cfg, h, conv_state=cache["conv"][i],
            ssm_state=cache["ssm"][i])
        cache["conv"][i], cache["ssm"][i] = cs, ss
        return x + y.to(x.dtype)
    h = _apply_norm(cfg, lp["attn_norm"], x)
    if cfg.use_mla:
        decode = attn_lib.mla_decode_absorbed if cfg.mla_absorb \
            else attn_lib.mla_decode
        y, _ = decode(lp["mixer"], cfg, h, angles,
                      cache_ckv=cache["ckv"][i], cache_kr=cache["kr"][i],
                      pos=pos)
    elif cfg.kind == HYBRID:
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
    h = _apply_norm(cfg, lp["ffn_norm"], x)
    return x + _ffn(cfg, lp["ffn"], h).to(x.dtype)


def decode_step(params, cfg: ModelConfig, cache, tokens, *, batch=None,
                dtype=None):
    """Decode ONE token.  tokens (B, 1).  Returns (logits, cache): the
    cache's tensors are updated in place (the reference returns new
    arrays; the port saves a copy of every layer's cache per token) and
    the returned dict carries ``pos + 1``.  ``batch`` is the reference's:
    the angles read its ``mrope_positions`` if it has them (M-RoPE),
    else the step's text position."""
    check_supported(cfg)
    _check_decoder(cfg)
    dtype = _dtype(cfg, dtype)
    b = tokens.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((b, 1), pos, device=tokens.device)
    x = embed(params["embed"], tokens, dtype)
    angles = _angles_for(cfg, batch or {}, positions)
    for i, lp in enumerate(params["layers"]):
        x = _block_decode(cfg, lp, x, angles, cache, i, pos)
    x = _apply_norm(cfg, params["final_norm"], x)
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
