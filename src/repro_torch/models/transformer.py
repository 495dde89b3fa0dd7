"""Decoder/encoder transformer assembly for the port's LM families.

The port of the reference's ``models/transformer.py`` for every kind
of its zoo: ``dense`` (GQA with optional q/k/v biases, or MLA; SwiGLU),
``moe`` (the same attention, the FFN a mixture of experts,
``models/layers/moe.py``; with ``moe.moe_every == 2`` a dense and a MoE
layer alternate), ``ssm`` (Mamba-2), ``hybrid`` (Hymba), ``vlm`` (the
language backbone with M-RoPE and the patch-embedding merge) and
``audio`` (the encoder-only HuBERT stack: frame projection, masked-frame
and position embeddings, LayerNorm, GELU MLP, bidirectional attention,
the prediction head).  The ViT and the audio feature extractor are
stubs, as in the reference: batches carry precomputed ``patch_embeds``
or ``frame_embeds``.  Parameters keep the reference tree's names and
per-unit layout: ``{"embed": {"table"}, "lm_head": {"w"},
"final_norm": {"scale"}, "layers": [...]}`` (audio: ``frontend_proj``,
``mask_embed``, ``pos_embed``, ``pred_head`` in place of the token
embedding and head), where the reference stacks the units on a leading
axis for ``lax.scan`` and the port keeps a list of per-unit dicts and
loops over it in Python.  A unit is a layer, or with ``moe_every == 2``
the pair ``{"dense_sub", "moe_sub"}``, so a llama4 tree holds
``num_layers // 2`` units (the reference's ``_unit_layout``).  Under a
mesh (``parallel.sharding.use_abstract_mesh``, on DTensor activations)
each unit's input and output and the head's input are pinned
batch-sharded and the logits batch- and vocab-sharded, at the
reference's sites (``constrain_batch``, ``constrain_batch_and_last``;
the identity off-mesh).  Positions
are the batch's ``positions`` (B, S) where it has them (left-padded
prompts: ``arange(S) - pad``), which the rotary angles read and the
attention mask compares (B5 skips the pad keys; a pad query attends
nothing and gives 0), else the implicit ``arange(S)``; a VLM's M-RoPE
streams may come with the batch as ``mrope_positions``, the mask still
reading ``positions``.
``cfg.remat_layers`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per
layer).  Training differentiates the fp32
masters: the layers cast each weight at its use (``w.to(x.dtype)``), and
``activation_copy`` (bf16 copies for serving) is not for training.

Public entry points:
  * ``init_params``      — parameter tree (fp32 masters, or the serving
                           dtype for the weights read through a cast)
                           from a threefry key, the reference's values
  * ``init_param_shapes`` — the same tree as empty (meta) tensors, no draw
  * ``forward_train``    — full-sequence logits and the summed MoE aux
  * ``xent_loss``, ``train_loss``, ``train_loss_sum`` — the training
                           objective (next-token labels, or audio's
                           masked-frame ``targets``; plus
                           ``router_aux_weight`` x aux for MoE)
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

from repro_torch.configs.base import (AUDIO, DENSE, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.core import prng
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import hymba as hymba_lib
from repro_torch.models.layers import mamba2 as mamba_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers.embedding import (
    embed, embedding_init, lm_head, lm_head_init, lm_head_tied,
    masked_prediction_embed, merge_patch_embeds)
from repro_torch.models.layers.init import (Draw, deferred, dense_init,
                                            embed_init)
from repro_torch.models.layers.mlp import (gelu_mlp, gelu_mlp_init, swiglu,
                                           swiglu_init)
from repro_torch.models.layers.norms import (layernorm, layernorm_init,
                                             rmsnorm, rmsnorm_init)
from repro_torch.models.layers.rope import (mrope_angles, rope_angles,
                                            text_mrope_positions)
from repro_torch.parallel.sharding import (constrain_batch,
                                           constrain_batch_and_last,
                                           constrain_lookup)

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a kind of ``cfg`` that is no transformer (the NTMs run
    through ``repro_torch.api``)."""
    if cfg.kind not in (DENSE, MOE, SSM, HYBRID, VLM, AUDIO):
        raise ValueError(
            f"{cfg.name}: kind {cfg.kind!r} is no transformer; the NTMs "
            f"run through repro_torch.api")


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
    """The layer's FFN output and its MoE aux (None for a dense FFN)."""
    if "router" in p:
        return moe_lib.moe_apply(p, cfg, x)
    return (gelu_mlp(p, x) if cfg.activation == "gelu" else swiglu(p, x)), \
        None


def _interleaved(cfg: ModelConfig) -> bool:
    """A unit is a dense and a MoE layer (``moe_every == 2``, llama4;
    the reference's ``_unit_layout``), else one layer."""
    if cfg.kind != MOE or cfg.moe.moe_every == 1:
        return False
    if cfg.moe.moe_every != 2:
        raise ValueError("moe_every in {1, 2} supported")
    return True


def num_units(cfg: ModelConfig) -> int:
    """Entries of ``params["layers"]`` (and of the decode cache)."""
    return cfg.num_layers // (2 if _interleaved(cfg) else 1)


def _kv_names(cfg: ModelConfig):
    """The K/V cache entries of each layer of a unit, in order."""
    return (("k", "v"), ("k2", "v2")) if _interleaved(cfg) else (("k", "v"),)


def _sub_layers(cfg, lp):
    """A unit's layers in order, each with its K/V cache entries."""
    subs = (lp["dense_sub"], lp["moe_sub"]) if _interleaved(cfg) else (lp,)
    return zip(subs, _kv_names(cfg))


def _layer_init(key: torch.Tensor, cfg: ModelConfig,
                moe_layer: bool = False) -> Params:
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
    if moe_layer:
        ffn = moe_lib.moe_init(k2, cfg)
    elif cfg.activation == "gelu":
        ffn = gelu_mlp_init(k2, d, cfg.d_ff)
    else:
        ffn = swiglu_init(k2, d, cfg.d_ff)
    return {"attn_norm": _norm_init(cfg, d, dev), "mixer": mixer,
            "ffn_norm": _norm_init(cfg, d, dev), "ffn": ffn}


def _unit_init(key: torch.Tensor, cfg: ModelConfig) -> Params:
    if _interleaved(cfg):
        ka, kb = prng.split(key)
        return {"dense_sub": _layer_init(ka, cfg),
                "moe_sub": _layer_init(kb, cfg, moe_layer=True)}
    return _layer_init(key, cfg, moe_layer=cfg.kind == MOE)


def _init_tree(key: torch.Tensor, cfg: ModelConfig) -> Params:
    dev = key.device
    keys = prng.split(key, 8)
    unit_keys = prng.split(keys[0], num_units(cfg))
    params: Params = {
        "layers": [_unit_init(unit_keys[i], cfg)
                   for i in range(num_units(cfg))],
        "final_norm": _norm_init(cfg, cfg.d_model, dev),
    }
    if cfg.kind == AUDIO:
        d = cfg.d_model
        params["frontend_proj"] = {
            "w": dense_init(keys[1], (cfg.frontend_embed_dim, d))}
        params["mask_embed"] = embed_init(keys[2], (d,), scale=0.02)
        params["pos_embed"] = embed_init(keys[3], (cfg.max_seq_len, d),
                                         scale=0.02)
        params["pred_head"] = lm_head_init(keys[4], d, cfg.vocab_size)
        return params
    params["embed"] = embedding_init(keys[1], cfg.vocab_size, cfg.d_model)
    if not cfg.tie_embeddings:
        params["lm_head"] = lm_head_init(keys[2], cfg.d_model,
                                         cfg.vocab_size)
    return params


def init_params(key: torch.Tensor, cfg: ModelConfig, dtype=None) -> Params:
    """Fresh weights from the threefry ``key`` (``prng.PRNGKey(seed)``)
    on the reference's key tree: ``split(key, 8)``, unit i from
    ``split(keys[0], num_units)[i]`` (a llama4 unit: its dense and MoE
    layers from ``split`` of that key), the embedding from ``keys[1]``
    and the head from ``keys[2]`` (audio: the frame projection, mask
    embedding, position embedding and prediction head from
    ``keys[1..4]``).  Drawn on the key's device, leaf by leaf, so each
    hash's int64 temporaries are one leaf's; the values are the
    reference's (``core/prng.py``).

    fp32 masters by default.  With ``dtype``, every weight that
    :func:`activation_copy` casts is drawn straight into ``dtype``, each
    chunk of its hash cast as it is written: bitwise
    ``activation_copy(init_params(key, cfg), cfg, dtype)`` without a
    float32 copy of a whole weight (a llama4 expert tensor is 21.5 GB of
    fp32)."""
    check_supported(cfg)
    if dtype is None or dtype == torch.float32:
        return _init_tree(key, cfg)
    with deferred():
        tree = _init_tree(key, cfg)

    def draw(path, leaf):
        cast = dtype if _read_through_cast(cfg, path) else None
        if isinstance(leaf, Draw):
            return leaf(cast)
        return leaf if cast is None else leaf.to(cast)
    return _map_leaves(tree, draw)


def init_param_shapes(cfg: ModelConfig, dtype=None, *,
                      device="meta") -> Params:
    """The tree :func:`init_params` gives, as empty tensors on ``device``
    (``meta``: shapes and dtypes, no storage) and with no weight drawn:
    the tree is built with every draw deferred, and each leaf is read off
    its :class:`~repro_torch.models.layers.init.Draw` (the few leaves
    computed in place, norm scales and the SSM's constants, are small).
    What the dry run shards, where a fake-tensor threefry draw of a MoE
    tree would take minutes on the host."""
    check_supported(cfg)
    with deferred():
        tree = _init_tree(prng.PRNGKey(0), cfg)

    def empty(path, leaf):
        cast = dtype if dtype is not None and dtype != torch.float32 \
            and _read_through_cast(cfg, path) else None
        if isinstance(leaf, Draw):
            return torch.empty(leaf.shape, dtype=cast or torch.float32,
                               device=device)
        return torch.empty(leaf.shape, dtype=cast or leaf.dtype,
                           device=device)
    return _map_leaves(tree, empty)


# weights the layers read only through a cast to the activation dtype
_CAST_ONLY = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "in_proj",
              "out_proj", "w_gate", "w_up", "w_down", "b_up", "b_down",
              "beta_attn", "w_dq", "w_uq", "w_dkv", "w_kr", "w_ukv",
              "mask_embed", "pos_embed")


def _read_through_cast(cfg: ModelConfig, path) -> bool:
    """The leaf at ``path`` (its keys from the root, list indices left
    out) is read only through a cast to the activation dtype."""
    return path[-1] in _CAST_ONLY or path[0] == "frontend_proj" \
        or (path[0] == "embed" and not cfg.tie_embeddings)


def _map_leaves(node, fn, path=()):
    if isinstance(node, list):
        return [_map_leaves(v, fn, path) for v in node]
    if isinstance(node, dict):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in node.items()}
    return fn(path, node)


def activation_copy(params: Params, cfg: ModelConfig, dtype) -> Params:
    """The tree with every weight that the layers only read cast to
    ``dtype`` (``x @ w.to(x.dtype)``) stored once in ``dtype``: the
    products see the same bits as the per-use casts of the fp32 masters,
    without a cast at every call.  Norm scales, the SSM's fp32 vectors,
    ``beta_ssm`` (it meets an fp32 branch), the MoE router (it runs in
    fp32) and a tied embedding (the head reads it in fp32) stay as they
    are."""
    return _map_leaves(params, lambda path, v: v.to(dtype)
                       if _read_through_cast(cfg, path) else v)


# ---------------------------------------------------------------------------
# full-sequence application (forward / prefill)
# ---------------------------------------------------------------------------
def _block_full(cfg, lp, x, angles, positions, causal: bool):
    """One layer over the full sequence; ``positions`` (B, S) the mask's,
    or ``None`` for ``arange(S)``.  Returns (x, cache entry, MoE aux or
    None)."""
    if cfg.kind == SSM:
        h = _apply_norm(cfg, lp["norm"], x)
        y, state = mamba_lib.mamba2_apply(lp["mixer"], cfg, h)
        return x + y.to(x.dtype), state, None
    h = _apply_norm(cfg, lp["attn_norm"], x)
    if cfg.kind == HYBRID:
        y, ((k, v), (cs, ss)) = hymba_lib.hymba_full(
            lp["mixer"], cfg, h, angles, positions=positions)
        cache = (k, v, cs, ss)
    elif cfg.use_mla:
        y, cache = attn_lib.mla_full(lp["mixer"], cfg, h, angles,
                                     positions=positions, causal=causal)
    else:
        y, cache = attn_lib.gqa_full(lp["mixer"], cfg, h, angles,
                                     positions=positions, causal=causal)
    x = x + y.to(x.dtype)
    h = _apply_norm(cfg, lp["ffn_norm"], x)
    y, aux = _ffn(cfg, lp["ffn"], h)
    return x + y.to(x.dtype), cache, aux


def _unit_full(cfg, lp, x, angles, positions, causal: bool):
    """One unit over the full sequence: (x, its layers' cache entries,
    the sum of their MoE aux terms or None)."""
    caches, aux = [], None
    for sub, _ in _sub_layers(cfg, lp):
        x, cache, a = _block_full(cfg, sub, x, angles, positions, causal)
        caches.append(cache)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, caches, aux


def _positions(batch, b: int, s: int, device):
    """(the positions the rotary angles read, the mask's): the batch's
    ``positions`` (B, S) for both where it has them, the mask's cast once
    to the int32 B5 reads, else ``arange(S)`` and ``None``, which keeps B5
    on its index-masked instances."""
    positions = batch.get("positions")
    if positions is None:
        return torch.arange(s, device=device)[None].expand(b, s), None
    if tuple(positions.shape) != (b, s):
        raise ValueError(f"positions {tuple(positions.shape)} must be the "
                         f"batch's (B, S) = {(b, s)}")
    positions = positions.to(device)
    return positions, positions.to(torch.int32).contiguous()


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
    x = constrain_lookup(embed(params["embed"], batch["tokens"], dtype))
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


def _run_layers_full(params, cfg, x, angles, positions, *, causal: bool,
                     want_cache: bool):
    """(x, each unit's cache entries, the summed MoE aux: fp32, zero
    without MoE layers); ``positions`` the mask's, or ``None``."""
    caches: List[Any] = []
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat_layers and not want_cache and torch.is_grad_enabled()

    def unit(x, lp):
        x, cache, a = _unit_full(cfg, lp, constrain_batch(x), angles,
                                 positions, causal)
        return constrain_batch(x), cache, a

    x = constrain_batch(x)
    for lp in params["layers"]:
        if remat:
            x, a = checkpoint(lambda x, lp: unit(x, lp)[::2], x, lp,
                              use_reentrant=False)
        else:
            x, cache, a = unit(x, lp)
            if want_cache:
                caches.append(cache)
        if a is not None:
            aux = aux + a
    return x, caches, aux


def _logits(params, cfg, x):
    x = constrain_batch(x)
    if cfg.kind == AUDIO:
        logits = lm_head(params["pred_head"], x)
    elif cfg.tie_embeddings:
        logits = lm_head_tied(params["embed"], x)
    else:
        logits = lm_head(params["lm_head"], x)
    return constrain_batch_and_last(logits)


def forward_train(params, cfg: ModelConfig, batch, *, dtype=None):
    """Full-sequence forward (bidirectional for an encoder-only config).
    Returns (logits fp32, the MoE aux summed over the layers, fp32; zero
    without MoE layers)."""
    check_supported(cfg)
    dtype = _dtype(cfg, dtype)
    b, s, device = _seq_shape(cfg, batch)
    positions, mask_pos = _positions(batch, b, s, device)
    x = _embed_input(params, cfg, batch, dtype)
    x, _, aux = _run_layers_full(params, cfg, x,
                                 _angles_for(cfg, batch, positions),
                                 mask_pos, causal=not cfg.encoder_only,
                                 want_cache=False)
    x = _apply_norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, x), aux


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def xent_loss(logits, labels, mask=None):
    """Masked token cross-entropy as ``(sum_loss, num_tokens)``: the pair,
    not the mean, is what lets the federated protocol weight clients by
    their token counts (Eq. 2)."""
    logp = F.log_softmax(logits, dim=-1)
    # the log-probability of each label: a pick, as a gather, whose
    # backward DTensor shards with the batch (a gather's backward
    # scatters into zeros of the whole global shape)
    ll = -F.nll_loss(logp.reshape(-1, logp.shape[-1]),
                     labels.reshape(-1).to(torch.int64),
                     reduction="none").reshape(labels.shape)
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
    ``loss_mask``; audio: ``targets`` under ``frame_mask``), plus
    ``router_aux_weight`` x the MoE aux for a MoE config."""
    logits, aux = forward_train(params, cfg, batch, dtype=dtype)
    s, n = xent_loss(logits, *_labels_and_mask(cfg, batch))
    loss = s / torch.clamp(n, min=1.0)
    if cfg.kind == MOE:
        loss = loss + cfg.moe.router_aux_weight * aux
    return loss


def train_loss_sum(params, cfg: ModelConfig, batch, *, dtype=None):
    """``(sum_loss, num_tokens)`` form of :func:`train_loss`: a
    ``doc_mask`` row mask (zero-padded cohort rows) multiplies into the
    token mask, so padded documents stay out of the objective and its
    gradient.  The MoE aux folds in as ``aux * n``, so ``sum / count`` is
    :func:`train_loss` of the unpadded batch, except that the aux, as the
    reference's, is computed over the padded rows too."""
    logits, aux = forward_train(params, cfg, batch, dtype=dtype)
    labels, mask = _labels_and_mask(cfg, batch)
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device) if mask is None \
        else mask.to(torch.float32)
    doc_mask = batch.get("doc_mask")
    if doc_mask is not None:
        mask = mask * doc_mask.to(torch.float32)[..., None]
    s, n = xent_loss(logits, labels, mask)
    if cfg.kind == MOE:
        s = s + cfg.moe.router_aux_weight * aux * n
    return s, n


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
    nl = num_units(cfg)
    c = _cache_len(cfg, seq_len)
    out: Dict[str, Any] = {"pos": 0}
    if cfg.use_mla:
        for key, width in (("ckv", cfg.mla_kv_lora_rank),
                           ("kr", cfg.mla_rope_head_dim)):
            out[key] = torch.zeros((nl, batch_size, c, width), dtype=dtype,
                                   device=device)
    elif cfg.kind != SSM:
        shape = (nl, batch_size, c, cfg.num_kv_heads, cfg.resolved_head_dim)
        for names in _kv_names(cfg):
            for key in names:
                out[key] = torch.zeros(shape, dtype=dtype, device=device)
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
    """Per-unit prefill outputs -> the decode cache (units stacked on a
    leading axis, as the reference's; a llama4 unit's dense and MoE layers
    under ``k, v`` and ``k2, v2``).  ``max_len`` (>= seq_len) sets the
    capacity, so decode has headroom past the prefill."""
    c = _cache_len(cfg, max_len or seq_len)
    out: Dict[str, Any] = {"pos": seq_len}
    if cfg.kind == SSM:
        out["conv"] = torch.stack([u[0][0] for u in caches])
        out["ssm"] = torch.stack([u[0][1] for u in caches])
        return out
    for i, kv in enumerate(_kv_names(cfg)):
        names = ("ckv", "kr") if cfg.use_mla else kv
        for j, key in enumerate(names):
            out[key] = torch.stack([_fit(u[i][j].to(dtype), c)
                                    for u in caches])
    if cfg.kind == HYBRID:
        out["conv"] = torch.stack([u[0][2] for u in caches])
        out["ssm"] = torch.stack([u[0][3] for u in caches])
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
    positions, mask_pos = _positions(batch, b, s, device)
    x = _embed_input(params, cfg, batch, dtype)
    x, caches, _ = _run_layers_full(params, cfg, x,
                                    _angles_for(cfg, batch, positions),
                                    mask_pos, causal=True, want_cache=True)
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = _logits(params, cfg, x)
    return logits, _cache_from_full(cfg, caches, s, dtype, max_len=max_len)


def _block_decode(cfg, lp, x, angles, cache, i: int, pos: int,
                  kv=("k", "v")):
    """One layer, one token; writes unit ``i`` of ``cache`` in place (its
    K/V under the names ``kv``)."""
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
                                   cache_k=cache[kv[0]][i],
                                   cache_v=cache[kv[1]][i], pos=pos)
    x = x + y.to(x.dtype)
    h = _apply_norm(cfg, lp["ffn_norm"], x)
    return x + _ffn(cfg, lp["ffn"], h)[0].to(x.dtype)


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
    x = constrain_lookup(embed(params["embed"], tokens, dtype))
    angles = _angles_for(cfg, batch or {}, positions)
    for i, lp in enumerate(params["layers"]):
        for sub, kv in _sub_layers(cfg, lp):
            x = _block_decode(cfg, sub, x, angles, cache, i, pos, kv)
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
    leading axis of :func:`num_units` units) -> the port's tree (a list
    of per-unit dicts).  Bitwise: every leaf is copied as float32
    without arithmetic."""
    check_supported(cfg)

    def conv(node, i=None):
        if isinstance(node, Mapping):
            return {k: conv(v, i) for k, v in node.items()}
        a = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(np.array(a if i is None else a[i])) \
            .to(device)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [conv(tree["layers"], i) for i in range(num_units(cfg))]
    return out


def _leaf_paths(node, prefix=()):
    if isinstance(node, Mapping):
        for k in sorted(node):
            yield from _leaf_paths(node[k], prefix + (k,))
    else:
        yield prefix, node


def stack_layers(params: Params) -> Dict[str, torch.Tensor]:
    """The port's tree -> one flat dict of the reference's leaves: dotted
    paths in the reference's (sorted-key) order, each per-unit leaf
    stacked on a leading axis as the reference stacks it (a llama4 unit's
    ``layers.dense_sub.*`` and ``layers.moe_sub.*``).
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
