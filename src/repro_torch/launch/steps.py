"""Step functions and meta-device input specs for every (arch, shape):
the port of the reference's ``launch/steps.py``.

``input_specs`` follows the assignment: precomputed frame/patch
embeddings stand in for the stubbed audio/vision frontends; decode
shapes describe ONE new token and a ``seq_len`` cache.  The specs are
tensors on the ``meta`` device (shapes and dtypes, no storage), the
counterpart of the reference's ``ShapeDtypeStruct``s; the dry run
(``launch/dryrun.py``) turns them into fake DTensors.
``resolve_arch_for_shape`` applies the sliding-window variant that
gates ``long_500k`` for quadratic architectures.  The step builders run
on the card or the CPU as their tensors do: the training step (loss,
gradients through the B5/B6 backward kernels on the card, optimizer
update, under one of the reference's four ``remat`` policies), and thin
prefill and decode wrappers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (AUDIO, HYBRID, SSM, VLM, ModelConfig,
                                      ShapeConfig)
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import Optimizer, tree_leaves, tree_map

LONG_CONTEXT_WINDOW = 8192   # sliding-window size for long_500k dense archs

REMAT_POLICIES = ("none", "layer", "full", "dots")


def resolve_arch_for_shape(cfg: ModelConfig, shape: ShapeConfig
                           ) -> ModelConfig:
    """Apply the sub-quadratic variant required by long_500k (if any)."""
    if shape.name == "long_500k" and cfg.kind not in (SSM, HYBRID) \
            and cfg.sliding_window == 0:
        cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    if shape.seq_len > cfg.max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=shape.seq_len)
    return cfg


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Batch specs for train/prefill; (tokens, cache) specs for decode."""
    b, s = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    if shape.mode in ("train", "prefill"):
        if cfg.kind == AUDIO:
            return {
                "frame_embeds": _spec((b, s, cfg.frontend_embed_dim), act),
                "frame_mask": _spec((b, s), torch.bool),
                "targets": _spec((b, s), torch.int32),
            }
        specs = {"tokens": _spec((b, s), torch.int32)}
        if shape.mode == "train":
            specs["labels"] = _spec((b, s), torch.int32)
            specs["loss_mask"] = _spec((b, s), torch.float32)
        if cfg.kind == VLM:
            n_patch = max(s // 16, 1)
            specs["patch_embeds"] = _spec((b, n_patch, cfg.d_model), act)
            specs["patch_positions"] = _spec((b, n_patch), torch.int32)
            specs["mrope_positions"] = _spec((3, b, s), torch.int32)
        return specs
    # decode: ONE token + a cache covering seq_len positions
    assert not cfg.encoder_only, "encoder-only archs have no decode step"
    cache = tfm.init_cache(cfg, b, s, dtype=act, device="meta")
    return {"tokens": _spec((b, 1), torch.int32), "cache": cache}


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------
# the outputs of matrix products, which the "dots" policy saves: the
# counterpart of ``jax.checkpoint_policies.checkpoint_dots``
_DOTS = frozenset(
    op for op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                  torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
                  getattr(torch.ops.aten, "_scaled_mm", None))
    if op is not None)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *, dtype=None,
                    remat: str = "none", cast_params: bool = False):
    """``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    loss)``: the mean token loss of ``batch`` (``tfm.train_loss``), its
    gradient with respect to every leaf of the fp32 master tree, and
    ``optimizer.update`` (the paper's Eq. 3 for ``sgd``).  ``params`` is
    not modified; the update returns new tensors.

    ``remat``, the reference's four activation policies:

    * ``"none"``: autograd keeps what each operation saves;
    * ``"layer"``: ``cfg.remat_layers``, each layer recomputed in the
      backward;
    * ``"full"``: the whole loss under ``torch.utils.checkpoint``
      (``jax.checkpoint(raw_loss)``): only its inputs are kept, and the
      forward runs again in the backward.  Torch recomputes a
      checkpointed region whole at its first unpack, so the peak holds
      the region's activations once more, at the start of the backward;
    * ``"dots"``: selective checkpointing of the loss that keeps the
      outputs of matrix products (``aten.mm``, ``addmm``, ``bmm``,
      ``baddbmm``, ``_scaled_mm``) and recomputes the rest, as
      ``jax.checkpoint_policies.checkpoint_dots`` does.  B5 and B6
      (``repro_torch::flash_attention``, ``repro_torch::ssd_scan``) are
      not products and are recomputed: their kernels launch again in
      the backward.  The reference's flash VJP and SSD scan are traced
      JAX, and under ``checkpoint_dots`` it keeps only the products
      inside them (per-chunk scores and ``p @ v``, the SSD chunk
      einsums), never the attention's ``out``/``lse`` or the scan's
      output and states (``jax.ad_checkpoint.print_saved_residuals``
      on reduced hymba-1.5b and phi3-mini-3.8b); a kernel's inner
      products cannot be kept, so the port recomputes the whole call.

    ``cast_params``: the loss is differentiated with respect to copies
    of the fp32 leaves cast to the activation dtype, and the gradients
    are cast back to each leaf's dtype before the update (the
    reference's mixed-precision gather)."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")
    if remat == "layer":
        cfg = dataclasses.replace(cfg, remat_layers=True)
    act_dtype = dtype or getattr(torch, cfg.dtype)

    def leaf(p):
        if cast_params and p.dtype == torch.float32:
            p = p.to(act_dtype)
        return p.detach().requires_grad_(True)

    def raw_loss(p, batch):
        return tfm.train_loss(p, cfg, batch, dtype=dtype)

    if remat == "full":
        loss_of = functools.partial(checkpoint, raw_loss,
                                    use_reentrant=False)
    elif remat == "dots":
        loss_of = functools.partial(checkpoint, raw_loss,
                                    use_reentrant=False,
                                    context_fn=_dots_contexts)
    else:
        loss_of = raw_loss

    def step(params, opt_state, batch, step_idx):
        diff = tree_map(leaf, params)
        with torch.enable_grad():
            loss = loss_of(diff, batch)
            flat = torch.autograd.grad(loss, tree_leaves(diff))
        it = iter(flat)
        grads = tree_map(lambda p: next(it).to(p.dtype), params)
        new_params, new_opt = optimizer.update(params, grads, opt_state,
                                               step_idx)
        return new_params, new_opt, loss.detach()

    return step


def make_prefill_step(cfg: ModelConfig, *, dtype=None):
    """``step(params, batch) -> (last-position logits, cache)``; an
    encoder-only config's step gives the full forward's logits."""
    if cfg.encoder_only:
        def encode(params, batch):
            with torch.no_grad():
                return tfm.forward_train(params, cfg, batch, dtype=dtype)[0]
        return encode

    def step(params, batch):
        with torch.no_grad():
            logits, cache = tfm.prefill(params, cfg, batch, dtype=dtype)
        return logits[:, -1:], cache
    return step


def make_decode_step(cfg: ModelConfig, *, dtype=None):
    """``step(params, cache, tokens) -> (logits, cache)``: one token."""
    def step(params, cache, tokens):
        with torch.no_grad():
            return tfm.decode_step(params, cfg, cache, tokens, dtype=dtype)
    return step
