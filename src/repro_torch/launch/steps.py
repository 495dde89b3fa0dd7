"""Step builders of the reference's ``launch/steps.py`` for the port's LM
families: the training step (loss, gradients through the B5/B6 backward
kernels on the card, optimizer update), and thin prefill and decode
wrappers.  The reference's ``input_specs`` and ``resolve_arch_for_shape``
(ShapeDtypeStruct lowering helpers) join with ROADMAP.md A17.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import Optimizer, tree_leaves, tree_map


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *, dtype=None,
                    remat: str = "none", cast_params: bool = False):
    """``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    loss)``: the mean token loss of ``batch`` (``tfm.train_loss``), its
    gradient with respect to every leaf of the fp32 master tree, and
    ``optimizer.update`` (the paper's Eq. 3 for ``sgd``).  ``params`` is
    not modified; the update returns new tensors.

    ``remat``: ``"none"`` or ``"layer"`` (``cfg.remat_layers``: each layer
    recomputed in the backward); the reference's ``"full"`` and
    ``"dots"`` policies are not in the port.  ``cast_params``: the loss
    is differentiated with respect to copies of the fp32 leaves cast to
    the activation dtype, and the gradients are cast back to each
    leaf's dtype before the update (the reference's mixed-precision
    gather)."""
    if remat in ("full", "dots"):
        raise NotImplementedError(
            f"remat={remat!r} is not in the port yet (ROADMAP.md A16b): "
            f"use 'layer' (cfg.remat_layers) or 'none'")
    if remat == "layer":
        cfg = dataclasses.replace(cfg, remat_layers=True)
    elif remat != "none":
        raise ValueError(f"unknown remat policy {remat!r}")
    act_dtype = dtype or getattr(torch, cfg.dtype)

    def leaf(p):
        if cast_params and p.dtype == torch.float32:
            p = p.to(act_dtype)
        return p.detach().requires_grad_(True)

    def step(params, opt_state, batch, step_idx):
        diff = tree_map(leaf, params)
        with torch.enable_grad():
            loss = tfm.train_loss(diff, cfg, batch, dtype=dtype)
            flat = torch.autograd.grad(loss, tree_leaves(diff))
        it = iter(flat)
        grads = tree_map(lambda p: next(it).to(p.dtype), params)
        new_params, new_opt = optimizer.update(params, grads, opt_state,
                                               step_idx)
        return new_params, new_opt, loss.detach()

    return step


def make_prefill_step(cfg: ModelConfig, *, dtype=None):
    """``step(params, batch) -> (last-position logits, cache)``."""
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
