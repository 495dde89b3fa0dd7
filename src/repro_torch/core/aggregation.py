"""Eq. (2) aggregation, the server optimizers, top-k with error feedback
and local DP, over ``dict[str, Tensor]``.

Port of ``repro/core/aggregation.py``: the weighted average over a
client list and over a stacked client axis, the fedavg / fedavgm /
fedadam server rules (Reddi et al. 2021), the exact top-k selection rule
and local DP, and for the mesh protocol step (``core/protocol.py``
``make_federated_train_step``) the in-graph Eq. (2) over a mesh
(:func:`aggregate_psum`) and the per-client pairwise masks
(:func:`pairwise_mask`, :func:`secure_mask_grads`).  Server-optimizer
state is kept in fp32.  The engine's secure masks (one dyadic-grid stack
a round) live in ``core/transforms.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.core import prng
from repro_torch.optim.optimizers import clip_by_global_norm

Params = Dict[str, torch.Tensor]


def aggregate_host(grads: Sequence[Mapping[str, torch.Tensor]],
                   weights: Sequence[float]) -> Params:
    """``G = sum_l n_l G_l / sum_l n_l`` over an explicit client list
    (plain PyTorch, fp32).  The engine's combine computes the same sum
    through kernel B2 (``engine.combine_arrivals``)."""
    w = [float(x) for x in weights]
    total = torch.sum(torch.tensor(w, dtype=torch.float32))
    out = {}
    for name in grads[0]:
        acc = sum(wi * g[name].to(torch.float32) for wi, g in zip(w, grads))
        out[name] = acc / total.to(acc.device)
    return out


def aggregate_psum(grads: Sequence[Mapping[str, torch.Tensor]],
                   n_samples: Sequence[torch.Tensor], mesh) -> Params:
    """Eq. (2) over a mesh: shard ``d`` holds client ``d``'s gradient
    ``grads[d]`` and sample count ``n_samples[d]`` on its device; the
    port's ``psum`` (``parallel.sharding.FedMesh.psum``) adds the
    partials ``n_d * G_d`` and ``n_d`` in shard order on the mesh's first
    device, which returns ``sum_d n_d G_d / sum_d n_d`` there."""
    n = [torch.as_tensor(x, dtype=torch.float32) for x in n_samples]
    total = mesh.psum(n)
    return {k: mesh.psum([nd.to(g[k].device) * g[k].to(torch.float32)
                          for nd, g in zip(n, grads)]) / total
            for k in grads[0]}


def aggregate_stacked(tree: Mapping[str, torch.Tensor], weights) -> Params:
    """Eq. (2) over a stacked leading client axis (plain PyTorch).

    Every leaf is ``(K, ...)`` and ``weights`` is ``(K,)``.  Zero-weight
    rows are ABSENT: ``where``-masked before the multiply, so a padded or
    free row holding non-finite values cannot poison the sum; an all-zero
    weight vector gives a zero combine (guarded denominator), never 0/0.
    """
    out = {}
    for name, leaf in tree.items():
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=leaf.device)
        total = torch.clamp(torch.sum(w), min=1e-12)
        wb = w.reshape((-1,) + (1,) * (leaf.dim() - 1))
        contrib = torch.where(wb > 0.0, leaf.to(torch.float32),
                              torch.zeros((), device=leaf.device))
        out[name] = torch.sum(wb * contrib, dim=0) / total
    return out


@dataclass(frozen=True)
class ServerOptimizer:
    """``apply(params, delta_bar, state, round_idx) -> (params, state)``;
    deltas point in the descent direction already, so every rule ADDS
    its step."""
    name: str
    init: Callable[[Mapping[str, torch.Tensor]], Any]
    apply: Callable[..., Tuple[Params, Any]]


def _zeros32(params):
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def fedavg_server(server_lr: float = 1.0) -> ServerOptimizer:
    """W <- W + eta_s * delta_bar (Eq. (3) server SGD at eta_s = 1)."""
    def init(params):
        return {}

    def apply(params, delta, state, round_idx=0):
        return {k: p + server_lr * delta[k].to(p.dtype)
                for k, p in params.items()}, state

    return ServerOptimizer("fedavg", init, apply)


def fedavgm_server(server_lr: float = 1.0,
                   momentum: float = 0.9) -> ServerOptimizer:
    """Server momentum: m <- beta m + delta_bar; W <- W + eta_s m."""
    def init(params):
        return {"m": _zeros32(params)}

    def apply(params, delta, state, round_idx=0):
        m = {k: momentum * state["m"][k] + delta[k].to(torch.float32)
             for k in params}
        return {k: p + server_lr * m[k].to(p.dtype)
                for k, p in params.items()}, {"m": m}

    return ServerOptimizer("fedavgm", init, apply)


def fedadam_server(server_lr: float = 1e-2, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-3) -> ServerOptimizer:
    """FedAdam: Adam on the server pseudo-gradient, no bias correction
    (the paper's Algorithm 2; ``eps`` = tau)."""
    def init(params):
        return {"m": _zeros32(params), "v": _zeros32(params)}

    def apply(params, delta, state, round_idx=0):
        d32 = {k: delta[k].to(torch.float32) for k in params}
        m = {k: b1 * state["m"][k] + (1 - b1) * d32[k] for k in params}
        v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(d32[k])
             for k in params}
        new = {k: p + (server_lr * m[k] / (torch.sqrt(v[k]) + eps))
               .to(p.dtype) for k, p in params.items()}
        return new, {"m": m, "v": v}

    return ServerOptimizer("fedadam", init, apply)


SERVER_OPTIMIZERS: Dict[str, Callable[..., ServerOptimizer]] = {
    "fedavg": fedavg_server,
    "fedavgm": fedavgm_server,
    "fedadam": fedadam_server,
}


def get_server_optimizer(name: str, **kw) -> ServerOptimizer:
    """Registry lookup; kwargs are forwarded to the factory."""
    if name not in SERVER_OPTIMIZERS:
        raise KeyError(f"unknown server optimizer {name!r}; "
                       f"available: {sorted(SERVER_OPTIMIZERS)}")
    return SERVER_OPTIMIZERS[name](**kw)


# ---------------------------------------------------------------------------
# top-k sparsification + error feedback
# ---------------------------------------------------------------------------
def topk_keep_mask(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask keeping EXACTLY the ``k`` largest entries of the last
    axis, ranked on the bf16 round trip of ``mag`` (round to nearest
    even), ties broken toward the LOWER index — the reference's rule bit
    for bit.  Near-ties within the bf16 grid collapse into exact ties,
    which the index rule resolves the same way on every path; kept
    values go out at full precision."""
    magq = mag.to(torch.bfloat16).to(torch.float32)
    thresh = torch.topk(magq, k, dim=-1).values[..., -1:]
    greater = magq > thresh
    n_greater = torch.sum(greater, dim=-1, keepdim=True)
    tie = magq == thresh
    tie_rank = torch.cumsum(tie.to(torch.int32), dim=-1) - 1
    return greater | (tie & (tie_rank < k - n_greater))


def topk_sparsify(tree: Mapping[str, torch.Tensor], frac: float) -> Params:
    """Keep exactly ``max(int(frac * size), 1)`` entries of each leaf, by
    magnitude (:func:`topk_keep_mask`)."""
    out = {}
    for name, leaf in tree.items():
        flat = leaf.reshape(-1)
        k = max(int(frac * flat.numel()), 1)
        mask = topk_keep_mask(torch.abs(flat), k).reshape(leaf.shape)
        out[name] = torch.where(mask, leaf, torch.zeros((), dtype=leaf.dtype,
                                                        device=leaf.device))
    return out


def compress_with_error_feedback(grads: Mapping[str, torch.Tensor],
                                 error: Optional[Mapping[str, torch.Tensor]],
                                 frac: float) -> Tuple[Params, Params]:
    """``(sent, new error memory)``; ``error`` may be None (round 0)."""
    if error is None:
        error = {k: torch.zeros_like(g, dtype=torch.float32)
                 for k, g in grads.items()}
    corrected = {k: g.to(torch.float32) + error[k] for k, g in grads.items()}
    sent = topk_sparsify(corrected, frac)
    return sent, {k: corrected[k] - sent[k] for k in corrected}


def reference_order(names: Sequence[str]) -> List[int]:
    """Indices into ``names`` (dotted leaf paths, digits a list index,
    as ``encoder.0.w``) in the reference's tree-flatten order: dict keys
    sorted, list items in order, as ``jax.tree_util`` flattens the
    reference's parameter tree.  The j-th leaf of that order draws from
    the j-th key of a ``split`` (dp noise) or ``fold_in`` (secure
    masks)."""
    def path(i):
        return tuple(int(c) if c.isdigit() else c
                     for c in names[i].split("."))
    return sorted(range(len(names)), key=path)


# ---------------------------------------------------------------------------
# secure aggregation for the mesh step (pairwise antisymmetric masks)
# ---------------------------------------------------------------------------
def pairwise_mask(tree: Mapping[str, torch.Tensor], round_key: torch.Tensor,
                  client: int, num_clients: int, scale: float = 1.0
                  ) -> Params:
    """One client's mask, the sum over all clients' masks zero.

    ``mask_l = sum_{m>l} PRG(l,m) - sum_{m<l} PRG(m,l)``: every pair puts
    ``+PRG`` on one side and ``-PRG`` on the other.  ``PRG(lo, hi)`` of
    leaf j (the j-th leaf in the reference's tree-flatten order,
    :func:`reference_order`) is ``scale * normal(fold_in(fold_in(fold_in(
    round_key, lo), hi), j))``, the reference's draws (normals within a
    few ulps), on the leaf's device."""
    names = list(tree)
    out: Params = {}
    for j, i in enumerate(reference_order(names)):
        leaf = tree[names[i]]
        total = torch.zeros(leaf.shape, dtype=torch.float32,
                            device=leaf.device)
        for other in range(num_clients):
            lo, hi = min(client, other), max(client, other)
            key = prng.fold_in(prng.fold_in(prng.fold_in(
                round_key, lo), hi), j).to(leaf.device)
            noise = scale * prng.normal(key, tuple(leaf.shape))
            sign = 1.0 if client < other else (-1.0 if client > other
                                               else 0.0)
            total = total + sign * noise
        out[names[i]] = total
    return {name: out[name] for name in names}


def secure_mask_grads(grads: Mapping[str, torch.Tensor],
                      round_key: torch.Tensor, client: int,
                      num_clients: int, n_samples, scale: float = 1.0
                      ) -> Params:
    """The cancelling mask on the Eq. (2) numerator contribution: the
    masks cancel in ``sum_l n_l G_l``, so ``G_l`` gets ``mask_l / n_l``."""
    mask = pairwise_mask(grads, round_key, client, num_clients, scale)
    out = {}
    for k, g in grads.items():
        n = torch.clamp(torch.as_tensor(n_samples, dtype=torch.float32),
                        min=1e-9).to(g.device)
        out[k] = g + mask[k] / n
    return out


# ---------------------------------------------------------------------------
# local differential privacy
# ---------------------------------------------------------------------------
def dp_privatize(grads: Mapping[str, torch.Tensor],
                 noise: Union[Mapping[str, torch.Tensor], torch.Tensor],
                 *, clip_norm: float, noise_multiplier: float) -> Params:
    """Per-client clip to ``clip_norm`` + Gaussian noise (local DP).

    ``noise`` is either the standard-normal draws themselves, one tensor
    per leaf, or the reference's threefry key (a ``(2,)`` int64 tensor):
    ``split(key, n_leaves)``, leaf j of the reference's tree-flatten
    order drawing from the j-th key on its own device."""
    clipped, _ = clip_by_global_norm(grads, clip_norm)
    if noise_multiplier <= 0:
        return clipped
    if isinstance(noise, torch.Tensor):
        names = list(clipped)
        noise = {names[i]: prng.normal(prng.fold_in(noise, j).to(
            clipped[names[i]].device), clipped[names[i]].shape)
            for j, i in enumerate(reference_order(names))}
    scale = noise_multiplier * clip_norm
    return {k: v + scale * noise[k].to(torch.float32)
            for k, v in clipped.items()}
