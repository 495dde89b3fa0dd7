"""Eq. (2) aggregation, the server optimizers, top-k with error feedback
and local DP, over ``dict[str, Tensor]``.

Port of ``repro/core/aggregation.py``: the weighted average over a
client list and over a stacked client axis, the fedavg / fedavgm /
fedadam server rules (Reddi et al. 2021), the exact top-k selection rule
and local DP.  Server-optimizer state is kept in fp32.  The secure masks
live in ``core/transforms.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

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


# ---------------------------------------------------------------------------
# local differential privacy
# ---------------------------------------------------------------------------
def dp_privatize(grads: Mapping[str, torch.Tensor],
                 noise: Union[Mapping[str, torch.Tensor], torch.Generator],
                 *, clip_norm: float, noise_multiplier: float) -> Params:
    """Per-client clip to ``clip_norm`` + Gaussian noise (local DP).

    ``noise`` is either the standard-normal draws themselves, one tensor
    per leaf (a test hands in the reference's), or a CPU
    ``torch.Generator`` they are drawn from, leaf by leaf in dict order."""
    clipped, _ = clip_by_global_norm(grads, clip_norm)
    if noise_multiplier <= 0:
        return clipped
    if isinstance(noise, torch.Generator):
        noise = {k: torch.randn(v.shape, generator=noise).to(v.device)
                 for k, v in clipped.items()}
    scale = noise_multiplier * clip_norm
    return {k: v + scale * noise[k].to(torch.float32)
            for k, v in clipped.items()}
