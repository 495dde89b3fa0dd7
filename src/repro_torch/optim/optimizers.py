"""Optimizers and schedules of the reference's ``optim/optimizers.py``,
over ``dict[str, Tensor]``.

The paper's server update (Eq. 3) is plain SGD, ``W <- W - lambda * G``:
``sgd()`` with momentum 0 is the gFedNTM-faithful optimizer.  Adam and
AdamW are the NTM reference implementations' optimizers.  Each is an
``Optimizer(init, update)`` pair, ``update(params, grads, state, step)
-> (params, state)``, with the reference's formulas and operation order
(not ``torch.optim``'s, whose Adam orders the bias corrections and
``eps`` differently): ``step`` is the round index, so Adam's bias
corrections use ``t = step + 1``.  Schedules map a step to a Python
float.  The dp transform and the round engine's relative change use
:func:`global_norm` and :func:`clip_by_global_norm`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Tuple

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (params, grads, state, step) -> (params, state)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(leaf ** 2))`` in fp32, as a 0-dim
    tensor on the leaves' device."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree.values()))


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[dict, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-12))``;
    returns ``(clipped, norm)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in tree.items()}, norm


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def constant_schedule(lr: float):
    return lambda step: float(lr)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = min(max(step / max(total_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        w = min(step / max(warmup, 1), 1.0)
        return w * cos(max(step - warmup, 0))
    return f


def _resolve(schedule_or_lr):
    if callable(schedule_or_lr):
        return schedule_or_lr
    return constant_schedule(schedule_or_lr)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def sgd(learning_rate, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """Paper Eq. (3) when momentum == 0."""
    sched = _resolve(learning_rate)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(params, grads, state, step=0):
        lr = sched(step)
        if momentum == 0.0:
            return {k: p - lr * grads[k].to(p.dtype)
                    for k, p in params.items()}, state
        mu = {k: momentum * m + grads[k].to(m.dtype)
              for k, m in state["mu"].items()}
        upd = {k: momentum * m + grads[k].to(m.dtype)
               for k, m in mu.items()} if nesterov else mu
        return {k: p - lr * upd[k] for k, p in params.items()}, {"mu": mu}

    return Optimizer(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    sched = _resolve(learning_rate)

    def init(params):
        z = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
        return {"m": z, "v": {k: torch.zeros_like(x) for k, x in z.items()}}

    def update(params, grads, state, step=0):
        lr = sched(step)
        t = step + 1
        g32 = {k: g.to(torch.float32) for k, g in grads.items()}
        m = {k: b1 * m_ + (1 - b1) * g32[k] for k, m_ in state["m"].items()}
        v = {k: b2 * v_ + (1 - b2) * torch.square(g32[k])
             for k, v_ in state["v"].items()}
        mhat_scale = 1.0 / (1 - b1 ** t)
        vhat_scale = 1.0 / (1 - b2 ** t)
        new = {k: p - lr * (m[k] * mhat_scale)
               / (torch.sqrt(v[k] * vhat_scale) + eps)
               for k, p in params.items()}
        return new, {"m": m, "v": v}

    return Optimizer(init, update)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    sched = _resolve(learning_rate)
    inner = adam(learning_rate, b1, b2, eps)

    def update(params, grads, state, step=0):
        lr = sched(step)
        new, st = inner.update(params, grads, state, step)
        return {k: n - lr * weight_decay * params[k]
                for k, n in new.items()}, st

    return Optimizer(inner.init, update)


def get_optimizer(name: str, learning_rate, **kw) -> Optimizer:
    table = {"sgd": sgd, "adam": adam, "adamw": adamw}
    if name not in table:
        raise KeyError(f"unknown optimizer {name!r}")
    return table[name](learning_rate, **kw)
