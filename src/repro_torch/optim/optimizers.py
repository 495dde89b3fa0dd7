"""Optimizers and schedules of the reference's ``optim/optimizers.py``,
over parameter trees: nested dicts, lists and tuples of tensors (the
ProdLDA ``{name: tensor}`` dicts, the LM's list of per-layer dicts).

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
from typing import Any, Callable, List, Mapping, Tuple

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (params, grads, state, step) -> (params, state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure; dict leaves matched by key), into a
    tree of ``tree``'s structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of ``tree`` in order (dicts in key order)."""
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(leaf ** 2))`` in fp32, as a 0-dim
    tensor on the leaves' device."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-12))``;
    returns ``(clipped, norm)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


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
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(params, grads, state, step=0):
        lr = sched(step)
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g.to(p.dtype), params,
                            grads), state
        mu = tree_map(lambda m, g: momentum * m + g.to(m.dtype),
                      state["mu"], grads)
        upd = tree_map(lambda m, g: momentum * m + g.to(m.dtype), mu,
                       grads) if nesterov else mu
        return tree_map(lambda p, u: p - lr * u, params, upd), {"mu": mu}

    return Optimizer(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    sched = _resolve(learning_rate)

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return {"m": z, "v": tree_map(torch.zeros_like, z)}

    def update(params, grads, state, step=0):
        lr = sched(step)
        t = step + 1
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], g32)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g),
                     state["v"], g32)
        mhat_scale = 1.0 / (1 - b1 ** t)
        vhat_scale = 1.0 / (1 - b2 ** t)
        new = tree_map(lambda p, m_, v_: p - lr * (m_ * mhat_scale)
                       / (torch.sqrt(v_ * vhat_scale) + eps), params, m, v)
        return new, {"m": m, "v": v}

    return Optimizer(init, update)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    sched = _resolve(learning_rate)
    inner = adam(learning_rate, b1, b2, eps)

    def update(params, grads, state, step=0):
        lr = sched(step)
        new, st = inner.update(params, grads, state, step)
        return tree_map(lambda n, p: n - lr * weight_decay * p, new,
                        params), st

    return Optimizer(inner.init, update)


def get_optimizer(name: str, learning_rate, **kw) -> Optimizer:
    table = {"sgd": sgd, "adam": adam, "adamw": adamw}
    if name not in table:
        raise KeyError(f"unknown optimizer {name!r}")
    return table[name](learning_rate, **kw)
