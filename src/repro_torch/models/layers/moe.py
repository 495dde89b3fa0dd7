"""Mixture-of-Experts block with the reference's grouped capacity
dispatch (the port of ``repro/models/layers/moe.py``).

Tokens are routed within ``G`` groups laid along the batch (16, halved
until it divides the batch): an fp32 router, a softmax, then the top
``k`` experts of each token by probability, lower expert first among
equal ones (``jax.lax.top_k``'s order, kept by a stable sort), the gates
renormalized over the ``k`` when ``k > 1``.  Each group owns
``cg = max(int(tg * k * capacity_factor / E), 1)`` slots of every
expert; slots are assigned slot by slot (every token's first choice,
then every token's second, ...), by a group-local exclusive cumsum, and
a token past its expert's capacity is dropped (gate zero).  The buffer
is expert-major, then group, then slot; dropped tokens land on a pad
row that nothing reads.  The expert products are batched products over
the ``E`` experts; the combine adds slot by slot in the activation
dtype.  The Switch load-balance aux ``E * sum_e f_e p_e`` counts routed
tokens before drops.  A shared expert runs on every token.

Every step is an out-of-place tensor op with shapes from the input's
shape alone, so the block runs under ``torch.func.vmap(grad)`` (the
batched federation path).  The groups are pinned to the data axes
(``parallel.sharding.constrain_batch``, the reference's site; the
identity off-mesh), so under a mesh the routing math is shard-local; a
batch sharded over more ways than there are groups is first gathered to
the axes the groups fill (``constrain_groups``).

:func:`record_routes` collects each call's routing (experts, the gap
between the k-th and (k+1)-th probability, the slots kept), for
holding the card's routing against the CPU's and counting drops.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models.layers.init import dense_init
from repro_torch.parallel.sharding import constrain_batch, constrain_groups

# rows after the buffer's E*G*cg that dropped tokens are sent to
_PAD_ROWS = 256

_ROUTES = contextvars.ContextVar("moe_routes", default=None)


@contextlib.contextmanager
def record_routes():
    """Yields a list that each :func:`moe_apply` call in the block
    appends one dict to: ``experts`` (B, S, k) int64, ``gap`` (B, S) the
    k-th less the (k+1)-th probability (inf with k == E), ``kept``
    (B, S, k) bool, all detached on the input's device."""
    routes: List[dict] = []
    token = _ROUTES.set(routes)
    try:
        yield routes
    finally:
        _ROUTES.reset(token)


def moe_init(key, cfg) -> dict:
    """The reference's key tree: ``split(key, 5)``, the router from the
    first, ``w_gate``, ``w_up``, ``w_down`` (E, d, f) from the next three,
    the shared expert from ``split`` of the fifth."""
    d, f = cfg.d_model, cfg.d_ff
    e = cfg.moe.num_experts
    ks = prng.split(key, 5)
    p = {
        "router": dense_init(ks[0], (d, e)),
        "w_gate": dense_init(ks[1], (e, d, f)),
        "w_up": dense_init(ks[2], (e, d, f)),
        "w_down": dense_init(ks[3], (e, f, d)),
    }
    if cfg.moe.num_shared_experts:
        sk = prng.split(ks[4], 3)
        ns = cfg.moe.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(sk[0], (d, ns * f)),
            "w_up": dense_init(sk[1], (d, ns * f)),
            "w_down": dense_init(sk[2], (ns * f, d)),
        }
    return p


def capacity(num_tokens: int, cfg) -> int:
    e = cfg.moe.num_experts
    return max(int(num_tokens * cfg.moe.top_k * cfg.moe.capacity_factor
                   / e), 1)


def _num_groups(cfg, batch: int) -> int:
    """Routing groups: ``num_groups`` halved until it divides the batch."""
    g = cfg.moe.num_groups
    while batch % g:
        g //= 2
    return max(g, 1)


def moe_apply(params, cfg, x: torch.Tensor):
    """x (B, S, D) -> (y (B, S, D), aux fp32 scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    grp = _num_groups(cfg, b)
    tg = t // grp
    cg = max(int(tg * k * cfg.moe.capacity_factor / e), 1)
    dev = x.device
    # the group dim on the data axes: groups == data shards
    xt = constrain_batch(constrain_groups(x, grp).reshape(grp, tg, d))

    logits = torch.matmul(xt.to(torch.float32),
                          params["router"].to(torch.float32))
    probs = F.softmax(logits, dim=-1)                        # (G, Tg, E)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_i = ranked[..., :k], order[..., :k]
    if k > 1:
        topk_p = topk_p / torch.sum(topk_p, dim=-1, keepdim=True)

    # slot-by-slot position assignment, group-local
    drop_row = e * grp * cg
    fill = torch.zeros((grp, e), dtype=torch.float32, device=dev)
    goff = torch.arange(grp, device=dev)[:, None] * cg       # (G, 1)
    experts = torch.arange(e, device=dev)
    dispatch_frac = torch.zeros((e,), dtype=torch.float32, device=dev)
    dests, gates, keeps = [], [], []
    for slot in range(k):
        eid = topk_i[..., slot]                              # (G, Tg)
        onehot = (eid[..., None] == experts).to(torch.float32)
        before = torch.cumsum(onehot, dim=1) - onehot
        pos = torch.gather(before, 2, eid[..., None])[..., 0] \
            + torch.gather(fill, 1, eid)
        keep = pos < cg
        dest = torch.where(keep, eid * (grp * cg) + goff + pos.to(torch.int64),
                           drop_row)
        dests.append(dest.reshape(t))
        gates.append(topk_p[..., slot] * keep)
        keeps.append(keep)
        fill = fill + torch.sum(onehot * keep[..., None], dim=1)
        dispatch_frac = dispatch_frac + torch.mean(onehot, dim=(0, 1))

    # dispatch: scatter into (E*G*cg [+ pad], D)
    flat_x = xt.reshape(t, d)
    expert_in = torch.zeros((drop_row + _PAD_ROWS, d), dtype=x.dtype,
                            device=dev)
    for dest in dests:
        expert_in = expert_in.index_add(0, dest, flat_x)
    expert_in = expert_in[:drop_row].reshape(e, grp * cg, d)

    # the experts' SwiGLU, batched over E
    g_ = torch.matmul(expert_in, params["w_gate"].to(x.dtype))
    u = torch.matmul(expert_in, params["w_up"].to(x.dtype))
    expert_out = torch.matmul(F.silu(g_) * u, params["w_down"].to(x.dtype))
    expert_out = torch.cat(
        [expert_out.reshape(drop_row, d),
         torch.zeros((_PAD_ROWS, d), dtype=x.dtype, device=dev)], dim=0)

    # combine, slot by slot in the activation dtype
    y = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for dest, gate in zip(dests, gates):
        y = y + gate.reshape(t)[:, None].to(x.dtype) * expert_out[dest]

    # Switch load-balance aux: E * sum_e f_e p_e
    p_mean = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum((dispatch_frac / k) * p_mean)

    if cfg.moe.num_shared_experts:
        sp = params["shared"]
        xf = x.reshape(t, d)
        sg = torch.matmul(xf, sp["w_gate"].to(x.dtype))
        su = torch.matmul(xf, sp["w_up"].to(x.dtype))
        y = y + torch.matmul(F.silu(sg) * su, sp["w_down"].to(x.dtype))

    routes = _ROUTES.get()
    if routes is not None:
        gap = ranked[..., k - 1] - ranked[..., k] if k < e \
            else torch.full_like(ranked[..., 0], float("inf"))
        routes.append({"experts": topk_i.reshape(b, s, k).detach(),
                       "gap": gap.reshape(b, s).detach(),
                       "kept": torch.stack(keeps, -1).reshape(b, s, k)})
    return y.reshape(b, s, d), aux.to(torch.float32)
