"""Message transforms, one round's ``(n, D)`` message slab at a time.

Port of ``repro/core/transforms.py``: every registered transform
(``dp``, ``topk``, ``secure``, ``precision``) maps a message slab — one
flat row per message, columns laid out by ``engine.flat_layout`` — to a
new slab, with the reference's math.  The kernels each take the whole
slab in one call: B3 (``ops.fed_dp_secure_apply``) for ``dp`` and
``secure``, B4 (``ops.fed_topk_ef``) for ``topk``.

Both halves of the reference run through the one slab form:

* the batched cohort path (``exec_mode="vmap"``) hands the round's
  fixed-K ``(K, D)`` stacked slab, padded rows marked invalid;
* the host loop (``exec_mode="loop"``, Algorithm 1) hands the ``(n, D)``
  slab of the n messages its cohort made, in cohort order, all valid,
  weighted by their Eq. (2) weights — one B3 or B4 call a round, not n;
  the buffered-async service hands one upload as a ``(1, D)`` slab
  (``FederationEngine.transform_messages``).

The reference applies each loop-mode transform to one client's message
at a time (its ``TransformCtx`` at ``repro/core/transforms.py:73-81``).
Every transform here is row-independent — ``dp`` clips each row by its
own norm and draws its noise from its own client id, ``topk`` reads and
writes only the error-memory row of its own client, ``secure`` adds the
row of a mask stack drawn once a round, ``precision`` is pointwise — so
the slab form gives each message the value the per-client form gives it.

Randomness.  dp noise and secure masks come from the reference's
threefry keys (``core/prng.py``), drawn on the slab's device: dp noise
row i from ``fold_in(fold_in(PRNGKey(round_seed), client), 7)``, split
into one key per leaf, a ``normal`` per leaf (the reference's values up
to the few-ulp rounding of ``erfinv``); the masks' row m of leaf j from
``fold_in(fold_in(fold_in(PRNGKey(round_seed), _SECURE_SALT), j), m)``
and ``randint`` (bitwise the reference's).  Leaf j is the j-th leaf in
the reference's tree-flatten order (``aggregation.reference_order``:
dict keys sorted, list items in order), wherever the leaf's columns lie in
the slab.  Every draw is a pure function of ``(round_seed, client)``.

Padded zero-weight rows (fixed-K cohorts) flow through every transform:
``ctx.valid`` marks the real rows, the ``topk`` memory is never written
from a padded row, and the engine re-zeroes invalid rows after the stage.

Exact secure-mask cancellation.  Client l adds ``mask_l / n_l`` to its
message, and ``sum_l mask_l`` is bitwise +0.0 under any summation order:
the pairwise noise is integers in ``[-2^b, 2^b]`` times a power-of-two
unit, accumulated in int32, with ``b`` small enough that every partial
sum of the K^2 antisymmetric terms stays below 2^24 units, where float32
integer arithmetic is exact (the reference's dyadic-grid argument,
``repro/core/transforms.py`` module docstring).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import global_norm

# fold-in salt separating the secure-mask stream from the minibatch
# draws and the model noise, which also derive from the round key
_SECURE_SALT = 0x5EC
# int64 elements one mask hash may hold (its temporaries stay ~100 MiB)
_MASK_CHUNK = 1 << 24



@dataclass
class StackedTransformCtx:
    """Context of one transform-stage call over an ``(n, D)`` slab.

    ``client_ids`` / ``valid`` are ``(n,)`` host arrays over the slab's
    rows (on the batched path's fixed-K axis padded rows have id 0 and
    are not valid); ``weights`` the ``(n,)`` fp32 Eq. (2) weights on the
    messages' device; ``layout`` the ``(name, shape, offset, numel)``
    columns of the slab."""
    round_seed: int
    client_ids: np.ndarray
    valid: np.ndarray
    weights: torch.Tensor
    num_clients: int        # mask population
    layout: Sequence[Tuple[str, Any, int, int]]
    # the engine's ``parallel.sharding.FedMesh``, or None.  With a mesh
    # the slab (and the ``topk`` state) is a list of row shards, each
    # transform runs per shard on the shard's device and hands the mesh
    # to its kernel's wrapper; ``weights`` stays the whole (n,) vector
    mesh: Any = None

    def shard_rows(self, x: np.ndarray) -> List[np.ndarray]:
        """A host ``(n,)`` vector over the slab's rows, one block a shard
        (the whole vector, unsharded)."""
        return [x] if self.mesh is None else self.mesh.split(x)

    @property
    def segments(self) -> List[Tuple[int, int]]:
        return [(off, n) for _, _, off, n in self.layout]


@dataclass(frozen=True)
class MessageTransform:
    """One named transform over the stacked slab: ``stacked(msgs, ctx,
    state) -> (msgs, state)``; ``init_state(layout, num_clients, device,
    mesh)`` builds its device state (row-sharded over a mesh) or None."""
    name: str
    _stacked: Callable[..., Tuple[torch.Tensor, Any]]
    _init_state: Optional[Callable[..., Any]] = None

    def stacked(self, msgs: torch.Tensor, ctx: StackedTransformCtx,
                state) -> Tuple[torch.Tensor, Any]:
        return self._stacked(msgs, ctx, state)

    def init_state(self, layout, num_clients: int, device, mesh=None):
        if self._init_state is None:
            return None
        return self._init_state(layout, num_clients, device, mesh)


# ---------------------------------------------------------------------------
# dp: per-client clip + Gaussian noise
# ---------------------------------------------------------------------------
def dp_noise(round_seed: int, client_ids, valid, layout, device
             ) -> torch.Tensor:
    """Standard-normal ``(K, D)`` noise on ``device``: row i is client
    ``client_ids[i]``'s, from the reference's ``fold_in(fold_in(
    PRNGKey(round_seed), client), 7)`` split into one key per leaf
    (``aggregation.reference_order``), one ``normal`` per leaf for all rows
    at once; padded rows are 0."""
    root = prng.PRNGKey(round_seed)
    client_keys = [prng.fold_in(prng.fold_in(root, int(c)), 7)
                   for c in client_ids]
    d = layout[-1][2] + layout[-1][3] if layout else 0
    out = torch.empty((len(client_ids), d), dtype=torch.float32,
                      device=device)
    names = [name for name, _, _, _ in layout]
    for j, i in enumerate(agg.reference_order(names)):
        _, shape, off, n = layout[i]
        # split(key, n_leaves)[j] is fold_in(key, j): both hash (0, j)
        keys = torch.stack([prng.fold_in(k, j) for k in client_keys]) \
            .to(device)
        out[:, off:off + n] = prng.normal(keys, tuple(shape)) \
            .reshape(len(client_ids), n)
    keep = torch.as_tensor(np.asarray(valid, bool), device=device)
    return torch.where(keep[:, None], out, torch.zeros((), device=device))


def dp_apply(msgs: torch.Tensor, layout, noise: torch.Tensor, *,
             clip: float, mult: float) -> torch.Tensor:
    """``msgs * coef + (mult * clip) * noise`` with the per-row clip
    coefficient ``min(1, clip / max(global_norm(row), 1e-12))`` (the
    reference's ``clip_by_global_norm`` scale over the row's leaves),
    through kernel B3 on a CUDA slab."""
    return ops.fed_dp_secure_apply(msgs, noise=noise,
                                   clip_coef=dp_clip_coef(msgs, layout, clip),
                                   noise_scale=mult * clip)


def dp_clip_coef(msgs: torch.Tensor, layout, clip: float) -> torch.Tensor:
    """Per-row ``min(1, clip / max(global_norm(row), 1e-12))``."""
    views = {name: msgs[:, off:off + n] for name, _, off, n in layout}
    norms = torch.func.vmap(global_norm)(views)
    return torch.clamp(clip / torch.clamp(norms, min=1e-12), max=1.0)


def _dp_transform(fed: FederatedConfig) -> MessageTransform:
    if fed.dp_noise_multiplier <= 0:
        raise ValueError("the 'dp' transform needs "
                         "FederatedConfig.dp_noise_multiplier > 0 — with "
                         "zero noise it would silently degrade to "
                         "clip-only while claiming local DP")
    clip, mult = fed.dp_clip_norm, fed.dp_noise_multiplier

    def stacked(msgs, ctx: StackedTransformCtx, state):
        if ctx.mesh is None:
            noise = dp_noise(ctx.round_seed, ctx.client_ids, ctx.valid,
                             ctx.layout, msgs.device)
            return dp_apply(msgs, ctx.layout, noise, clip=clip,
                            mult=mult), state
        # per row: each shard draws its rows' noise on its own device
        noise = [dp_noise(ctx.round_seed, ids, ok, ctx.layout, m.device)
                 for m, ids, ok in zip(msgs, ctx.shard_rows(ctx.client_ids),
                                       ctx.shard_rows(ctx.valid))]
        coef = [dp_clip_coef(m, ctx.layout, clip) for m in msgs]
        return ops.fed_dp_secure_apply(msgs, noise=noise, clip_coef=coef,
                                       noise_scale=mult * clip,
                                       mesh=ctx.mesh), state

    return MessageTransform("dp", stacked)


# ---------------------------------------------------------------------------
# topk: magnitude sparsification + per-client error feedback
# ---------------------------------------------------------------------------
def _topk_transform(fed: FederatedConfig) -> MessageTransform:
    if fed.compression_topk <= 0:
        raise ValueError("the 'topk' transform needs "
                         "FederatedConfig.compression_topk > 0")
    frac = fed.compression_topk

    def stacked(msgs, ctx: StackedTransformCtx, state):
        # state: the (L, D) error memory, one row per GLOBAL client id,
        # updated in place; the row count comes from the state itself
        # (with a mesh: a list of row shards; rows move by global id)
        mesh = ctx.mesh
        n = state.shape[0] if mesh is None else \
            sum(s.shape[0] for s in state)
        ids = np.clip(ctx.client_ids, 0, n - 1)
        sent, new_err = ops.fed_topk_ef(
            msgs, state, torch.as_tensor(ids, dtype=torch.int32),
            frac=frac, segments=ctx.segments, mesh=mesh)
        rows = np.flatnonzero(ctx.valid)
        if len(rows) and mesh is not None:
            mesh.scatter_rows(state, ctx.client_ids[rows], new_err, rows)
        elif len(rows):
            state[torch.as_tensor(ctx.client_ids[rows], device=state.device)] \
                = new_err[torch.as_tensor(rows, device=new_err.device)]
        return sent, state

    def init_state(layout, num_clients, device, mesh=None):
        d = sum(n for _, _, _, n in layout)
        if mesh is not None:
            return mesh.zeros(num_clients, d)
        return torch.zeros((num_clients, d), dtype=torch.float32,
                           device=device)

    return MessageTransform("topk", stacked, init_state)


# ---------------------------------------------------------------------------
# secure: pairwise masks on a dyadic grid (bitwise-exact cancellation)
# ---------------------------------------------------------------------------
def _mask_grid_bits(num_clients: int) -> int:
    """Noise resolution (bits) keeping EVERY partial sum exact in float32:
    ``b = 22 - 2*ceil(log2 K)``, capped at 10, floored at 1, so that
    ``K^2 * 2^(b+1) <= 2^23`` for every K up to 1024."""
    if num_clients > 1024:
        raise ValueError(
            f"secure masks support at most 1024 clients (got "
            f"{num_clients}): beyond that the dyadic noise grid that "
            "makes cancellation bitwise-exact runs out of float32 "
            "mantissa")
    b = min(10, 22 - 2 * math.ceil(math.log2(max(num_clients, 2))))
    return max(b, 1)


def pairwise_mask_stack(round_seed: int, layout, num_clients: int,
                        device, scale: float = 1.0) -> torch.Tensor:
    """All K clients' pairwise-cancelling masks, ``(K, D)`` fp32 on
    ``device``, bitwise the reference's.

    Per leaf there is an antisymmetric pair tensor ``U - U^T`` (``U``
    integers in ``[-2^b, 2^b]``) and client l's mask is its row sum: row
    m of ``U`` takes ``-U[m, l]`` into every l and its own sum into m, so
    ``mask_l = sum_m U[l, m] - sum_m U[m, l]``.  ``U[m]`` of the
    reference's leaf j is ``randint(fold_in(fold_in(fold_in(
    PRNGKey(round_seed), _SECURE_SALT), j), m), (K,) + leaf.shape)``;
    a chunk of rows is drawn in one hash.  The sums run in int32 (exact:
    partial sums stay below 2^23 grid units) and the final ``int *
    2^-b`` conversion is exact, so ``sum_l mask_l`` is bitwise +0.0 per
    column in any order."""
    bits = _mask_grid_bits(num_clients)
    unit = 2.0 ** (math.floor(math.log2(scale)) - bits)
    k = num_clients
    d = layout[-1][2] + layout[-1][3] if layout else 0
    acc = torch.zeros((k, d), dtype=torch.int32, device=device)
    base = prng.fold_in(prng.PRNGKey(round_seed), _SECURE_SALT)
    names = [name for name, _, _, _ in layout]
    for j, i in enumerate(agg.reference_order(names)):
        _, _, off, n = layout[i]
        leaf_key = prng.fold_in(base, j)
        chunk = max(1, _MASK_CHUNK // max(k * n, 1))
        for m0 in range(0, k, chunk):
            ms = range(m0, min(k, m0 + chunk))
            keys = torch.stack([prng.fold_in(leaf_key, m) for m in ms]) \
                .to(device)
            rows = prng.randint(keys, (k, n), -(2 ** bits), 2 ** bits + 1)
            acc[:, off:off + n] -= rows.sum(dim=0, dtype=torch.int32)
            acc[m0:m0 + len(ms), off:off + n] += rows.sum(
                dim=1, dtype=torch.int32)
    return acc.to(torch.float32) * unit


def _secure_transform(fed: FederatedConfig) -> MessageTransform:
    def stacked(msgs, ctx: StackedTransformCtx, state):
        if ctx.mesh is None:
            stack = pairwise_mask_stack(ctx.round_seed, ctx.layout,
                                        ctx.num_clients, msgs.device)
            rows = stack[torch.as_tensor(ctx.client_ids, dtype=torch.int64,
                                         device=msgs.device)]
        else:
            # the stack is drawn once, replicated on the mesh's first
            # device; each shard takes its rows' masks to its own device
            stack = pairwise_mask_stack(ctx.round_seed, ctx.layout,
                                        ctx.num_clients, ctx.mesh.first)
            rows = [stack[torch.as_tensor(ids, dtype=torch.int64,
                                          device=stack.device)].to(m.device)
                    for m, ids in zip(msgs, ctx.shard_rows(ctx.client_ids))]
        # masks cancel in the Eq. (2) NUMERATOR: each row adds mask / n
        return ops.fed_dp_secure_apply(msgs, masks=rows, weights=ctx.weights,
                                       mesh=ctx.mesh), state

    return MessageTransform("secure", stacked)


# ---------------------------------------------------------------------------
# precision: bf16 on the wire, fp32 accumulation
# ---------------------------------------------------------------------------
def _precision_transform(fed: FederatedConfig) -> MessageTransform:
    """Round every message to bfloat16 (what a client would send) and
    widen it back, so everything downstream accumulates in fp32.
    ``secure`` x ``precision`` is refused (bf16 rounding would break the
    bitwise mask cancellation)."""
    if fed.message_precision != "bf16":
        raise ValueError(
            "the 'precision' transform needs "
            "FederatedConfig.message_precision == 'bf16' (the only wire "
            f"format implemented); got {fed.message_precision!r} — set "
            "TransformsSpec.precision, don't enable the transform bare")

    def stacked(msgs, ctx: StackedTransformCtx, state):
        return msgs.to(torch.bfloat16).to(torch.float32), state

    return MessageTransform("precision", stacked)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
TRANSFORMS: Dict[str, Callable[[FederatedConfig], MessageTransform]] = {
    "dp": _dp_transform,
    "topk": _topk_transform,
    "secure": _secure_transform,
    "precision": _precision_transform,
}


def build_transforms(names: Sequence[str], fed: FederatedConfig
                     ) -> List[Tuple[str, MessageTransform]]:
    """Resolve transform names against the registry, order preserved."""
    out = []
    for name in names:
        if name not in TRANSFORMS:
            raise KeyError(f"unknown transform {name!r}; "
                           f"available: {sorted(TRANSFORMS)}")
        out.append((name, TRANSFORMS[name](fed)))
    return out
