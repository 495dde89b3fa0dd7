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

Randomness.  The reference draws dp noise and secure masks from threefry
keys; the port draws them from CPU ``torch.Generator``\\ s seeded from the
round seed (``data/federated_split.py:seeded_generator``; the threefry
draws of ``core/prng.py`` do not reach them yet, ROADMAP.md A4) — dp from
``(round_seed, client, 7, _DP_SALT)``, the masks from ``(round_seed,
leaf, m, _SECURE_SALT)`` — and copies them to the device, so a card run
and a CPU run draw the same values.  Against the reference they agree in
distribution only.

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
from repro_torch.data.federated_split import seeded_generator
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import global_norm

# salts separating the dp-noise and secure-mask streams from the
# minibatch draws, which use 3-word seeds (round, client, epoch)
_DP_SALT = 0xD9
_SECURE_SALT = 0x5EC


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

    @property
    def segments(self) -> List[Tuple[int, int]]:
        return [(off, n) for _, _, off, n in self.layout]


@dataclass(frozen=True)
class MessageTransform:
    """One named transform over the stacked slab: ``stacked(msgs, ctx,
    state) -> (msgs, state)``; ``init_state(layout, num_clients, device)``
    builds its device state or None."""
    name: str
    _stacked: Callable[..., Tuple[torch.Tensor, Any]]
    _init_state: Optional[Callable[..., Any]] = None

    def stacked(self, msgs: torch.Tensor, ctx: StackedTransformCtx,
                state) -> Tuple[torch.Tensor, Any]:
        return self._stacked(msgs, ctx, state)

    def init_state(self, layout, num_clients: int, device):
        if self._init_state is None:
            return None
        return self._init_state(layout, num_clients, device)


# ---------------------------------------------------------------------------
# dp: per-client clip + Gaussian noise
# ---------------------------------------------------------------------------
def dp_noise(round_seed: int, client_ids, valid, d: int) -> torch.Tensor:
    """Standard-normal ``(K, D)`` noise on the CPU, row ``i`` from
    ``(round_seed, client_ids[i], 7, _DP_SALT)``; padded rows stay 0."""
    out = torch.zeros((len(client_ids), d), dtype=torch.float32)
    for i, (cid, ok) in enumerate(zip(client_ids, valid)):
        if ok:
            out[i] = torch.randn(d, generator=seeded_generator(
                round_seed, int(cid), 7, _DP_SALT))
    return out


def dp_apply(msgs: torch.Tensor, layout, noise: torch.Tensor, *,
             clip: float, mult: float) -> torch.Tensor:
    """``msgs * coef + (mult * clip) * noise`` with the per-row clip
    coefficient ``min(1, clip / max(global_norm(row), 1e-12))`` (the
    reference's ``clip_by_global_norm`` scale over the row's leaves),
    through kernel B3 on a CUDA slab."""
    views = {name: msgs[:, off:off + n] for name, _, off, n in layout}
    norms = torch.func.vmap(global_norm)(views)
    coef = torch.clamp(clip / torch.clamp(norms, min=1e-12), max=1.0)
    return ops.fed_dp_secure_apply(msgs, noise=noise.to(msgs.device),
                                   clip_coef=coef, noise_scale=mult * clip)


def _dp_transform(fed: FederatedConfig) -> MessageTransform:
    if fed.dp_noise_multiplier <= 0:
        raise ValueError("the 'dp' transform needs "
                         "FederatedConfig.dp_noise_multiplier > 0 — with "
                         "zero noise it would silently degrade to "
                         "clip-only while claiming local DP")
    clip, mult = fed.dp_clip_norm, fed.dp_noise_multiplier

    def stacked(msgs, ctx: StackedTransformCtx, state):
        noise = dp_noise(ctx.round_seed, ctx.client_ids, ctx.valid,
                         msgs.shape[1])
        return dp_apply(msgs, ctx.layout, noise, clip=clip,
                        mult=mult), state

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
        n = state.shape[0]
        ids = np.clip(ctx.client_ids, 0, n - 1)
        sent, new_err = ops.fed_topk_ef(
            msgs, state, torch.as_tensor(ids, dtype=torch.int32),
            frac=frac, segments=ctx.segments)
        rows = np.flatnonzero(ctx.valid)
        if len(rows):
            state[torch.as_tensor(ctx.client_ids[rows], device=state.device)] \
                = new_err[torch.as_tensor(rows, device=new_err.device)]
        return sent, state

    def init_state(layout, num_clients, device):
        d = sum(n for _, _, _, n in layout)
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


def pairwise_mask_stack(round_seed: int, segments: Sequence[Tuple[int, int]],
                        num_clients: int, scale: float = 1.0
                        ) -> torch.Tensor:
    """All K clients' pairwise-cancelling masks, ``(K, D)`` fp32 on the CPU.

    Per leaf segment there is an antisymmetric pair tensor ``U - U^T``
    (``U`` integers in ``[-2^b, 2^b]``) and client l's mask is its row
    sum; a loop over m draws ``U``'s m-th row at a time (every l takes
    ``-U[m, l]``, client m its row sum), so memory stays O(K * D).  Row
    m of leaf i is drawn from ``(round_seed, i, m, _SECURE_SALT)``.  The
    accumulation is int32 (exact: partial sums stay below 2^23 grid
    units) and the final ``int * 2^-b`` conversion is exact, so
    ``sum_l mask_l`` is bitwise +0.0 per column in any order."""
    bits = _mask_grid_bits(num_clients)
    unit = 2.0 ** (math.floor(math.log2(scale)) - bits)
    d = sum(n for _, n in segments)
    acc = torch.zeros((num_clients, d), dtype=torch.int32)
    for i, (off, n) in enumerate(segments):
        for m in range(num_clients):
            row = torch.randint(-(2 ** bits), 2 ** bits + 1,
                                (num_clients, n), dtype=torch.int32,
                                generator=seeded_generator(
                                    round_seed, i, m, _SECURE_SALT))
            acc[:, off:off + n] -= row
            acc[m, off:off + n] += row.sum(dim=0, dtype=torch.int32)
    return acc.to(torch.float32) * unit


def _secure_transform(fed: FederatedConfig) -> MessageTransform:
    def stacked(msgs, ctx: StackedTransformCtx, state):
        stack = pairwise_mask_stack(ctx.round_seed, ctx.segments,
                                    ctx.num_clients)
        rows = stack[torch.as_tensor(ctx.client_ids, dtype=torch.int64)]
        # masks cancel in the Eq. (2) NUMERATOR: each row adds mask / n
        return ops.fed_dp_secure_apply(msgs, masks=rows.to(msgs.device),
                                       weights=ctx.weights), state

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
