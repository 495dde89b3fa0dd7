"""`FederationEngine` — sampler -> local update -> transforms -> combine ->
server optimizer.

Port of ``repro/core/engine.py``.  A client's round message is either a
``"delta"`` (E local SGD epochs, ``W_l - W``, handed to the
``RoundConfig`` server optimizer) or a ``"grad"`` (one minibatch
gradient, E = 1, handed to a wrapped client ``Optimizer``: Algorithm 1's
information flow, ``core/protocol.py:FederatedTrainer``).  Two execution
paths:

* the host loop (``exec_mode="loop"``), the literal Algorithm 1: the
  cohort's clients step one after another; with a transform stage the
  round's n messages then become the rows of one ``(n, D)`` slab of its
  own storage, which goes through the stage once (one B3 or B4 call a
  round, :meth:`FederationEngine.transform_messages`), so a straggler
  carries its transformed message, as in the reference, where a message
  is transformed when it is made.  Stragglers wait in the host pending
  list (:class:`PendingUpdate`, newest message wins, each a copy of its
  row), and each round's arrivals go through :func:`combine_arrivals` —
  every arrival one row of a reused flat ``(n, D)`` fp32 slab, scaled by
  ``decay ** age``, combined by kernel B2 in one call.  Losses stay on
  the device and are read once a round;
* the batched cohort path (``exec_mode="vmap"``), one synchronous round
  at a time: the ``RoundScheduler`` cohort, its stacked ``(K, E, P, V)``
  minibatches with ``doc_mask``, all K clients' updates in one
  ``torch.func.vmap(grad)`` over ``functional_call``, the stacked
  transform stage (``core/transforms.py``) on ONE flat ``(K, D)`` message
  slab, padded rows re-zeroed, the Eq. (2) combine through kernel B2 and
  the server-optimizer step, gated on any positive weight.  Each kernel
  is one call per round: B2 for the combine, B3 for ``dp`` or
  ``secure``, B4 for ``topk``.

The buffered-async service runs one client's loop-mode local update per
upload (``_local_message``) and the transform stage on it as a ``(1, D)``
slab.  Not ported yet, raising ``NotImplementedError`` naming its ROADMAP
item: the fused straggler ring of the batched path (A10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FederatedConfig, RoundConfig
from repro_torch.core import aggregation as agg
from repro_torch.core.transforms import StackedTransformCtx, \
    build_transforms
from repro_torch.data.federated_split import (draw_generator,
                                              round_minibatches,
                                              sample_minibatch,
                                              stacked_round_batches)
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import global_norm

Params = Dict[str, torch.Tensor]

EXEC_MODES = ("loop", "vmap")
KERNEL_BACKENDS = ("xla", "pallas")
SAMPLING_MODES = ("uniform", "weighted", "deterministic")
MESSAGE_KINDS = ("delta", "grad")


@dataclass
class ClientState:
    """What lives on one node N_l: its corpus (on the device), never
    shared."""
    data: Dict[str, torch.Tensor]
    num_docs: int


def param_delta(old: Mapping[str, torch.Tensor],
                new: Mapping[str, torch.Tensor]) -> Params:
    """The client's round message in delta form: W_l - W."""
    return {k: new[k] - old[k] for k in old}


def client_round_update(grad_fn, params: Mapping[str, torch.Tensor],
                        client: ClientState, round_seed: int, client_id: int,
                        *, learning_rate: float, local_epochs: int = 1,
                        batch_size: int = 64
                        ) -> Tuple[Params, float, torch.Tensor]:
    """Run E local SGD epochs on one client from the server weights;
    return ``(delta, n_total, mean_loss)``.  ``grad_fn(params, batch) ->
    (grads, loss)``; the loss stays a 0-dim tensor (no host sync)."""
    local = dict(params)
    tot_loss, tot_n = 0.0, 0.0
    for batch, n in round_minibatches(client.data, client.num_docs,
                                      round_seed, client_id,
                                      batch_size=batch_size,
                                      local_epochs=local_epochs):
        grads, loss = grad_fn(local, batch)
        local = {k: p - learning_rate * grads[k].to(p.dtype)
                 for k, p in local.items()}
        tot_loss = tot_loss + loss.detach() * n
        tot_n += n
    return param_delta(params, local), float(tot_n), \
        tot_loss / max(tot_n, 1.0)


def flat_layout(params: Mapping[str, torch.Tensor]
                ) -> List[Tuple[str, torch.Size, int, int]]:
    """``(name, shape, offset, numel)`` of each leaf in one flat vector,
    in the dict's order."""
    out, off = [], 0
    for name, p in params.items():
        out.append((name, p.shape, off, p.numel()))
        off += p.numel()
    return out


def init_delta_buffer(params: Mapping[str, torch.Tensor], capacity: int, *,
                      int_fields: Optional[Mapping[str, int]] = None
                      ) -> Dict[str, object]:
    """The fixed-capacity delta-slot layout, flat.

    ``delta`` is ONE ``(capacity, D)`` fp32 tensor on the params' device
    (``D`` = all parameters, leaves laid out by :func:`flat_layout`), so
    a combine over the slots is one kernel launch; ``weight`` (the Eq. (2)
    sample count, 0 = free slot), ``client`` (-1 = free) and the
    ``int_fields`` are per-slot host arrays."""
    c = int(capacity)
    if c < 1:
        raise ValueError(f"delta buffer capacity must be >= 1, got "
                         f"{capacity!r}")
    first = next(iter(params.values()))
    d = sum(p.numel() for p in params.values())
    buf: Dict[str, object] = {
        "delta": torch.zeros((c, d), dtype=torch.float32,
                             device=first.device),
        "weight": np.zeros((c,), np.float32),
        "client": np.full((c,), -1, np.int32),
    }
    for name, fill in (int_fields or {}).items():
        buf[name] = np.full((c,), int(fill), np.int32)
    return buf


def masked_mean_loss(loss_fn, loss_sum_fn=None):
    """Client objective of the stacked path: with a mask-aware
    ``loss_sum_fn(params, batch) -> (sum, count)`` (``prodlda.
    elbo_loss_sum``) padded rows stay out of the objective and its
    gradient, and ``sum / max(count, 1)`` equals the plain mean over the
    unpadded batch; without one, the plain mean with the mask stripped
    (valid only when no client pads, which the engine checks)."""
    if loss_sum_fn is not None:
        def mean_loss(params, batch):
            s, n = loss_sum_fn(params, batch)
            return s / torch.clamp(n, min=1.0)
        return mean_loss

    def mean_loss(params, batch):
        return loss_fn(params, {k: v for k, v in batch.items()
                                if k != "doc_mask"})
    return mean_loss


def _check_vmap_preconditions(clients, batch_size: int, loss_sum_fn, *,
                              what: str) -> None:
    if loss_sum_fn is None and any(c.num_docs < batch_size for c in clients):
        raise ValueError(
            f"{what} exec_mode='vmap' with ragged clients (num_docs < "
            f"batch_size={batch_size}) needs a mask-aware loss_sum_fn "
            "(e.g. prodlda.elbo_loss_sum) so padded rows stay out of the "
            "objective; pass loss_sum_fn= or use exec_mode='loop'")


def _rel_change(old: Mapping[str, torch.Tensor],
                new: Mapping[str, torch.Tensor]) -> torch.Tensor:
    num = global_norm({k: old[k] - new[k] for k in old})
    return num / torch.clamp(global_norm(old), min=1e-12)


def _cycle_per_client(values: Optional[Sequence[int]], num_clients: int,
                      default: int) -> np.ndarray:
    """Per-client int schedule: cycle a (possibly shorter) tuple over L."""
    if not values:
        return np.full(num_clients, default, np.int64)
    v = np.asarray(values, np.int64)
    return v[np.arange(num_clients) % len(v)]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item}); "
        "run it on the JAX reference package")


class RoundScheduler:
    """Samples the K-of-L client cohort for each round (numpy only, so the
    cohorts are the reference's bit for bit).

    Modes: ``uniform`` (K without replacement), ``weighted`` (probability
    proportional to corpus size), ``deterministic`` (a fixed seeded
    permutation walked K at a time).  Client l is active at round r iff
    ``join[l] <= r < leave[l]`` (0 in leave = never leaves); every mode
    samples among the active set.  Cohorts are deterministic functions of
    ``(seed, round_idx)``.
    """

    MODES = SAMPLING_MODES

    def __init__(self, num_clients: int, clients_per_round: int = 0, *,
                 mode: str = "uniform",
                 weights: Optional[Sequence[float]] = None, seed: int = 0,
                 join_rounds: Optional[Sequence[int]] = None,
                 leave_rounds: Optional[Sequence[int]] = None):
        if mode not in self.MODES:
            raise ValueError(f"unknown sampling mode {mode!r}; "
                             f"one of {self.MODES}")
        self.num_clients = num_clients
        k = clients_per_round or num_clients
        self.clients_per_round = min(k, num_clients)
        self.mode = mode
        self.seed = seed
        if mode == "weighted":
            if weights is None:
                raise ValueError("weighted sampling needs per-client weights")
            w = np.asarray(weights, np.float64)
            self.probs = w / w.sum()
        else:
            self.probs = None
        self.join = _cycle_per_client(join_rounds, num_clients, 0)
        leave = _cycle_per_client(leave_rounds, num_clients, 0)
        self.leave = np.where(leave <= 0, np.iinfo(np.int64).max, leave)
        self._has_availability = bool(
            (self.join > 0).any()
            or (self.leave < np.iinfo(np.int64).max).any())
        self._perm = np.random.default_rng(seed).permutation(num_clients)

    def active(self, round_idx: int) -> np.ndarray:
        """Client ids present in the federation at round ``round_idx``."""
        return np.where((self.join <= round_idx)
                        & (round_idx < self.leave))[0]

    def select(self, round_idx: int) -> np.ndarray:
        """Sorted client ids of the round-``round_idx`` cohort."""
        act = self.active(round_idx) if self._has_availability \
            else np.arange(self.num_clients)
        a, k = len(act), min(self.clients_per_round, len(act))
        if k >= a:
            return act.copy()
        if self.mode == "deterministic":
            walk = self._perm[np.isin(self._perm, act)]
            start = (round_idx * k) % a
            idx = walk[np.arange(start, start + k) % a]
            return np.sort(idx)
        rng = np.random.default_rng([self.seed, round_idx])
        if self.probs is None:
            p = None
        elif a == self.num_clients:
            p = self.probs
        else:
            p = self.probs[act] / self.probs[act].sum()
        idx = act[rng.choice(a, k, replace=False, p=p)]
        return np.sort(idx)


# ---------------------------------------------------------------------------
# staleness and the combine: the host pending list (loop mode)
# ---------------------------------------------------------------------------
@dataclass
class PendingUpdate:
    """A straggler's in-flight round message (loop mode)."""
    client: int
    issued_round: int
    due_round: int
    delta: Params
    weight: float


def combine_arrivals(arrivals: Sequence[Any], staleness_decay: float, *,
                     clients: Optional[Sequence[int]] = None,
                     slab: Optional[torch.Tensor] = None) -> Params:
    """Eq. (2) weighted mean of one round's arriving messages.

    ``arrivals`` is a non-empty list of ``(age, delta, weight)``, each
    ``delta`` a parameter dict; ``staleness_decay`` must lie in [0, 1].
    ``clients`` (optional, aligned with ``arrivals``) enables the
    duplicate-client guard: two weight>0 arrivals from one client in one
    delivery window would double-count its Eq. (2) weight and are
    refused.  Zero-weight arrivals are absent, and a round whose
    arrivals all weigh zero is an empty round (``ValueError``, as for an
    empty list): the caller skips the combine.  The reference's checks
    and messages.

    INVARIANT: ``staleness_decay ** age`` scales the DELTA, not the
    weight — a weight-only discount cancels in the normalization when a
    round's arrivals share one age.

    Each arrival becomes one row of a flat ``(n, D)`` fp32 slab (leaves
    in :func:`flat_layout` order, written into ``slab``'s first rows when
    it is given and wide enough, else into a new one), scaled in place by
    its discount, and the slab goes through ``ops.fed_weighted_combine``:
    kernel B2 once on a CUDA device, its plain version on the CPU.
    """
    if not 0.0 <= staleness_decay <= 1.0:
        raise ValueError(f"staleness_decay must be in [0, 1], got "
                         f"{staleness_decay!r} (values outside amplify or "
                         "sign-flip stale deltas)")
    arrivals = list(arrivals)
    if clients is not None:
        if len(clients) != len(arrivals):
            raise ValueError(
                f"combine_arrivals got {len(clients)} client ids for "
                f"{len(arrivals)} arrivals — the alignment is the whole "
                "point of the duplicate guard")
        live = [int(c) for c, a in zip(clients, arrivals) if a[2] > 0]
        dupes = sorted({c for c in live if live.count(c) > 1})
        if dupes:
            raise ValueError(
                f"combine_arrivals got multiple weight>0 arrivals from "
                f"client(s) {dupes} in one delivery window — a duplicated "
                "client double-counts its Eq. (2) weight; the engine "
                "supersedes in-flight deltas at message time (newest "
                "wins), so this is a routing bug upstream")
    arrivals = [a for a in arrivals if a[2] > 0]
    if not arrivals:
        raise ValueError("combine_arrivals needs at least one (age, delta, "
                         "weight) arrival with weight > 0; an all-straggler "
                         "(or all-padded) round must skip the combine, not "
                         "average nothing")
    layout = flat_layout(arrivals[0][1])
    n, d = len(arrivals), layout[-1][2] + layout[-1][3]
    dev = next(iter(arrivals[0][1].values())).device
    if slab is None or slab.shape[0] < n or slab.shape[1] != d \
            or slab.device != dev or slab.dtype != torch.float32:
        slab = torch.empty((n, d), dtype=torch.float32, device=dev)
    rows = slab[:n]
    for row, (age, delta, _) in zip(rows, arrivals):
        torch.cat([delta[name].reshape(-1).to(torch.float32)
                   for name, _, _, _ in layout], out=row)
        if age:
            row.mul_(staleness_decay ** age)
    bar = ops.fed_weighted_combine(
        rows, torch.tensor([float(w) for _, _, w in arrivals],
                           dtype=torch.float32))
    return {name: bar[off:off + k].view(shape)
            for name, shape, off, k in layout}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class FederationEngine:
    """Engine state: params, clients, cohort scheduler, transform stage,
    pending list and server optimizer (module docstring).

    ``loss_fn(params, batch) -> scalar mean loss`` is the client's local
    objective, ``loss_sum_fn`` its mask-aware ``(sum, count)`` form for
    the stacked path.  ``message`` is ``"delta"`` (E local epochs, the
    ``RoundConfig`` server optimizer) or ``"grad"`` (one minibatch
    gradient, E = 1, an explicit ``server`` stage).  ``exec_mode`` and
    ``transforms`` override the ``RoundConfig``'s; ``num_clients_for_masks``
    sets the secure-mask population (default: the client count).
    """

    def __init__(self, loss_fn, init_params: Mapping[str, torch.Tensor],
                 clients: Sequence[ClientState], fed: FederatedConfig,
                 rounds: Optional[RoundConfig] = None, *,
                 batch_size: int = 64, exec_mode: Optional[str] = None,
                 loss_sum_fn=None, message: str = "delta",
                 server: Optional[agg.ServerOptimizer] = None,
                 transforms: Optional[Sequence[str]] = None,
                 num_clients_for_masks: Optional[int] = None):
        if message not in MESSAGE_KINDS:
            raise ValueError(f"unknown message kind {message!r}; "
                             f"one of {MESSAGE_KINDS}")
        if message == "grad" and server is None:
            raise ValueError(
                "message='grad' needs an explicit server stage: gradient "
                "messages point UPHILL, so the delta-convention "
                "RoundConfig server optimizers (which ADD their step) "
                "would train by ascent — wrap the client optimizer, e.g. "
                "protocol._wrap_client_optimizer(sgd(lr)), or use the "
                "FederatedTrainer preset")
        self.loss_fn = loss_fn
        self.params: Params = dict(init_params)
        self.clients = list(clients)
        self.fed = fed
        self.rc = rounds or RoundConfig()
        self.batch_size = batch_size
        self.message = message
        self.exec_mode = exec_mode or self.rc.exec_mode
        if self.exec_mode not in EXEC_MODES:
            raise ValueError(f"unknown exec_mode {self.exec_mode!r}; "
                             f"one of {EXEC_MODES}")
        if self.rc.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(
                f"unknown kernel_backend {self.rc.kernel_backend!r}; "
                f"one of {KERNEL_BACKENDS}")
        self._nmask = num_clients_for_masks or len(self.clients)
        if not 0.0 <= self.rc.staleness_decay <= 1.0:
            raise ValueError(
                f"staleness_decay must be in [0, 1], got "
                f"{self.rc.staleness_decay!r} — both the loop-mode "
                "combine_arrivals and the fused ring buffer would "
                "amplify or sign-flip stale deltas outside that range")

        # -- transform stage ---------------------------------------------
        names = tuple(transforms if transforms is not None
                      else self.rc.transforms)
        if not names and (fed.dp_noise_multiplier > 0
                          or fed.compression_topk > 0
                          or fed.secure_aggregation
                          or bool(fed.message_precision)):
            raise NotImplementedError(
                "FederatedConfig requests message-level "
                "privacy/compression/precision but no transform stage is "
                "configured for this engine; declare the intent explicitly "
                "via RoundConfig.transforms="
                "('dp'|'topk'|'secure'|'precision', ...) "
                "(or use the FederatedTrainer preset, which derives its "
                "grad transforms from FederatedConfig automatically) — "
                "the knobs are never silently dropped")
        vmap = self.exec_mode == "vmap"
        if vmap:
            _check_vmap_preconditions(self.clients, batch_size, loss_sum_fn,
                                      what=type(self).__name__)
        self._transforms = build_transforms(names, fed)
        # the flat (K, D) message slab's columns, one segment per leaf
        self.layout = flat_layout(self.params)
        # transform state (the topk error memory, one row per GLOBAL
        # client), kept on the params' device, under both exec modes
        self._tstate: Dict[str, Any] = {}
        dev = next(iter(self.params.values())).device
        for name, t in self._transforms:
            st = t.init_state(self.layout, len(self.clients), dev)
            if st is not None:
                self._tstate[name] = st

        # -- local-update stage ------------------------------------------
        self._epochs = _cycle_per_client(self.rc.local_epochs_by_client,
                                         len(self.clients),
                                         self.rc.local_epochs)
        if len(self.clients) and (self._epochs < 1).any():
            raise ValueError(
                "every client needs >= 1 local epoch (got "
                f"local_epochs={self.rc.local_epochs}, "
                f"local_epochs_by_client={self.rc.local_epochs_by_client}) "
                "— a zero-epoch client has no round message and would "
                "divide the Eq. (2) combine by zero")
        self._e_max = int(self._epochs.max()) if len(self.clients) else 1
        self._hetero = bool((self._epochs != self._epochs[0]).any()) \
            if len(self.clients) else False
        if message == "grad" and self._e_max != 1:
            raise ValueError("message='grad' is the single-minibatch "
                             "Algorithm-1 protocol; local_epochs must be 1 "
                             "(use message='delta' for multi-epoch clients)")
        self._grad_fn = torch.func.grad_and_value(loss_fn)
        self._stacked_grad = torch.func.vmap(torch.func.grad_and_value(
            masked_mean_loss(loss_fn, loss_sum_fn)))

        # -- sampler stage -----------------------------------------------
        self.scheduler = RoundScheduler(
            len(self.clients), self.rc.clients_per_round,
            mode=self.rc.sampling,
            weights=[c.num_docs for c in self.clients]
            if self.rc.sampling == "weighted" else None,
            seed=self.rc.sampling_seed,
            join_rounds=self.rc.client_join_round,
            leave_rounds=self.rc.client_leave_round)
        self._check_secure_compat()
        if vmap and self.rc.straggler_prob > 0 and self.rc.max_staleness > 0:
            raise _not_ported("stragglers on the batched cohort path (the "
                              "fused straggler ring)", "A10")
        # fixed-K stacking: shrunken cohorts padded with zero-weight rows
        self._pad = vmap and self.rc.pad_cohorts and len(self.clients) > 0

        # -- combine / staleness stage -----------------------------------
        self.pending: List[PendingUpdate] = []
        # the loop path's (L, D) arrival slab, made at the first combine
        # and reused: after the newest-wins dedupe a round delivers at
        # most one message per client
        self._slab: Optional[torch.Tensor] = None

        # -- server stage ------------------------------------------------
        self.server_opt = server or self._make_server_opt(self.rc)
        self.server_state = self.server_opt.init(self.params)
        self.history: List[Dict[str, float]] = []
        self._round = 0

    def _check_secure_compat(self) -> None:
        """Pairwise masks only cancel when every mask-holder's message
        lands in the SAME Eq. (2) combine, unscaled — refuse configs
        that would silently break the cancellation."""
        if not any(n == "secure" for n, _ in self._transforms):
            return
        if any(n == "precision" for n, _ in self._transforms):
            raise ValueError(
                "the 'secure' transform is incompatible with 'precision' "
                "(bf16 messages): the pairwise masks cancel BITWISE only "
                "on the fp32 dyadic grid — rounding the masked messages "
                "to bfloat16 destroys the cancellation, which would be a "
                "silent privacy downgrade, not an approximation")
        if self.rc.straggler_prob > 0 and self.rc.max_staleness > 0:
            raise ValueError(
                "the 'secure' transform is incompatible with the straggler "
                "buffer: a stale masked message arrives in a later combine "
                "than its pair partners (and is decay-scaled), so the "
                "pairwise masks no longer cancel")
        if (self.scheduler.clients_per_round < len(self.clients)
                or self.scheduler._has_availability):
            raise ValueError(
                "the 'secure' transform needs synchronous full "
                "participation (K = L, no client dropout/join): pairwise "
                "masks over the full population only cancel when every "
                "client's message joins the same combine")

    @staticmethod
    def _make_server_opt(rc: RoundConfig) -> agg.ServerOptimizer:
        kw = {"server_lr": rc.server_lr}
        if rc.server_optimizer == "fedavgm":
            kw["momentum"] = rc.server_momentum
        elif rc.server_optimizer == "fedadam":
            kw.update(b1=rc.server_momentum, b2=rc.server_beta2,
                      eps=rc.server_eps)
        return agg.get_server_optimizer(rc.server_optimizer, **kw)

    # -- staleness ----------------------------------------------------------
    def _straggler_delay(self, round_idx: int, client: int) -> int:
        """0 = delivered this round; d>0 = arrives d rounds late (numpy,
        so the delays are the reference's bit for bit)."""
        rc = self.rc
        if rc.straggler_prob <= 0.0 or rc.max_staleness <= 0:
            return 0
        rng = np.random.default_rng(
            [rc.sampling_seed, 0x57A1E, round_idx, client])
        if rng.random() >= rc.straggler_prob:
            return 0
        return int(rng.integers(1, rc.max_staleness + 1))

    # -- the host loop ------------------------------------------------------
    def _deliver_and_apply(self, r: int, fresh, fresh_clients=None
                           ) -> Tuple[Optional[torch.Tensor], int, int]:
        """Merge this round's fresh arrivals with due stragglers, run the
        staleness-discounted Eq. (2) combine and the server step.
        Returns ``(rel_change, num_arrived, num_superseded)``, the
        relative change a 0-dim device tensor (None: nothing arrived)."""
        due = [p for p in self.pending if p.due_round <= r]
        self.pending = [p for p in self.pending if p.due_round > r]
        superseded = 0
        if fresh_clients is not None:
            # newest-wins within the delivery window: a fresh message
            # beats the same client's due straggler delta, and among due
            # deltas from one client the latest issue wins
            fresh_ids = set(fresh_clients)
            best: Dict[int, PendingUpdate] = {}
            for p in due:
                if p.client in fresh_ids:
                    superseded += 1
                    continue
                b = best.get(p.client)
                if b is None:
                    best[p.client] = p
                else:
                    superseded += 1
                    if p.issued_round > b.issued_round:
                        best[p.client] = p
            due = [p for p in due if best.get(p.client) is p]
        arrivals = list(fresh) + [(r - p.issued_round, p.delta, p.weight)
                                  for p in due]
        clients = None
        if fresh_clients is not None:
            clients = list(fresh_clients) + [p.client for p in due]
        if not arrivals:
            return None, 0, superseded
        if self._slab is None:
            self._slab = torch.empty(
                (max(len(self.clients), 1), self.layout[-1][2]
                 + self.layout[-1][3]), dtype=torch.float32,
                device=next(iter(self.params.values())).device)
        delta_bar = combine_arrivals(arrivals, self.rc.staleness_decay,
                                     clients=clients, slab=self._slab)
        old = self.params
        self.params, self.server_state = self.server_opt.apply(
            self.params, delta_bar, self.server_state, r)
        return _rel_change(old, self.params), len(arrivals), superseded

    def _local_message(self, l: int, round_seed: int):
        """One client's message against ``self.params``: ``(message, n,
        mean_loss)``, the loss a 0-dim device tensor.  A ``"grad"``
        message is the gradient on the draw of ``(round_seed, l, 0)``
        (the batched path's epoch 0); a ``"delta"`` runs the client's E
        epochs on the draws of ``(round_seed, l, epoch)``."""
        c = self.clients[l]
        if self.message == "grad":
            batch, n = sample_minibatch(c.data, c.num_docs,
                                        draw_generator(round_seed, l, 0),
                                        self.batch_size)
            grads, loss = self._grad_fn(self.params, batch)
            return grads, float(n), loss.detach()
        return client_round_update(
            self._grad_fn, self.params, c, round_seed, l,
            learning_rate=self.fed.learning_rate,
            local_epochs=int(self._epochs[l]), batch_size=self.batch_size)

    # -- the transform stage ------------------------------------------------
    def _message_slab(self, msgs: Sequence[Mapping[str, torch.Tensor]]
                      ) -> torch.Tensor:
        """The messages as the rows of a new ``(n, D)`` fp32 slab (leaves in
        :func:`flat_layout` order): storage of its own, row 0 at its start,
        so it aliases no other slab and meets B4's 16-byte alignment."""
        slab = torch.empty((len(msgs), self.layout[-1][2]
                            + self.layout[-1][3]), dtype=torch.float32,
                           device=next(iter(self.params.values())).device)
        for row, msg in zip(slab, msgs):
            torch.cat([msg[name].reshape(-1).to(torch.float32)
                       for name, _, _, _ in self.layout], out=row)
        return slab

    def transform_messages(self, msgs: torch.Tensor, client_ids,
                           weights: torch.Tensor, round_seed: int,
                           valid: Optional[np.ndarray] = None
                           ) -> torch.Tensor:
        """Run the transform stage, in its listed order, over an ``(n, D)``
        message slab: row i is global client ``client_ids[i]``'s message
        of Eq. (2) weight ``weights[i]`` (``valid`` marks the real rows,
        default all).  One call per transform for the whole slab — one B3
        launch for ``dp`` or ``secure``, one B4 call for ``topk`` — with
        the ``topk`` error memory updated in place.  The host loop hands
        a round's cohort, the service one upload as a ``(1, D)`` slab."""
        ids = np.asarray(client_ids, np.int64)
        ctx = StackedTransformCtx(
            round_seed, ids,
            np.ones(len(ids), bool) if valid is None else valid,
            weights.to(msgs.device, torch.float32), self._nmask,
            self.layout)
        for name, t in self._transforms:
            msgs, st = t.stacked(msgs, ctx, self._tstate.get(name))
            if name in self._tstate:
                self._tstate[name] = st
        return msgs

    def transform_message(self, l: int, msg: Mapping[str, torch.Tensor],
                          n: float, round_seed: int) -> Params:
        """One client's message through the transform stage (a ``(1, D)``
        slab); without a stage the message as it is."""
        if not self._transforms:
            return dict(msg)
        row = self.transform_messages(self._message_slab([msg]), [l],
                                      torch.tensor([n]), round_seed)[0]
        return self._unflatten(row)

    def _round_loop(self, r: int, round_seed: int, cohort
                    ) -> Dict[str, float]:
        """Algorithm 1's round on the host: each cohort member's message
        in turn, then the transform stage once over the round's message
        slab, stragglers into the pending list, then the delivery.  The
        losses and the relative change come to the host in one read."""
        cohort = [int(l) for l in cohort]
        msgs, losses, loss_w = [], [], []
        for l in cohort:
            msg, n, loss = self._local_message(l, round_seed)
            msgs.append(msg)
            losses.append(loss)
            loss_w.append(n)
        if self._transforms and cohort:
            slab = self.transform_messages(
                self._message_slab(msgs), cohort,
                torch.tensor(loss_w, dtype=torch.float32), round_seed)
            msgs = [self._unflatten(row) for row in slab]
        fresh, fresh_clients = [], []      # (age=0, message, weight)
        for i, (l, msg, n) in enumerate(zip(cohort, msgs, loss_w)):
            d = self._straggler_delay(r, l)
            if d == 0:
                fresh.append((0, msg, n))
                fresh_clients.append(l)
            else:
                if self._transforms:
                    # its own copy: the pending message must not keep (or
                    # share) the round's slab
                    msg = self._unflatten(slab[i].clone())
                self.pending.append(PendingUpdate(l, r, r + d, msg, n))
        rel, arrived, superseded = self._deliver_and_apply(
            r, fresh, fresh_clients)
        reads = losses + ([rel] if rel is not None else [])
        host = torch.stack(reads).cpu().numpy() if reads else np.zeros(0)
        return {"round": r,
                "loss": float(np.average(host[:len(losses)],
                                         weights=loss_w))
                if losses else float("nan"),
                "rel_change": float(host[-1]) if rel is not None else 0.0,
                "participants": len(cohort),
                "arrived": arrived,
                "superseded": superseded,
                "in_flight": len(self.pending)}

    # -- the batched cohort path --------------------------------------------
    def _stacked_messages(self, stacked: Mapping[str, torch.Tensor],
                          e_counts: np.ndarray
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All K clients' messages at once: returns the flat ``(K, D)``
        slab and the ``(K, E)`` per-epoch mean losses.  A ``"grad"``
        message is the epoch-0 gradient; a ``"delta"`` the E-epoch local
        update, where under heterogeneous E the epochs beyond a client's
        count leave its parameters as they are (the loop client never
        runs them)."""
        k = len(e_counts)
        if self.message == "grad":
            grads, loss = self._stacked_grad(
                {n: p.unsqueeze(0).expand((k,) + tuple(p.shape))
                 for n, p in self.params.items()},
                {n: v[:, 0] for n, v in stacked.items()})
            return torch.cat([grads[n].reshape(k, -1)
                              for n in self.params], dim=1), loss[:, None]
        lr = self.fed.learning_rate
        local = {n: p.unsqueeze(0).expand((k,) + tuple(p.shape))
                 for n, p in self.params.items()}
        losses = []
        for s in range(self._e_max):
            grads, loss = self._stacked_grad(
                local, {n: v[:, s] for n, v in stacked.items()})
            stepped = {n: p - lr * grads[n].to(p.dtype)
                       for n, p in local.items()}
            if self._hetero:
                keep = torch.from_numpy(s < e_counts).to(loss.device)
                stepped = {n: torch.where(
                    keep.reshape((-1,) + (1,) * (v.dim() - 1)), v, local[n])
                    for n, v in stepped.items()}
                loss = torch.where(keep, loss, torch.zeros_like(loss))
            local = stepped
            losses.append(loss)
        msgs = torch.cat([(local[n] - p).reshape(k, -1)
                          for n, p in self.params.items()], dim=1)
        return msgs, torch.stack(losses, dim=1)

    def _unflatten(self, vec: torch.Tensor) -> Params:
        return {name: vec[off:off + n].view(shape)
                for name, shape, off, n in self.layout}

    def _round_vmap(self, r: int, round_seed: int, cohort) -> Dict[str, float]:
        cohort = [int(l) for l in cohort]
        if not cohort:
            # an all-padded round: no message, so params, server state
            # and transform state stay bitwise as they are (the
            # reference's has-weight gate)
            return {"round": r, "loss": float("nan"), "rel_change": 0.0,
                    "participants": 0, "arrived": 0, "superseded": 0,
                    "in_flight": 0}
        k_fix = self.scheduler.clients_per_round if self._pad \
            else len(cohort)
        stacked, counts = stacked_round_batches(
            [self.clients[l].data for l in cohort],
            [self.clients[l].num_docs for l in cohort], round_seed, cohort,
            batch_size=self.batch_size, local_epochs=self._e_max,
            pad_to=k_fix)
        e_counts = np.zeros((k_fix,), np.int64)
        e_counts[:len(cohort)] = self._epochs[cohort]
        ids = np.zeros((k_fix,), np.int64)
        ids[:len(cohort)] = cohort
        # epochs beyond a client's count (and padded rows) weigh nothing
        counts = counts * (np.arange(self._e_max)[None, :]
                           < e_counts[:, None])
        weights = counts.sum(axis=1).astype(np.float32)
        valid = weights > 0

        msgs, losses = self._stacked_messages(stacked, e_counts)
        w = torch.from_numpy(weights).to(msgs.device)
        if self._transforms:
            msgs = self.transform_messages(msgs, ids, w, round_seed, valid)
        # padded rows are absent: re-zeroed after the transform stage
        keep = torch.from_numpy(valid).to(msgs.device)[:, None]
        msgs = torch.where(keep, msgs, torch.zeros((), device=msgs.device))
        bar = ops.fed_weighted_combine(msgs, w)
        rel = 0.0
        if weights.sum() > 0:
            old = self.params
            self.params, self.server_state = self.server_opt.apply(
                self.params, self._unflatten(bar), self.server_state, r)
            rel = float(_rel_change(old, self.params))

        losses = np.where(counts > 0, losses.detach().cpu().numpy(), 0.0)
        client_loss = (losses * counts).sum(axis=1) \
            / np.maximum(counts.sum(axis=1), 1.0)
        return {"round": r,
                "loss": float(np.average(client_loss, weights=weights)),
                "rel_change": rel,
                "participants": len(cohort),
                "arrived": len(cohort),
                "superseded": 0,
                "in_flight": 0}

    # -- stopping, rounds ---------------------------------------------------
    @staticmethod
    def stop_criterion(rec: Mapping[str, Any], rel_tol: float) -> bool:
        """The Alg.-1 stopping rule, applied only to rounds where an update
        landed; shared by :meth:`fit` and ``api.Federation``."""
        return bool(rec["arrived"]) and rec["rel_change"] < rel_tol

    def round(self, seed: Optional[int] = None) -> Dict[str, float]:
        """Sample cohort -> local updates -> transforms -> staleness
        routing -> Eq. (2) combine -> server-optimizer update; ``seed`` is
        the round's draw seed (default: the round index)."""
        r = self._round
        round_seed = r if seed is None else int(seed)
        cohort = self.scheduler.select(r)
        if self.exec_mode == "vmap":
            rec = self._round_vmap(r, round_seed, cohort)
        else:
            rec = self._round_loop(r, round_seed, cohort)
        self.history.append(rec)
        self._round += 1
        return rec

    def fit(self, *, seed: int = 0, verbose: bool = False) -> Params:
        """``fed.max_rounds`` rounds with the fixed per-round seed schedule
        ``seed * 100003 + round`` and the Alg.-1 stopping criterion."""
        for e in range(self.fed.max_rounds):
            rec = self.round(seed=seed * 100003 + e)
            if verbose and e % 10 == 0:
                print(f"[round {e:4d}] loss={rec['loss']:.4f} "
                      f"rel={rec['rel_change']:.2e} "
                      f"K={rec['participants']} "
                      f"arrived={rec['arrived']}")
            if self.stop_criterion(rec, self.fed.rel_tol):
                break
        return self.params
