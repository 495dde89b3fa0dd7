"""`FederationService` — FedBuff-style buffered-async federation + serving.

Port of ``repro/serve/service.py`` for ProdLDA and the registry LMs.  One
process, two surfaces:

* **train**: clients fetch the live model version, run the engine's
  loop-path local update and its transform stage (one ``(1, D)`` B3 or
  B4 call per upload for ``dp`` or ``topk``) and ``upload`` the delta.
  Whenever M deltas accumulate in the :class:`DeltaBuffer` the service
  applies one staleness-discounted Eq. (2) combine — kernel B2 over the
  flat ``(M, D)`` buffer on a CUDA device — and a server-optimizer step,
  and advances the model version.
* **serve**: ``infer`` answers doc->topic requests from the live model,
  read through one atomic reference swap (``model.family="ntm"``);
  ``generate`` decodes greedily from it (``model.family="lm"``: one
  batched prefill, then lock-step decode through the registry bundle);
  ``evaluate`` scores it on held-out documents (kernel B1 computes
  ProdLDA's reconstruction term).

Late (version lag > ``schedule.max_staleness``), superseded, malformed
and post-shutdown deltas are rejected with the reference's reasons
(:data:`REJECT_REASONS`).  With ``M=K``, ``max_staleness=0`` and in-order
arrivals every aggregation is one synchronous FedAvg round.

Snapshots and checkpoints (ROADMAP A11) wait for their slice.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.api.federation import Federation
from repro_torch.api.spec import FederationSpec, spec_replace
from repro_torch.core.ntm import prodlda
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tfm
from repro_torch.serve.buffer import DeltaBuffer

REJECT_REASONS = ("stale", "superseded", "unknown_client", "draining",
                  "zero_weight", "bad_version", "upload_failed",
                  "malformed", "wire_version")

# the ledger keeps only the newest records; per-reason totals in
# `rejection_totals` are monotonic and survive eviction
REJECTION_LEDGER_CAP = 256


class UploadTimeout(RuntimeError):
    """Transient transport failure during an upload attempt (retryable)."""


def sync_twin_spec(spec: FederationSpec) -> FederationSpec:
    """The round-synchronous twin of a buffered-async spec (the async
    knobs reset): the service wires model, corpus, clients and server
    optimizer through ``Federation.from_spec(twin)``."""
    return spec_replace(spec, {"schedule.mode": "sync",
                               "schedule.buffer_size": 0,
                               "schedule.staleness_policy": "",
                               "schedule.max_staleness": 0,
                               "serving": None})


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"FederationService.{what} is not ported to repro_torch yet "
        f"(ROADMAP.md {item})")


class FederationService:
    """Buffered-async federation server + live model serving."""

    def __init__(self, spec: FederationSpec, fed: Federation):
        if spec.schedule.mode != "buffered_async":
            raise ValueError(
                "FederationService runs schedule.mode='buffered_async' "
                "specs; a sync spec belongs to Federation.from_spec")
        self.spec = spec
        self._fed = fed
        eng = fed.engine
        self.buffer_size = spec.resolved_buffer_size
        self.max_staleness = spec.schedule.max_staleness
        self.staleness_policy = spec.resolved_staleness_policy
        self.version = 0
        self.agg_index = 0
        self.draining = False
        self.server_state = eng.server_state
        self.buffer = DeltaBuffer(eng.params, self.buffer_size)
        self.client_rounds = [0] * spec.data.num_clients
        self.rejections: List[Dict[str, Any]] = []
        self.rejection_totals: Dict[str, int] = {}
        self.history: List[Dict[str, Any]] = []
        # the serving reference: ONE attribute holding (version, params);
        # aggregation publishes by rebinding it (the atomic hot swap)
        self._live = (0, eng.params)
        self._bundle = None         # the LM bundle, built at first generate

    @classmethod
    def from_spec(cls, spec: Union[FederationSpec, Mapping, str], *,
                  device=None, corpus=None, clients=None, loss_fn=None,
                  loss_sum_fn=None, init_params=None
                  ) -> "FederationService":
        """Build a buffered-async spec (object, mapping, or registry
        name) into a running service on ``device`` (default ``cuda``;
        raises on a host without one).  The overrides match
        ``Federation.from_spec``."""
        if isinstance(spec, str):
            from repro_torch.api.registry import scenario_spec
            spec = scenario_spec(spec)
        elif isinstance(spec, Mapping):
            spec = FederationSpec.from_dict(spec)
        spec.validate()
        if spec.schedule.mode != "buffered_async":
            raise ValueError(
                "FederationService.from_spec needs "
                "schedule.mode='buffered_async'; run sync specs through "
                "Federation.from_spec")
        fed = Federation.from_spec(sync_twin_spec(spec), device=device,
                                   corpus=corpus, clients=clients,
                                   loss_fn=loss_fn, loss_sum_fn=loss_sum_fn,
                                   init_params=init_params)
        return cls(spec, fed)

    @property
    def device(self) -> torch.device:
        return self._fed.device

    # -- the train surface -------------------------------------------------
    def fetch_model(self):
        """What a client pulls before training: ``(version, params)``."""
        return self._live

    def client_update(self, client: int):
        """One client's local update against the CURRENT published model,
        then the engine's transform stage on it, with the per-client
        upload counter as the round index of the seed schedule (``dp``
        noise from ``(seed * 100003 + t, client, 7)``).  Returns
        ``(base_version, delta, weight)``."""
        L = self.spec.data.num_clients
        if not 0 <= int(client) < L:
            raise ValueError(f"unknown client {client!r}; this federation "
                             f"registers clients 0..{L - 1}")
        eng = self._fed.engine
        version, params = self._live
        eng.params = params
        t = self.client_rounds[client]
        round_seed = self.spec.execution.seed * 100003 + t
        msg, n, _loss = eng._local_message(int(client), round_seed)
        msg = eng.transform_message(int(client), msg, n, round_seed)
        self.client_rounds[client] = t + 1
        return version, msg, float(n)

    def submit(self, client: int, delta, weight: float, *,
               base_version: int) -> Dict[str, Any]:
        """Offer one delta to the buffer; returns a receipt
        ``{"accepted", "reason", "version", "slot"}``."""
        client = int(client)
        receipt: Dict[str, Any] = {"client": client, "accepted": False,
                                   "reason": None, "version": self.version,
                                   "slot": -1}
        L = self.spec.data.num_clients
        if self.draining:
            return self._reject(receipt, base_version, "draining")
        if not 0 <= client < L:
            return self._reject(receipt, base_version, "unknown_client")
        if not np.isfinite(weight) or weight <= 0:
            return self._reject(receipt, base_version, "zero_weight")
        if not isinstance(base_version, (int, np.integer)) \
                or base_version < 0 or base_version > self.version:
            return self._reject(receipt, base_version, "bad_version")
        if self.version - base_version > self.max_staleness:
            return self._reject(receipt, base_version, "stale")
        slot = self.buffer.slot_of(client)
        if slot >= 0:
            # last-write-wins: one slot per client, so one aggregation
            # can never double-count a client's weight
            self._record(client, base_version, "superseded")
            receipt["superseded_previous"] = True
        slot = self.buffer.insert(delta, weight, client,
                                  int(base_version), slot=slot)
        receipt.update(accepted=True, slot=slot)
        if self.buffer.full:
            self._aggregate()
        return receipt

    def upload(self, client: int, *, max_retries: int = 3,
               backoff_s: float = 0.05, transport=None,
               sleep_fn=None) -> Dict[str, Any]:
        """``client_update`` + ``submit`` with retry/backoff: a
        :class:`UploadTimeout` from ``transport(client, attempt)`` retries
        after ``backoff_s * 2**attempt``; after ``max_retries`` failures
        the delta is dropped as ``upload_failed``.  The delta is computed
        once and the staleness check runs at submit time."""
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if self.draining:
            receipt = {"client": int(client), "accepted": False,
                       "reason": None, "version": self.version, "slot": -1}
            return self._reject(receipt, self.version, "draining")
        base_version, delta, weight = self.client_update(client)
        sleep = sleep_fn if sleep_fn is not None else time.sleep
        attempt = 0
        while True:
            try:
                if transport is not None:
                    transport(int(client), attempt)
                return self.submit(client, delta, weight,
                                   base_version=base_version)
            except UploadTimeout:
                attempt += 1
                if attempt > max_retries:
                    receipt = {"client": int(client), "accepted": False,
                               "reason": None, "version": self.version,
                               "slot": -1}
                    return self._reject(receipt, base_version,
                                        "upload_failed")
                sleep(backoff_s * (2 ** (attempt - 1)))

    def _reject(self, receipt: Dict[str, Any], base_version,
                reason: str) -> Dict[str, Any]:
        self._record(receipt["client"], base_version, reason)
        receipt["reason"] = reason
        return receipt

    def _record(self, client: int, base_version, reason: str) -> None:
        if reason not in REJECT_REASONS:
            raise ValueError(f"unknown rejection reason {reason!r}")
        self.rejection_totals[reason] = \
            self.rejection_totals.get(reason, 0) + 1
        self.rejections.append({"client": int(client),
                                "base_version": int(base_version),
                                "at_version": self.version,
                                "reason": reason})
        overflow = len(self.rejections) - REJECTION_LEDGER_CAP
        if overflow > 0:
            del self.rejections[:overflow]

    @property
    def rejection_counts(self) -> Dict[str, int]:
        """Monotonic per-reason totals (never lose counts to eviction)."""
        return dict(self.rejection_totals)

    def _aggregate(self) -> None:
        """One FedBuff aggregation: discount, combine, server step,
        version bump, atomic publish, buffer reset.

        The staleness discount scales the DELTA, never the Eq. (2) weight:
        it is folded into the kernel's per-slot coefficients
        ``w_k * disc_k`` while the denominator stays ``max(sum w, 1e-12)``.
        Free slots (base version -1) get a garbage age but weight 0, so
        their coefficient is 0 and the kernel never reads them."""
        flat, weights, _clients, base_versions = self.buffer.stacked()
        n = self.buffer.count
        ages = np.maximum(np.float32(self.version)
                          - base_versions.astype(np.float32), 0.0)
        if self.staleness_policy == "exponential":
            disc = np.power(np.float32(self.spec.schedule.staleness_decay),
                            ages)
        else:                            # "polynomial": FedBuff's choice
            disc = np.float32(1.0) / np.sqrt(np.float32(1.0) + ages)
        coefs = torch.from_numpy((weights * disc).astype(np.float32))
        total = max(float(np.sum(weights, dtype=np.float32)), 1e-12)
        bar = self.buffer.unflatten(kops.fed_weighted_sum(flat, coefs)
                                    / total)
        new_params, self.server_state = self._fed.engine.server_opt.apply(
            self._live[1], bar, self.server_state, self.agg_index)
        ages_live = self.version - base_versions[:n]
        self.agg_index += 1
        self.version += 1
        self.history.append({
            "agg": self.agg_index - 1, "version": self.version,
            "arrivals": n,
            "mean_age": float(ages_live.mean()) if n else 0.0,
            "max_age": int(ages_live.max()) if n else 0})
        self.buffer.reset()
        self._live = (self.version, new_params)   # the atomic hot swap

    def shutdown(self, *, drain: bool = True) -> Dict[str, Any]:
        """Stop accepting uploads; with ``drain`` a partially-filled
        buffer aggregates first (free slots are masked)."""
        flushed = 0
        if drain and self.buffer.count:
            flushed = self.buffer.count
            self._aggregate()
        self.draining = True
        return {"version": self.version, "aggregations": self.agg_index,
                "flushed": flushed}

    # -- the serve surface -------------------------------------------------
    def infer(self, bow, contextual=None) -> torch.Tensor:
        """Batched doc->topic posteriors ``theta (B, K)`` from the live
        model, on the service's device (``prodlda.infer_theta``,
        ``train=False``).  ``contextual`` goes with the batch, as in the
        reference; the spec-built model's input mode is ``bow``, which
        reads only the BoW."""
        if self.spec.model.family == "lm":
            raise ValueError(
                "doc->topic posteriors are an NTM surface; an LM-family "
                "service serves generate()")
        params = self._live[1]
        bow = torch.as_tensor(bow, dtype=torch.float32, device=self.device)
        if contextual is not None:
            contextual = torch.as_tensor(contextual, dtype=torch.float32,
                                         device=self.device)
        with torch.no_grad():
            return prodlda.infer_theta(params, self._fed.model_cfg, bow,
                                       contextual=contextual)

    def evaluate(self) -> Dict[str, float]:
        """Held-out metrics of the live model (``Federation.evaluate``)."""
        self._fed.engine.params = self._live[1]
        return self._fed.evaluate()

    def generate(self, prompts, max_new: int = 16) -> np.ndarray:
        """Greedy generation from the live model (``model.family="lm"``
        only): one batched fp32 prefill of the ``(B, S)`` prompts, then
        lock-step decode through the registry bundle, as
        ``launch/serve.py`` runs.  Returns ``(B, max_new)`` int32
        tokens."""
        if self.spec.model.family != "lm":
            raise ValueError(
                "generation is an LM surface (model.family='lm'); the "
                "NTM service serves doc->topic posteriors via infer()")
        if self._bundle is None:
            from repro_torch.models.registry import build_model
            self._bundle = build_model(self._fed.model_cfg,
                                       dtype=torch.float32)
        b = self._bundle
        prompts = torch.as_tensor(np.asarray(prompts),
                                  dtype=torch.int64).to(self.device)
        params = tfm.unstack_layers(self._live[1])
        with torch.no_grad():
            logits, cache = b.prefill(
                params, {"tokens": prompts},
                max_len=prompts.shape[1] + int(max_new))
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
            out = [tok]
            for _ in range(int(max_new) - 1):
                logits, cache = b.decode_step(params, cache, tok)
                tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()

    # -- later slices --------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        _not_ported("state_dict", "A11")

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        _not_ported("load_state_dict", "A11")

    def save_checkpoint(self, path: str) -> Optional[str]:
        _not_ported("save_checkpoint", "A11")
