"""The loop-mode federation engine: what the buffered-async service calls.

Port of the part of ``repro/core/engine.py`` the service runs: the
client state, the delta message, one client's E-epoch local update, the
fixed-capacity delta-slot layout, and an engine holding params, clients
and the server optimizer that exposes ``_local_message``.  Rounds,
sampling, stragglers and the vmap path wait for their slices (ROADMAP
A8, A10); the message transforms for A9.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FederatedConfig, RoundConfig
from repro_torch.core import aggregation as agg
from repro_torch.data.federated_split import round_minibatches

Params = Dict[str, torch.Tensor]

EXEC_MODES = ("loop", "vmap")
KERNEL_BACKENDS = ("xla", "pallas")
SAMPLING_MODES = ("uniform", "weighted", "deterministic")


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


class FederationEngine:
    """Loop-mode engine state: params, clients, server optimizer.

    ``loss_fn(params, batch) -> scalar mean loss`` is the client's local
    objective; a client message is the E-epoch delta ``W_l - W``.
    """

    def __init__(self, loss_fn, init_params: Mapping[str, torch.Tensor],
                 clients: Sequence[ClientState], fed: FederatedConfig,
                 rounds: Optional[RoundConfig] = None, *,
                 batch_size: int = 64):
        self.loss_fn = loss_fn
        self.params: Params = dict(init_params)
        self.clients = list(clients)
        self.fed = fed
        self.rc = rounds or RoundConfig()
        self.batch_size = batch_size
        by_client = self.rc.local_epochs_by_client
        self._epochs = (np.asarray(by_client, np.int64)[
            np.arange(len(self.clients)) % len(by_client)] if by_client
            else np.full(len(self.clients), self.rc.local_epochs, np.int64))
        self._grad_fn = torch.func.grad_and_value(loss_fn)
        self.server_opt = self._make_server_opt(self.rc)
        self.server_state = self.server_opt.init(self.params)

    @staticmethod
    def _make_server_opt(rc: RoundConfig) -> agg.ServerOptimizer:
        kw = {"server_lr": rc.server_lr}
        if rc.server_optimizer == "fedavgm":
            kw["momentum"] = rc.server_momentum
        elif rc.server_optimizer == "fedadam":
            kw.update(b1=rc.server_momentum, b2=rc.server_beta2,
                      eps=rc.server_eps)
        return agg.get_server_optimizer(rc.server_optimizer, **kw)

    def _local_message(self, l: int, round_seed: int):
        """One client's local update against ``self.params``:
        ``(delta, n, mean_loss)``; the draws are seeded from
        ``(round_seed, l, epoch)``."""
        return client_round_update(
            self._grad_fn, self.params, self.clients[l], round_seed, l,
            learning_rate=self.fed.learning_rate,
            local_epochs=int(self._epochs[l]), batch_size=self.batch_size)
