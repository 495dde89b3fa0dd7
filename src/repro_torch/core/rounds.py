"""Multi-round federated simulation: the ``message="delta"`` preset.

Port of ``repro/core/rounds.py``.  :class:`RoundEngine` is the
:class:`~repro_torch.core.engine.FederationEngine` itself, whose
default message is the delta: the full ``RoundConfig`` surface (K-of-L
sampling, E local epochs, stragglers on the host loop, server
optimizers, heterogeneous epochs, client dropout/join).  :class:`RoundScheduler`, :class:`PendingUpdate`
and :func:`combine_arrivals` are re-exported from the engine.

The degenerate configuration collapses to the paper's trainer:

    K = L, E = 1, no stragglers, FedAvg(server_lr=1)
        ==  FederatedTrainer with sgd(lr)  (same parameter trajectory)
"""
from __future__ import annotations

from repro_torch.core.engine import (  # noqa: F401
    ClientState, FederationEngine, PendingUpdate, RoundScheduler,
    combine_arrivals)

# the engine's default message is "delta", so the preset is the engine
RoundEngine = FederationEngine
