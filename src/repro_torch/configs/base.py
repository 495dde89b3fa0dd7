"""Engine-level configuration: the fields of the reference's
``configs/base.py`` that the buffered-async topic-model service reads.

Same names and defaults as the reference dataclasses.  The fields the
service does not read (LM architecture, transforms, scheduler, mesh)
join with the slices that read them (ROADMAP.md §A).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

NTM = "ntm"  # the paper's own models (ProdLDA)


@dataclass(frozen=True)
class ModelConfig:
    """ProdLDA sizing (the NTM fields of the reference ``ModelConfig``)."""

    name: str = "unnamed"
    kind: str = NTM
    vocab_size: int = 1024
    num_topics: int = 50
    ntm_hidden: Tuple[int, ...] = (100, 100)
    learn_priors: bool = True


@dataclass(frozen=True)
class FederatedConfig:
    """gFedNTM protocol knobs the service reads."""

    num_clients: int = 5
    learning_rate: float = 2e-3     # lambda in Eq. (3)


@dataclass(frozen=True)
class RoundConfig:
    """Scenario knobs the service's engine reads: local epochs and the
    server optimizer (reference ``RoundConfig``)."""

    local_epochs: int = 1
    local_epochs_by_client: Tuple[int, ...] = ()
    server_optimizer: str = "fedavg"
    server_lr: float = 1.0
    server_momentum: float = 0.9    # FedAvgM beta / FedAdam b1
    server_beta2: float = 0.999     # FedAdam b2
    server_eps: float = 1e-3        # FedAdam tau
