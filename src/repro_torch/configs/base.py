"""Engine-level configuration: the fields of the reference's
``configs/base.py`` that the buffered-async service and the synchronous
batched cohort path read.

Same names and defaults as the reference dataclasses.  The fields no
ported path reads (LM architecture, ``local_steps``, the mesh) join with
the slices that read them (ROADMAP.md §A).
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
    """gFedNTM protocol knobs (paper Alg. 1 + the message transforms)."""

    num_clients: int = 5
    learning_rate: float = 2e-3     # lambda in Eq. (3)
    max_rounds: int = 100           # I in Alg. 1
    secure_aggregation: bool = False    # pairwise-mask secure agg simulation
    compression_topk: float = 0.0       # 0 = dense; else fraction kept
    dp_noise_multiplier: float = 0.0    # local DP Gaussian noise
    dp_clip_norm: float = 1.0
    # wire format of client messages for the "precision" transform:
    # "" = fp32, "bf16" = rounded to bfloat16, accumulated in fp32
    message_precision: str = ""
    rel_tol: float = 1e-5               # stopping criterion on weight change


@dataclass(frozen=True)
class RoundConfig:
    """Scenario knobs of the engine (reference ``RoundConfig``): the
    execution path, participation, local epochs, the server optimizer,
    stragglers and the transform stage."""

    exec_mode: str = "loop"         # "vmap": the batched cohort path
    clients_per_round: int = 0      # K of L per round (0 = all L)
    sampling: str = "uniform"       # "uniform" | "weighted" | "deterministic"
    sampling_seed: int = 0
    local_epochs: int = 1
    server_optimizer: str = "fedavg"
    server_lr: float = 1.0
    server_momentum: float = 0.9    # FedAvgM beta / FedAdam b1
    server_beta2: float = 0.999     # FedAdam b2
    server_eps: float = 1e-3        # FedAdam tau
    straggler_prob: float = 0.0
    max_staleness: int = 0
    staleness_decay: float = 0.5
    transforms: Tuple[str, ...] = ()    # core/transforms.py registry names
    # fixed-K cohorts: shrunken cohorts padded with zero-weight rows
    pad_cohorts: bool = True
    local_epochs_by_client: Tuple[int, ...] = ()
    client_join_round: Tuple[int, ...] = ()
    client_leave_round: Tuple[int, ...] = ()
    # kept so specs round-trip; the tensor's device picks kernel or plain
    kernel_backend: str = "xla"
