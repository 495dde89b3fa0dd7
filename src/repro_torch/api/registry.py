"""Named scenario registry: one name -> one `FederationSpec`.

The port's entries of ``repro/api/registry.py``, with the reference's
override dicts: the paper regime (Algorithm 1 on the host loop, the
all-defaults spec), the synchronous scenario cells, the partition cells,
the straggler cells (host pending list; under
``execution.exec_mode="vmap"`` they raise, ROADMAP.md A10), the
transform cells (on the host loop under the default base, or on the
batched cohort path under a vmap base), the kernel cells, the two
federated LM presets and the two buffered-async service presets.  An
entry is an override dict or a callable ``(base) -> overrides`` for
knobs sized to the base (``dropout-join``).  The ``mesh-*`` cells (A17),
``straggler_ring`` (A10) and the wire preset (A14) join as their slices
land (ROADMAP.md §A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Union

from repro_torch.api.spec import FederationSpec, spec_replace

Overrides = Union[Mapping[str, Any],
                  Callable[[FederationSpec], Mapping[str, Any]]]

# dp clip/noise sized for DELTA messages (magnitude ~ lr * |G|)
_DP_KNOBS = {"transforms.dp_noise_multiplier": 0.3,
             "transforms.dp_clip_norm": 0.05}
_STRAGGLER_KNOBS = {"schedule.straggler_prob": 0.3,
                    "schedule.max_staleness": 3,
                    "schedule.staleness_decay": 0.5}
_DIRICHLET = {"data.partition": "dirichlet(0.3)"}
# CPU-scale federated LM fine-tune (phi3 family over its reduced()
# config); client lr sized for SGD on token cross-entropy
_LM_BASE = {"model.family": "lm", "model.arch": "phi3-mini-3.8b",
            # reset the NTM-only shape fields so the scenario rebases
            # cleanly over any caller-sized NTM base spec
            "model.topics": 10, "model.hidden": 64,
            "model.vocab": 256, "model.seq_len": 32,
            "data.num_clients": 4, "data.docs_per_node": 96,
            "data.val_docs_per_node": 24,
            "schedule.rounds": 20, "execution.batch_size": 8,
            "execution.learning_rate": 0.1}


def _dropout_join(base: FederationSpec) -> Dict[str, Any]:
    """One late joiner and one early leaver, sized to the base
    federation (the reference's tuples)."""
    k, r = base.data.num_clients, base.schedule.rounds
    return {"schedule.client_join_round": (0,) * (k - 1) + (2,),
            "schedule.client_leave_round": (0,) * (k - 1)
            + (max(r - 1, 1),)}


SCENARIOS: Dict[str, Overrides] = {
    # the paper regime: all defaults (topic partition, K = L, E = 1,
    # synchronous, FedAvg(server_lr=1) == Eq. (3) server SGD)
    "paper": {},
    # ---- the reference's scenario-bench cells the port runs ------------
    "sync": {},
    "straggler": dict(_STRAGGLER_KNOBS),
    "straggler-heavy": {"schedule.straggler_prob": 0.6,
                        "schedule.max_staleness": 3,
                        "schedule.staleness_decay": 0.25},
    "dirichlet-noniid": dict(_DIRICHLET),
    "quantity-skew": {"data.partition": "quantity_skew(0.5)"},
    "hetero-epochs": {"schedule.local_epochs_by_client": (1, 2, 4)},
    "dropout-join": _dropout_join,
    "dp-transform": {"transforms.names": ("dp",), **_DP_KNOBS},
    "topk-transform": {"transforms.names": ("topk",),
                       "transforms.compression_topk": 0.25},
    "secure-transform": {"transforms.names": ("secure",)},
    "dp-straggler": {"transforms.names": ("dp",), **_DP_KNOBS,
                     **_STRAGGLER_KNOBS},
    # bf16 wire format (never composes with 'secure' — the spec refuses)
    "precision-transform": {"transforms.names": ("precision",),
                            "transforms.precision": "bf16"},
    # ---- kernel cells: the batched cohort path through B2, B4, B3 -------
    "pallas-aggregate": {"execution.exec_mode": "vmap",
                         "execution.kernel_backend": "pallas"},
    "pallas-topk": {"transforms.names": ("topk",),
                    "transforms.compression_topk": 0.25,
                    "execution.exec_mode": "vmap",
                    "execution.kernel_backend": "pallas"},
    "pallas-secure": {"transforms.names": ("secure",),
                      "execution.exec_mode": "vmap",
                      "execution.kernel_backend": "pallas"},
    # label-skewed + local-DP messages on the batched cohort path
    "private_vmap": {**_DIRICHLET, "transforms.names": ("dp",),
                     **_DP_KNOBS, "execution.exec_mode": "vmap"},
    # alias of dirichlet-noniid under the related-work spelling
    "dirichlet_niid": dict(_DIRICHLET),
    # ---- federated LM presets -----------------------------------------
    # a registry LM fine-tuned under the same scenario machinery as the
    # topic models
    "lm_fedavg": dict(_LM_BASE),
    # label-skewed token windows + top-k compressed deltas on the batched
    # cohort path
    "lm_dirichlet_topk": {**_LM_BASE, **_DIRICHLET,
                          "transforms.names": ("topk",),
                          "transforms.compression_topk": 0.25,
                          "execution.exec_mode": "vmap"},
    # FedBuff-style: aggregate every M=2 arrivals, staleness window 2,
    # polynomial delta discount
    "buffered_async": {"schedule.mode": "buffered_async",
                       "schedule.buffer_size": 2,
                       "schedule.max_staleness": 2,
                       "schedule.staleness_policy": "polynomial",
                       "execution.exec_mode": "loop"},
    # the sync-equivalence anchor regime: M = K, staleness window 0
    "buffered_async_eq": {"schedule.mode": "buffered_async",
                          "schedule.max_staleness": 0,
                          "execution.exec_mode": "loop"},
}


# the reference's scenario-bench sweep, in sweep order, without its four
# mesh-* cells (the mesh layer, ROADMAP.md A17)
BENCH_SCENARIOS = ("sync", "straggler", "straggler-heavy",
                   "dirichlet-noniid", "quantity-skew", "hetero-epochs",
                   "dropout-join", "dp-transform", "topk-transform",
                   "secure-transform", "dp-straggler",
                   "precision-transform", "pallas-aggregate",
                   "pallas-topk", "pallas-secure")


def scenario_names() -> list:
    return sorted(SCENARIOS)


def scenario_spec(name: str,
                  base: Optional[FederationSpec] = None) -> FederationSpec:
    """Build the named scenario's spec over ``base`` (default: the
    paper-sized all-defaults spec); unknown names raise ``ValueError``."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; known: "
                         f"{scenario_names()}")
    base = base if base is not None else FederationSpec()
    ov = SCENARIOS[name]
    if callable(ov):
        ov = ov(base)
    return dataclasses.replace(spec_replace(base, ov), name=name)


def register_scenario(name: str, overrides: Overrides, *,
                      overwrite: bool = False) -> None:
    """Add a scenario at runtime (sweep scripts, notebooks, tests); an
    existing name is replaced only with ``overwrite=True``."""
    if name in SCENARIOS and not overwrite:
        raise ValueError(f"scenario {name!r} already registered; pass "
                         "overwrite=True to replace it")
    SCENARIOS[name] = overrides
