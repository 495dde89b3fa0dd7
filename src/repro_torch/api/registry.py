"""Named scenario registry: one name -> one `FederationSpec`.

The port's entries of ``repro/api/registry.py``, with the reference's
override dicts: the paper regime (Algorithm 1 on the host loop, the
all-defaults spec), the synchronous scenario cells, the two straggler
cells (host pending list; under ``execution.exec_mode="vmap"`` they
raise, ROADMAP.md A10), the kernel cells, and the two buffered-async
service presets.  The transform cells build on a base spec with
``execution.exec_mode="vmap"``; under loop mode they raise (A9).  The
other reference scenarios need non-``topic`` partitions, the mesh or the
LM zoo, and join as their slices land (ROADMAP.md §A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

from repro_torch.api.spec import FederationSpec, spec_replace

# dp clip/noise sized for DELTA messages (magnitude ~ lr * |G|)
_DP_KNOBS = {"transforms.dp_noise_multiplier": 0.3,
             "transforms.dp_clip_norm": 0.05}
_STRAGGLER_KNOBS = {"schedule.straggler_prob": 0.3,
                    "schedule.max_staleness": 3,
                    "schedule.staleness_decay": 0.5}

SCENARIOS: Dict[str, Mapping[str, Any]] = {
    # the paper regime: all defaults (topic partition, K = L, E = 1,
    # synchronous, FedAvg(server_lr=1) == Eq. (3) server SGD)
    "paper": {},
    # ---- the reference's scenario-bench cells the port runs ------------
    "sync": {},
    "straggler": dict(_STRAGGLER_KNOBS),
    "straggler-heavy": {"schedule.straggler_prob": 0.6,
                        "schedule.max_staleness": 3,
                        "schedule.staleness_decay": 0.25},
    "hetero-epochs": {"schedule.local_epochs_by_client": (1, 2, 4)},
    "dp-transform": {"transforms.names": ("dp",), **_DP_KNOBS},
    "topk-transform": {"transforms.names": ("topk",),
                       "transforms.compression_topk": 0.25},
    "secure-transform": {"transforms.names": ("secure",)},
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
    return dataclasses.replace(spec_replace(base, SCENARIOS[name]),
                               name=name)
