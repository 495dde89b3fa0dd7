"""Named scenario registry: one name -> one `FederationSpec`.

The port's entries of ``repro/api/registry.py``: the paper regime and the
two buffered-async service presets, with the reference's overrides.  The
other reference scenarios need transforms, stragglers, the vmap path or
the mesh, and join as their slices land (ROADMAP.md §A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

from repro_torch.api.spec import FederationSpec, spec_replace

SCENARIOS: Dict[str, Mapping[str, Any]] = {
    # the paper regime: all defaults (topic partition, K = L, E = 1,
    # synchronous, FedAvg(server_lr=1) == Eq. (3) server SGD)
    "paper": {},
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
