"""Partition-spec parsing and the per-client minibatch draws.

The port serves the paper's ``topic`` split (each node keeps its own
corpus, ``api/federation.py:build_clients``); the other registry
partitioners of the reference (``iid``, ``dirichlet``,
``quantity_skew``) are parsed here so specs validate identically, and
refused at build time until their slice (ROADMAP A2).

Minibatch draws: the reference draws ``jax.random.choice(replace=False)``
from a threefry key ``fold_in(PRNGKey(seed * 100003 + t), client)``.  The
port draws ``torch.randperm`` from a CPU ``torch.Generator`` seeded from
the same schedule ``(seed * 100003 + t, client, epoch)`` — the same
documents when the draw is the whole corpus (``batch_size >= num_docs``,
the parity setting), the same distribution otherwise, and the same
indices on a CPU and a GPU run.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

PARTITIONERS = ("iid", "by_label", "topic", "dirichlet", "quantity_skew")
# partitioners that accept an '(alpha)' argument; every other name must
# appear bare — 'iid(0.3)' is a user error, not a silently-ignored knob
_PARAMETRIC = frozenset({"dirichlet", "quantity_skew"})
_SPEC_RE = re.compile(r"^\s*([a-z_]+)\s*(?:\(\s*(.*?)\s*\))?\s*$")


def parse_partition_spec(spec: str) -> Tuple[str, Dict[str, float]]:
    """``"dirichlet(0.3)"`` -> ``("dirichlet", {"alpha": 0.3})``; the
    reference's parser, with its error messages."""
    m = _SPEC_RE.match(spec or "")
    if not m or m.group(1) not in PARTITIONERS:
        raise ValueError(f"unknown partition spec {spec!r}; known: "
                         f"{sorted(set(PARTITIONERS))} "
                         "(optionally with '(alpha)')")
    name, arg = m.group(1), m.group(2)
    if arg is None:
        return name, {}
    if name not in _PARAMETRIC:
        raise ValueError(f"partition spec {spec!r}: {name!r} takes no "
                         "argument — drop the parentheses")
    if arg == "":
        raise ValueError(f"partition spec {spec!r} has empty parentheses "
                         f"— give an explicit alpha, e.g. '{name}(0.3)', "
                         "or drop the parentheses for the default")
    try:
        alpha = float(arg)
    except ValueError:
        raise ValueError(f"partition spec {spec!r}: malformed alpha "
                         f"{arg!r} (expected a number, e.g. "
                         f"'{name}(0.3)')") from None
    if not alpha > 0:
        raise ValueError(f"partition spec {spec!r}: alpha must be > 0, "
                         f"got {alpha!r}")
    return name, {"alpha": alpha}


def draw_generator(round_seed: int, client: int,
                   epoch: int) -> torch.Generator:
    """The CPU generator of one (round, client, epoch) draw."""
    state = np.random.SeedSequence(
        [int(round_seed), int(client), int(epoch)]).generate_state(1,
                                                                  np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def sample_minibatch(data: Dict[str, torch.Tensor], num_docs: int,
                     gen: torch.Generator,
                     batch_size: int) -> Tuple[Dict[str, torch.Tensor], int]:
    """One client draw: ``min(batch_size, num_docs)`` docs without
    replacement, gathered on the device the client corpus lives on."""
    n = min(batch_size, num_docs)
    idx = torch.randperm(num_docs, generator=gen)[:n]
    return {k: v[idx.to(v.device)] for k, v in data.items()}, n


def round_minibatches(data: Dict[str, torch.Tensor], num_docs: int,
                      round_seed: int, client: int, *, batch_size: int,
                      local_epochs: int = 1
                      ) -> Iterator[Tuple[Dict[str, torch.Tensor], int]]:
    """Yield the E local-epoch minibatches of one client in one round."""
    for s in range(local_epochs):
        yield sample_minibatch(data, num_docs,
                               draw_generator(round_seed, client, s),
                               batch_size)
