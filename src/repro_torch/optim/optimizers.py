"""Global-norm helpers of the reference's ``optim/optimizers.py``.

The ``dp`` transform clips each client message to a global L2 norm, and
the round engine measures its relative parameter change with the same
norm.  The optimizers themselves (sgd, momentum, adam) join with the
Algorithm-1 slice (ROADMAP.md A5).
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(leaf ** 2))`` in fp32, as a 0-dim
    tensor on the leaves' device."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree.values()))


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[dict, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-12))``;
    returns ``(clipped, norm)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in tree.items()}, norm
