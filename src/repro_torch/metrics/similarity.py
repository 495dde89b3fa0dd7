"""The paper's topic similarity score TSS (Eq. 6) on the Hellinger
affinity ``w_ij = sum_k sqrt(p_k q_k)`` (Eq. 4), in fp32 as the
reference's ``repro/metrics/similarity.py`` computes it.  DSS (Eq. 5)
joins with the paper-experiment slice (ROADMAP A7)."""
from __future__ import annotations

import torch


def hellinger_affinity(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Pairwise 1 - H^2: p (A, K), q (B, K) -> (A, B)."""
    return torch.sqrt(torch.clamp(p, min=0)) @ \
        torch.sqrt(torch.clamp(q, min=0)).T


def tss(beta_true, beta_inferred) -> float:
    """Eq. (6): sum over true topics of the best inferred-topic affinity."""
    bt = torch.as_tensor(beta_true, dtype=torch.float32)
    bi = torch.as_tensor(beta_inferred, dtype=torch.float32,
                         device=bt.device)
    return float(torch.sum(torch.max(hellinger_affinity(bt, bi), dim=1)
                           .values))
