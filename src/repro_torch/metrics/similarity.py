"""The paper's quantitative metrics: DSS (Eq. 5) and TSS (Eq. 6).

Both are built on the Hellinger affinity between distributions
    w_ij = 1 - H^2(p, q) = sum_k sqrt(p_k q_k)         (Eq. 4)

DSS — document similarity-based score: mean absolute difference between
the true and inferred pairwise document-similarity matrices (lower is
better).  TSS — topic similarity score: each true topic matched to its
closest inferred topic, affinities summed (closer to K is better).  In
fp32, as the reference's ``repro/metrics/similarity.py`` computes them,
on the device of the tensors given (numpy arrays: the CPU).
"""
from __future__ import annotations

import numpy as np
import torch


def hellinger_affinity(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Pairwise 1 - H^2: p (A, K), q (B, K) -> (A, B)."""
    return torch.sqrt(torch.clamp(p, min=0)) @ \
        torch.sqrt(torch.clamp(q, min=0)).T


def dss(theta_true, theta_inferred, *, block: int = 2048) -> float:
    """Eq. (5), over row blocks of ``block`` documents so the paper-scale
    5000 x 5000 case needs no full similarity matrix; the diagonal
    (j == i) is left out.  Block sums are added in float64."""
    tt = torch.as_tensor(theta_true, dtype=torch.float32)
    ti = torch.as_tensor(theta_inferred, dtype=torch.float32,
                         device=tt.device)
    st_true = torch.sqrt(torch.clamp(tt, min=0))
    st_inf = torch.sqrt(torch.clamp(ti, min=0))
    d_docs = tt.shape[0]
    sums = []
    for i0 in range(0, d_docs, block):
        d = torch.abs(st_true[i0:i0 + block] @ st_true.T
                      - st_inf[i0:i0 + block] @ st_inf.T)
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, rows + i0] = 0.0
        sums.append(torch.sum(d))
    return float(torch.stack(sums).double().sum()) / d_docs


def tss(beta_true, beta_inferred) -> float:
    """Eq. (6): sum over true topics of the best inferred-topic affinity."""
    bt = torch.as_tensor(beta_true, dtype=torch.float32)
    bi = torch.as_tensor(beta_inferred, dtype=torch.float32,
                         device=bt.device)
    return float(torch.sum(torch.max(hellinger_affinity(bt, bi), dim=1)
                           .values))


def tss_baseline(vocab_size: int, num_topics: int, eta: float,
                 *, runs: int = 5, seed: int = 0) -> float:
    """The paper's TSS baseline: expected TSS between two independent
    models drawn from the same Dirichlet(eta) prior (numpy draws, the
    reference's)."""
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(runs):
        a = rng.dirichlet(np.full(vocab_size, eta), size=num_topics)
        b = rng.dirichlet(np.full(vocab_size, eta), size=num_topics)
        vals.append(tss(a, b))
    return float(np.mean(vals))
