"""Word Mover's Distance and the paper's AMWMD (Eq. 7), numpy.

The port's own copy of ``repro/metrics/wmd.py``, line for line, so both
packages score the same topics with the same numbers.  WMD [Kusner et
al. 2015] is the earth-mover distance between two weighted word sets
(here topic descriptions, a topic's top words) in a word-embedding
space, solved by entropic optimal transport with an annealed epsilon —
near-exact at the paper's sizes (top-10..25 words).

    AMWMD^(l,eval) = sum_k min_k' WMD(TD_k^(l), TD_k'^(eval))   (Eq. 7)
"""
from __future__ import annotations

import numpy as np


def _sinkhorn_emd(a, b, cost, *, n_iter: int = 500) -> float:
    """Entropic OT with an annealed epsilon; near-exact for small problems.

    Costs are normalized to [0, 1] before exponentiation and each anneal
    level is accepted only if the transport plan still sums to 1 (smaller
    eps underflows exp(-c/eps) to an all-zero kernel) — the smallest
    numerically-valid eps gives the tightest approximation to exact EMD.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = a / a.sum()
    b = b / b.sum()
    cmax = float(cost.max())
    if cmax <= 0.0:
        return 0.0
    costn = cost / cmax
    best = None
    for eps in (0.1, 0.02, 0.005):
        k_mat = np.exp(-costn / eps)
        u = np.ones_like(a)
        v = np.ones_like(b)
        for _ in range(n_iter):
            u_new = a / np.maximum(k_mat @ v, 1e-300)
            v = b / np.maximum(k_mat.T @ u_new, 1e-300)
            if np.max(np.abs(u_new - u)) < 1e-12:
                u = u_new
                break
            u = u_new
        plan = u[:, None] * k_mat * v[None, :]
        if abs(plan.sum() - 1.0) > 1e-3:
            break   # underflow — keep the previous (valid) level
        best = float(np.sum(plan * costn)) * cmax
    return best if best is not None else 0.0


def wmd(weights_a: np.ndarray, emb_a: np.ndarray,
        weights_b: np.ndarray, emb_b: np.ndarray) -> float:
    """WMD between two weighted word sets (weights, embeddings)."""
    diff = emb_a[:, None, :] - emb_b[None, :, :]
    cost = np.sqrt(np.maximum(np.sum(diff * diff, axis=-1), 0.0))
    return _sinkhorn_emd(weights_a, weights_b, cost)


def topic_descriptions(beta: np.ndarray, top_n: int = 10):
    """Topic -> (word ids, normalized weights) of its top-n words."""
    out = []
    for k in range(beta.shape[0]):
        ids = np.argsort(beta[k])[::-1][:top_n]
        w = beta[k, ids]
        out.append((ids, w / w.sum()))
    return out


def amwmd(beta_ref: np.ndarray, beta_eval: np.ndarray,
          embeddings: np.ndarray, *, top_n: int = 10) -> float:
    """Eq. (7): sum over reference topics of the min WMD to any eval
    topic; ``embeddings`` (V, dim) is the word-embedding table."""
    ref_td = topic_descriptions(beta_ref, top_n)
    ev_td = topic_descriptions(beta_eval, top_n)
    total = 0.0
    for ids_r, w_r in ref_td:
        best = np.inf
        for ids_e, w_e in ev_td:
            d = wmd(w_r, embeddings[ids_r], w_e, embeddings[ids_e])
            best = min(best, d)
        total += best
    return float(total)
