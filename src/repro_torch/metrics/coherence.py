"""NPMI topic coherence and topic diversity (numpy), as the reference's
``repro/metrics/coherence.py`` computes them."""
from __future__ import annotations

import numpy as np


def npmi_coherence(beta: np.ndarray, bows: np.ndarray, top_n: int = 10,
                   eps: float = 1e-12) -> float:
    """Mean pairwise NPMI of each topic's top-n words over a corpus."""
    docs_bin = (bows > 0).astype(np.float64)          # (D, V)
    d_total = docs_bin.shape[0]
    p_w = docs_bin.mean(axis=0)                       # (V,)
    scores = []
    for k in range(beta.shape[0]):
        ids = np.argsort(beta[k])[::-1][:top_n]
        sub = docs_bin[:, ids]                        # (D, n)
        co = (sub.T @ sub) / d_total                  # (n, n) joint probs
        vals = []
        for i in range(len(ids)):
            for j in range(i + 1, len(ids)):
                p_ij = co[i, j]
                if p_ij <= 0:
                    vals.append(-1.0)
                    continue
                pmi = np.log(p_ij / (p_w[ids[i]] * p_w[ids[j]] + eps) + eps)
                vals.append(pmi / (-np.log(p_ij + eps)))
        scores.append(np.mean(vals) if vals else 0.0)
    return float(np.mean(scores))


def topic_diversity(beta: np.ndarray, top_n: int = 25) -> float:
    """Fraction of unique words among all topics' top-n words."""
    tops = [tuple(np.argsort(beta[k])[::-1][:top_n])
            for k in range(beta.shape[0])]
    flat = [w for t in tops for w in t]
    return len(set(flat)) / max(len(flat), 1)
