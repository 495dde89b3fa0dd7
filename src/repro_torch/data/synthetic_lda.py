"""Synthetic corpus generation per the paper's §4.1 experimental setup.

numpy only, and the same draws in the same order as the reference
(``repro/data/synthetic_lda.py``), so one seed gives a bitwise-equal
corpus in both packages:

    beta_k  ~ Dirichlet(eta)          per-topic word distribution (K x V)
    theta_d ~ Dirichlet(alpha)        per-document topic mixture
    n_d     ~ U[len_min, len_max]     document length
    w_di    ~ Mult(sum_k theta_dk beta_k)

K' topics are shared by all nodes and (K - K')/L are private to each.
Paper defaults: V=5000, K=50, L=5, alpha=50/K, 10 000 train + 1 000
validation docs per node, lengths U[150, 250].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class SyntheticLDA:
    """Ground truth + per-node corpora for one synthetic scenario."""

    beta: np.ndarray                 # (K, V) true topic-word dists
    node_thetas: List[np.ndarray]    # per node: (D_l, K) true doc mixtures
    node_bows: List[np.ndarray]      # per node: (D_l, V) float32 BoW counts
    node_val_thetas: List[np.ndarray]
    node_val_bows: List[np.ndarray]
    node_topics: List[np.ndarray]    # per node: visible topic ids
    shared_topics: np.ndarray        # the K' shared topic ids
    alpha: float
    eta: float

    def concat_bows(self) -> np.ndarray:
        return np.concatenate(self.node_bows, axis=0)

    def concat_val_bows(self) -> np.ndarray:
        return np.concatenate(self.node_val_bows, axis=0)


def make_federated_topic_split(num_topics: int, shared: int, num_nodes: int,
                               rng: np.random.Generator):
    """Assign K' shared + (K-K')/L private topics per node (paper §4.1)."""
    assert shared <= num_topics
    perm = rng.permutation(num_topics)
    shared_ids = perm[:shared]
    rest = perm[shared:]
    per_node = len(rest) // num_nodes
    node_topics = []
    for l in range(num_nodes):
        priv = rest[l * per_node:(l + 1) * per_node]
        node_topics.append(np.sort(np.concatenate([shared_ids, priv])))
    return np.sort(shared_ids), node_topics


def _sample_docs(beta, topic_ids, alpha, n_docs, len_range, rng):
    k_total, v = beta.shape
    thetas = np.zeros((n_docs, k_total), np.float64)
    thetas[:, topic_ids] = rng.dirichlet(np.full(len(topic_ids), alpha),
                                         size=n_docs)
    word_dists = thetas @ beta                       # (D, V)
    word_dists /= word_dists.sum(axis=1, keepdims=True)
    lengths = rng.integers(len_range[0], len_range[1] + 1, size=n_docs)
    bows = np.zeros((n_docs, v), np.float32)
    for d in range(n_docs):
        bows[d] = rng.multinomial(lengths[d], word_dists[d])
    return thetas.astype(np.float32), bows


def generate_lda_corpus(
    *,
    vocab_size: int = 5000,
    num_topics: int = 50,
    num_nodes: int = 5,
    shared_topics: int = 10,
    eta: float = 0.01,
    alpha: Optional[float] = None,
    docs_per_node: int = 10_000,
    val_docs_per_node: int = 1_000,
    len_range: Tuple[int, int] = (150, 250),
    seed: int = 0,
) -> SyntheticLDA:
    """Generate the paper's synthetic federation (settings A and B)."""
    rng = np.random.default_rng(seed)
    if alpha is None:
        alpha = 50.0 / num_topics               # paper: alpha = 50/K
    beta = rng.dirichlet(np.full(vocab_size, eta), size=num_topics)
    shared_ids, node_topics = make_federated_topic_split(
        num_topics, shared_topics, num_nodes, rng)

    node_thetas, node_bows = [], []
    node_val_thetas, node_val_bows = [], []
    for tids in node_topics:
        th, bw = _sample_docs(beta, tids, alpha, docs_per_node, len_range, rng)
        vth, vbw = _sample_docs(beta, tids, alpha, val_docs_per_node,
                                len_range, rng)
        node_thetas.append(th)
        node_bows.append(bw)
        node_val_thetas.append(vth)
        node_val_bows.append(vbw)

    return SyntheticLDA(
        beta=beta.astype(np.float32),
        node_thetas=node_thetas, node_bows=node_bows,
        node_val_thetas=node_val_thetas, node_val_bows=node_val_bows,
        node_topics=node_topics, shared_topics=shared_ids,
        alpha=alpha, eta=eta)
