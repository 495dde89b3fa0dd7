"""Synthetic token pipeline for the port's LM families.

numpy only, and the same draws in the same order as the reference
(``repro/data/lm_data.py``), so one seed gives bitwise-equal batches and
corpora in both packages: Zipfian token marginals, per-client shifted
token windows (the paper's "topic diversity across nodes"), and loss
masks; audio batches carry stub frame embeddings, masked frames and
their cluster targets, VLM batches stub patch embeddings, their
positions and the M-RoPE streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.configs.base import AUDIO, VLM, ModelConfig


def _zipf_tokens(rng, vocab: int, shape, a: float = 1.2, lo: int = 0,
                 hi: Optional[int] = None) -> np.ndarray:
    hi = hi or vocab
    ranks = np.arange(1, hi - lo + 1, dtype=np.float64)
    p = ranks ** -a
    p /= p.sum()
    return (rng.choice(hi - lo, size=shape, p=p) + lo).astype(np.int32)


def synthetic_lm_batch(cfg: ModelConfig, batch: int, seq: int, *,
                       seed: int = 0, client_id: int = 0,
                       num_clients: int = 1) -> Dict[str, np.ndarray]:
    """One training batch (``tokens``, next-token ``labels``,
    ``loss_mask``).  Clients draw from overlapping-but-shifted Zipf
    token windows, the non-IID across-client structure of the federated
    experiments.  Audio: ``frame_embeds``, a HuBERT-style 8% ``frame_mask``
    and Zipf ``targets``; VLM adds ``patch_embeds`` (one patch per 16
    tokens), distinct ``patch_positions`` in the first half and the
    text-ramp ``mrope_positions`` (3, B, S)."""
    rng = np.random.default_rng(seed * 1009 + client_id)
    if cfg.kind == AUDIO:
        frames = rng.standard_normal(
            (batch, seq, cfg.frontend_embed_dim)).astype(np.float32)
        mask = rng.random((batch, seq)) < 0.08
        targets = _zipf_tokens(rng, cfg.vocab_size, (batch, seq))
        return {"frame_embeds": frames, "frame_mask": mask,
                "targets": targets}
    span = cfg.vocab_size
    lo = (client_id * span) // max(2 * num_clients, 1)
    hi = min(span, lo + max(span // 2, 1024))
    toks = _zipf_tokens(rng, cfg.vocab_size, (batch, seq + 1), lo=lo, hi=hi)
    out = {"tokens": toks[:, :-1],
           "labels": toks[:, 1:],
           "loss_mask": np.ones((batch, seq), np.float32)}
    if cfg.kind == VLM:
        n_patch = max(seq // 16, 1)
        out["patch_embeds"] = rng.standard_normal(
            (batch, n_patch, cfg.d_model)).astype(np.float32)
        out["patch_positions"] = np.stack(
            [rng.choice(seq // 2, size=n_patch, replace=False)
             for _ in range(batch)]).astype(np.int32)
        out["mrope_positions"] = np.broadcast_to(
            np.arange(seq, dtype=np.int32), (3, batch, seq)).copy()
    return out


@dataclass
class LMCorpus:
    """A per-node federated token corpus: ``node_tokens[l]`` is node
    ``l``'s ``(docs_per_node, seq_len + 1)`` int32 documents (inputs
    ``[:-1]``, next-token labels ``[1:]``); ``val_tokens`` pools every
    node's held-out documents."""
    node_tokens: List[np.ndarray]
    val_tokens: np.ndarray
    vocab_size: int
    seq_len: int

    @property
    def num_nodes(self) -> int:
        return len(self.node_tokens)

    def concat_tokens(self) -> np.ndarray:
        return np.concatenate(self.node_tokens)


def lm_client_data(tokens: np.ndarray) -> Dict[str, np.ndarray]:
    """A document array -> the per-client training dict
    (``tokens``/``labels``/``loss_mask`` rows)."""
    return {"tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
            "loss_mask": np.ones(tokens[:, 1:].shape, np.float32)}


def generate_lm_corpus(vocab_size: int, num_nodes: int, docs_per_node: int,
                       seq_len: int, *, val_docs_per_node: int = 0,
                       seed: int = 0) -> LMCorpus:
    """Deterministic federated token corpus: each node draws from the
    shifted Zipf window :func:`synthetic_lm_batch` uses."""
    node_tokens, val = [], []
    span = vocab_size
    for node in range(num_nodes):
        rng = np.random.default_rng([seed, node])
        lo = (node * span) // max(2 * num_nodes, 1)
        hi = min(span, lo + max(span // 2, 2))
        t = _zipf_tokens(rng, vocab_size,
                         (docs_per_node + val_docs_per_node, seq_len + 1),
                         lo=lo, hi=hi)
        node_tokens.append(t[:docs_per_node])
        val.append(t[docs_per_node:])
    return LMCorpus(node_tokens=node_tokens,
                    val_tokens=np.concatenate(val),
                    vocab_size=vocab_size, seq_len=seq_len)


class SyntheticLMStream:
    """Iterator over batches of ``num_clients`` client parts, concatenated
    along the batch axis (the launcher's data source)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 num_clients: int = 1, seed: int = 0):
        if batch % num_clients:
            raise ValueError(f"batch {batch} is not a multiple of "
                             f"num_clients {num_clients}")
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.num_clients, self.seed = num_clients, seed
        self._step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        per = self.batch // self.num_clients
        parts = [synthetic_lm_batch(self.cfg, per, self.seq,
                                    seed=self.seed + self._step,
                                    client_id=c, num_clients=self.num_clients)
                 for c in range(self.num_clients)]
        self._step += 1
        return {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}
