"""Stage 1 of gFedNTM: vocabulary consensus (paper Alg. 1, lines 1-6).

The port's own numpy copy of ``repro/core/vocab.py``.  Each client
computes a local vocabulary ``V_l`` (term -> occurrence count) and sends
it to the server, never its documents.  The server merges them into the
global vocabulary ``V`` — the union of all terms with summed
frequencies — and broadcasts it back, so every client re-indexes its BoW
matrix into the shared coordinates that fix the global model's shapes.
Merging is a commutative monoid, so the consensus does not depend on the
order in which vocabularies arrive.  For LM clients the same machinery
merges token vocabularies (:func:`consensus_token_map`).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np


@dataclass
class Vocabulary:
    """term -> weighted frequency, with a stable integer indexing."""

    counts: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def from_documents(cls, docs: Iterable[Sequence[str]]) -> "Vocabulary":
        c: Counter = Counter()
        for doc in docs:
            c.update(doc)
        return cls(dict(c))

    @classmethod
    def from_bow(cls, bow: np.ndarray, terms: Sequence[str]) -> "Vocabulary":
        tot = np.asarray(bow).sum(axis=0)
        return cls({t: float(tot[i]) for i, t in enumerate(terms)
                    if tot[i] > 0})

    def __len__(self) -> int:
        return len(self.counts)

    @property
    def terms(self) -> List[str]:
        """Deterministic ordering: by descending frequency, ties lexicographic."""
        return [t for t, _ in sorted(self.counts.items(),
                                     key=lambda kv: (-kv[1], kv[0]))]

    def index(self) -> Dict[str, int]:
        return {t: i for i, t in enumerate(self.terms)}


def merge_vocabularies(vocabs: Sequence[Vocabulary]) -> Vocabulary:
    """Server-side merge (Alg. 1 line 4): union with summed frequencies."""
    total: Dict[str, float] = {}
    for v in vocabs:
        for t, c in v.counts.items():
            total[t] = total.get(t, 0.0) + c
    return Vocabulary(total)


def reindex_bow(bow: np.ndarray, local_terms: Sequence[str],
                global_vocab: Vocabulary) -> np.ndarray:
    """Project a client's (D, V_l) BoW into global (D, V) coordinates."""
    gidx = global_vocab.index()
    out = np.zeros((bow.shape[0], len(global_vocab)), bow.dtype)
    for j, t in enumerate(local_terms):
        if t in gidx:
            out[:, gidx[t]] += bow[:, j]
    return out


def consensus_token_map(client_token_sets: Sequence[Mapping[int, float]],
                        ) -> Tuple[Dict[int, int], List[np.ndarray]]:
    """Token-vocabulary consensus for LM clients.

    Each client reports {token_id: count} over its private corpus.  Returns
    the global id remapping (old global token id -> dense consensus id,
    frequency-sorted) plus per-client lookup tables usable with
    ``np.take`` to re-index token streams.
    """
    merged = merge_vocabularies(
        [Vocabulary({str(k): float(v) for k, v in s.items()})
         for s in client_token_sets])
    global_map = {int(t): i for i, t in enumerate(merged.terms)}
    tables = []
    for s in client_token_sets:
        max_id = max(s) if s else 0
        table = np.full(max_id + 1, -1, np.int64)
        for tok in s:
            table[tok] = global_map[int(tok)]
        tables.append(table)
    return global_map, tables
