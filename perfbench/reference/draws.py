"""The round's document draws, worked out from the round's key.

A federated round draws each client's minibatch from a Threefry-2x32
key: the round key is ``PRNGKey(round_seed)``, client ``l``'s key is
``fold_in(round_key, l)``, local epoch 0 draws from that key and epoch
``s > 0`` from ``fold_in(key, s + 1)``; a draw is the first
``min(batch, num_docs)`` entries of ``permutation(key, num_docs)``, the
permutation that ``jax.random.permutation`` gives (a stable sort by
fresh 32-bit words, ``ceil(3 ln n / ln(2^32 - 1))`` times).  Written
here on Python integers, from the published Threefry-2x32 (20 rounds)
and jax's key layout, so that the reference owes nothing to the program
under test.
"""
from __future__ import annotations

import math
from typing import List, Tuple

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: Key, x1: int, x2: int) -> Key:
    """Threefry-2x32 of the counter pair ``(x1, x2)`` under ``key``."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed: int) -> Key:
    """``PRNGKey(seed)`` with 32-bit keys: ``(0, seed mod 2**32)``."""
    return 0, int(seed) & MASK


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key, 0, int(data) & MASK)


def _bits(key: Key, n: int) -> List[int]:
    """``n`` uint32 words: each the xor of the hash of its 64-bit index."""
    out = []
    for i in range(n):
        b1, b2 = threefry2x32(key, i >> 32, i & MASK)
        out.append(b1 ^ b2)
    return out


def permutation(key: Key, n: int) -> List[int]:
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK))
    x = list(range(n))
    for _ in range(rounds):
        sub = threefry2x32(key, 0, 1)
        key = threefry2x32(key, 0, 0)
        bits = _bits(sub, n)
        order = sorted(range(n), key=lambda i: bits[i])   # stable
        x = [x[i] for i in order]
    return x


def client_draws(round_seed: int, client: int, num_docs: int, batch: int,
                 local_epochs: int = 1) -> List[List[int]]:
    """The document indices client ``client`` trains on in each local
    epoch of the round whose seed is ``round_seed``."""
    key = fold_in(prng_key(round_seed), client)
    n = min(batch, num_docs)
    out = []
    for s in range(local_epochs):
        k = key if s == 0 else fold_in(key, s + 1)
        out.append(permutation(k, num_docs)[:n])
    return out
