"""Threefry2x32 keys and draws, bit for bit those of ``jax.random``.

The subset of ``jax.random`` the federated NTM path draws from — the
minibatch indices, the in-batch model keys, the dropout masks and the
reparametrization noise — written once in PyTorch integer ops, so one
key gives the reference's bits on a CPU tensor, on a CUDA tensor and
inside ``torch.func.vmap`` (the loss of every cohort client draws from
its own key, as the reference draws inside ``jax.vmap``).

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words (a
stack of keys has shape ``(..., 2)``).  uint32 arithmetic runs in int64
with a mask after each add and rotate, or on Python ints: the hash takes
either.  The draws (``split``, ``random_bits``, ``uniform``, ``normal``,
``bernoulli``) are tensor ops on the key's device and batch under
``vmap``.  The host-side key schedule (``fold_in``, the round keys of
``permutation``) takes a concrete key and hashes Python ints, which
costs less than one hash of small tensors costs in op dispatch.

The layout is jax 0.9.0's with
its default ``jax_threefry_partitionable=True``: ``split`` and
``random_bits`` hash the 64-bit row-major iota of the output shape (high
word, low word) under the key, ``fold_in(key, d)`` hashes ``(0, d)``,
and 32-bit draws are the xor of the two output words.

``uniform`` and ``bernoulli`` are exact (the mantissa trick of
``jax.random.uniform``); ``normal`` is ``sqrt(2) * erfinv(u)`` on
``uniform(nextafter(-1, 0), 1)``, with XLA's float32 ``erfinv`` (Giles'
polynomials on ``-log1p(-u*u)``), so it equals the reference's up to the
rounding of ``log1p`` (at most a few ulps, ``tests/test_torch_prng.py``).
``choice(replace=False)`` is jax's ``permutation(key, n)[:k]``: its
``_shuffle`` sorts by fresh 32-bit keys ``ceil(3 ln n / ln(2^32 - 1))``
times, stably, so ties resolve as the reference's do.  Constants enter
the ops as Python floats (exact float32 values), so a draw on the card
copies nothing from the host.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word
                 ) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key ``(k1, k2)``: uint32 words as Python ints or int64
    tensors, broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, *, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed passes through
    int64 (outside it, ``OverflowError``), then int32, so the key is
    ``(0, seed mod 2**32)``."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError("Python int too large to convert to C long")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _hash_iota(key: torch.Tensor, shape: Sequence[int]):
    """Threefry of the 64-bit row-major iota of ``shape`` under ``key``
    (a stack of keys ``(..., 2)`` gives ``(...,) + shape``)."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    lead = tuple(key.shape[:-1]) + (1,) * len(shape)
    return threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead),
                        idx >> 32, idx & MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys, ``(num, 2)``; under ``vmap`` too."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """The key folded with the uint32 ``data``: a concrete ``(2,)`` key
    (not under ``vmap``), hashed on the host; the result is on the key's
    device."""
    k1, k2 = key.tolist()
    return torch.tensor(threefry2x32(k1, k2, 0, int(data) & MASK),
                        dtype=torch.int64, device=key.device)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Uniform uint32 words of ``shape`` (int64 values); a stack of keys
    ``(..., 2)`` draws ``(...,) + shape``."""
    b1, b2 = _hash_iota(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform on ``[minval, maxval)``: the top 23 bits as the
    mantissa of a float in [1, 2), less one (exact), scaled and clamped
    as ``jax.random.uniform`` does."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    u = (random_bits(key, shape) >> 9).to(torch.float32) * 2.0 ** -23
    return torch.clamp(u * span + float(lo), min=float(lo))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))
# XLA's float32 erfinv: Giles' polynomials in w - 2.5 (w < 5) and
# sqrt(w) - 3 (w >= 5), w = -log1p(-x*x), highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's evaluation order."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, float(np.float32(a)), float(np.float32(b)))
        p = c if p is None else c + p * w
    return torch.where(torch.abs(x) == 1.0,
                       x * torch.finfo(torch.float32).max, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal float32 draws (the inverse-CDF form of
    ``jax.random.normal``)."""
    return _SQRT2 * _erfinv(uniform(key, shape, _NORMAL_LO, 1.0))


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int]
              ) -> torch.Tensor:
    """Boolean draws that are True with probability ``p`` (float32)."""
    return uniform(key, shape) < float(np.float32(p))


def _shuffle_rounds(n: int) -> int:
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def permutation(key: torch.Tensor, n: int, *, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` of a concrete key: ``arange(n)``
    sorted stably by fresh uint32 keys, :func:`_shuffle_rounds` times.
    The rounds' keys (``key, sub = split(key)``) are hashed on the host,
    the sort keys of all rounds in one hash on ``device`` (default: the
    key's), where the result lies."""
    dev = key.device if device is None else torch.device(device)
    k1, k2 = key.tolist()
    subs = []
    for _ in range(_shuffle_rounds(n)):
        subs.append(threefry2x32(k1, k2, 0, 1))
        k1, k2 = threefry2x32(k1, k2, 0, 0)
    x = torch.arange(n, dtype=torch.int64, device=dev)
    if subs:
        bits = random_bits(torch.tensor(subs, dtype=torch.int64,
                                        device=dev), (n,))
        for r in range(len(subs)):
            x = x[torch.sort(bits[r], stable=True).indices]
    return x


def choice(key: torch.Tensor, n: int, k: int, *, device=None
           ) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)``: the first
    ``k`` of :func:`permutation`, on ``device`` (default: the key's)."""
    if k > n:
        raise ValueError(f"Cannot take a larger sample (size {k}) than "
                         f"population (size {n}) when 'replace=False'")
    if k == 0:
        dev = key.device if device is None else device
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    return permutation(key, n, device=device)[:k]
