"""The port's threefry (``repro_torch/core/prng.py``) against jax.random.

The installed jax 0.9.0 with its default ``jax_threefry_partitionable``
is the oracle.  Keys, ``split``/``fold_in``, raw bits, uniforms,
Bernoulli masks, ``randint`` draws (the secure masks' grid) and
``choice(replace=False)`` index sets must equal jax's bit for bit;
normals and truncated normals may differ by the rounding of ``log1p`` in
the float32 ``erfinv`` (measured: at most 3 ulps on 2e6 draws, the
bound here is 4).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

SEEDS = [0, 1, 7, 42, 1234, 99991, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 32 + 3,
         -1, -77]
NORMAL_ULPS = 4


def _j(key):
    return np.asarray(key).astype(np.int64)


def test_threefry_partitionable_is_the_oracles_default():
    assert jax.__version__ == "0.9.0"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [2 ** 63 - 1, -2 ** 63])
def test_prngkey_matches(seed):
    assert np.array_equal(prng.PRNGKey(seed).numpy(),
                          _j(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [2 ** 63, 2 ** 64 + 1, -2 ** 63 - 1])
def test_prngkey_outside_int64_raises_as_jax_does(seed):
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(seed)
    with pytest.raises(OverflowError):
        prng.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_match(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for num in (1, 2, 3, 7):
        assert np.array_equal(prng.split(tk, num).numpy(),
                              _j(jax.random.split(jk, num)))
    for data in (0, 1, 2, 5, 100003, 2 ** 31 + 9, 2 ** 32 - 1):
        assert np.array_equal(prng.fold_in(tk, data).numpy(),
                              _j(jax.random.fold_in(jk, data)))
    # chains, as the engine composes them
    jc = jax.random.fold_in(jax.random.split(jk, 3)[2], 4)
    tc = prng.fold_in(prng.split(tk, 3)[2], 4)
    assert np.array_equal(tc.numpy(), _j(jc))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (64, 100),
                                   (2, 3, 4)])
def test_bits_uniform_bernoulli_match(shape):
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        assert np.array_equal(prng.random_bits(tk, shape).numpy(),
                              _j(jax.random.bits(jk, shape, jnp.uint32)))
        ju = np.asarray(jax.random.uniform(jk, shape))
        tu = prng.uniform(tk, shape).numpy()
        assert tu.dtype == np.float32
        assert np.array_equal(tu.view(np.int32), ju.view(np.int32))
        for p in (0.8, 0.5, 0.2):
            assert np.array_equal(prng.bernoulli(tk, p, shape).numpy(),
                                  np.asarray(jax.random.bernoulli(jk, p,
                                                                  shape)))


def test_normal_within_erfinv_rounding():
    worst, exact, total = 0, 0, 0
    for seed in range(10):
        jn = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                          (200_000,)))
        tn = prng.normal(prng.PRNGKey(seed), (200_000,)).numpy()
        ulps = np.abs(jn.view(np.int32).astype(np.int64)
                      - tn.view(np.int32).astype(np.int64))
        worst = max(worst, int(ulps.max()))
        exact += int((ulps == 0).sum())
        total += ulps.size
    print(f"normal: max {worst} ulps, {exact / total:.4f} bitwise equal")
    assert worst <= NORMAL_ULPS
    # small shapes, as the loss draws them
    for shape in ((3, 4), (64, 50)):
        jn = np.asarray(jax.random.normal(jax.random.PRNGKey(3), shape))
        tn = prng.normal(prng.PRNGKey(3), shape).numpy()
        assert np.abs(jn.view(np.int32).astype(np.int64)
                      - tn.view(np.int32).astype(np.int64)).max() \
            <= NORMAL_ULPS


@pytest.mark.parametrize("n", [1, 7, 64, 1000, 10000])
def test_choice_without_replacement_matches(n):
    assert prng._shuffle_rounds(n) == int(
        np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for seed in range(12):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for k in sorted({1, min(n, 16), n // 2 or 1, n}):
            want = np.asarray(jax.random.choice(jk, n, (k,), replace=False))
            assert np.array_equal(prng.choice(tk, n, k).numpy(), want)
    with pytest.raises(ValueError, match="larger sample"):
        prng.choice(prng.PRNGKey(0), n, n + 1)
    assert prng.choice(prng.PRNGKey(0), n, 0).shape == (0,)


def test_permutation_ties_resolve_as_jax():
    """At n = 200 000 the 32-bit sort keys of a shuffle round collide
    (birthday bound: ~4.7 expected pairs a round); a stable sort keeps
    the colliding elements in their current order, as XLA's does."""
    n = 200_000
    key = prng.PRNGKey(5)
    k, collisions = key, 0
    for _ in range(prng._shuffle_rounds(n)):
        k, sub = prng.split(k)
        bits = prng.random_bits(sub, (n,))
        collisions += n - len(torch.unique(bits))
    assert collisions > 0
    assert np.array_equal(prng.permutation(key, n).numpy(),
                          np.asarray(jax.random.permutation(
                              jax.random.PRNGKey(5), n)))


def test_draws_under_vmap_equal_per_key_draws():
    """The shift and bitwise ops batch under ``torch.func.vmap``, so a
    cohort's losses can draw from per-client keys in one call, as the
    reference's draw inside ``jax.vmap``."""
    keys = torch.stack([prng.fold_in(prng.PRNGKey(9), c) for c in range(4)])

    def draws(k):
        d, s = prng.split(k)
        return prng.bernoulli(d, 0.8, (5, 6)), prng.normal(s, (5, 3))

    masks, noise = torch.func.vmap(draws)(keys)
    jkeys = jax.vmap(lambda c: jax.random.fold_in(jax.random.PRNGKey(9),
                                                  c))(jnp.arange(4))
    for c in range(4):
        m, z = draws(keys[c])
        assert torch.equal(masks[c], m) and torch.equal(noise[c], z)
        jd, js = jax.random.split(jkeys[c])
        assert np.array_equal(m.numpy(), np.asarray(
            jax.random.bernoulli(jd, 0.8, (5, 6))))


def _ulps(a, b):
    return np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                  - np.asarray(b).view(np.int32).astype(np.int64))


@pytest.mark.parametrize("bounds", [(-2.0, 2.0), (-1.0, 1.0), (-3.0, 0.5)])
def test_truncated_normal_within_erfinv_rounding(bounds):
    """``dense_init``'s draw: bounds ±2 are the reference's; every draw
    lies strictly inside them, within 4 ulps of jax's."""
    lo, hi = bounds
    worst = 0
    for seed in SEEDS[:6]:
        for shape in ((20_000,), (3, 4), (64, 50), ()):
            want = np.asarray(jax.random.truncated_normal(
                jax.random.PRNGKey(seed), lo, hi, shape, jnp.float32))
            got = prng.truncated_normal(prng.PRNGKey(seed), lo, hi,
                                        shape).numpy()
            assert got.dtype == np.float32 and got.shape == want.shape
            assert (got > lo).all() and (got < hi).all()
            worst = max(worst, int(_ulps(got, want).max()))
    print(f"truncated_normal{bounds}: max {worst} ulps")
    assert worst <= NORMAL_ULPS


@pytest.mark.parametrize("span", [(-(2 ** 10), 2 ** 10 + 1),
                                  (-(2 ** 6), 2 ** 6 + 1), (-2, 3), (0, 1),
                                  (5, 5), (7, 3), (0, 2 ** 31 - 1),
                                  (-(2 ** 31), 2 ** 31 - 1),
                                  (-1000, 123457), (3, 2 ** 20 + 7)])
def test_randint_bitwise(span):
    """``jax.random.randint``'s int32 draws, the secure masks' ``[-2^b,
    2^b]`` grid among the spans, also from a stack of keys."""
    lo, hi = span
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for shape in ((1000,), (3, 7), ()):
            want = np.asarray(jax.random.randint(jk, shape, lo, hi))
            got = prng.randint(tk, shape, lo, hi)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want)
    keys = torch.stack([prng.fold_in(prng.PRNGKey(4), m) for m in range(3)])
    got = prng.randint(keys, (2, 5), lo, hi).numpy()
    for m in range(3):
        want = jax.random.randint(jax.random.fold_in(
            jax.random.PRNGKey(4), m), (2, 5), lo, hi)
        assert np.array_equal(got[m], np.asarray(want))


@pytest.mark.parametrize("draw", ["uniform", "normal", "truncated_normal",
                                  "bernoulli"])
def test_chunked_draws_equal_one_piece_draws(draw, monkeypatch):
    """A draw larger than ``prng._CHUNK`` hashes its flat iota in chunks
    (a full-width embedding's init would otherwise hold ~50 GB of int64
    temporaries): bitwise the one-piece draw, also across a ragged last
    chunk, and jax's bits for the uniform."""
    fns = {"uniform": lambda k, s: prng.uniform(k, s, -0.5, 3.0),
           "normal": prng.normal,
           "truncated_normal": lambda k, s: prng.truncated_normal(
               k, -2.0, 2.0, s),
           "bernoulli": lambda k, s: prng.bernoulli(k, 0.3, s)}
    key, shape = prng.PRNGKey(5), (37, 29)
    whole = fns[draw](key, shape)
    monkeypatch.setattr(prng, "_CHUNK", 100)
    chunked = fns[draw](key, shape)
    assert chunked.shape == whole.shape and chunked.dtype == whole.dtype
    assert torch.equal(chunked, whole)
    if draw == "uniform":
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), shape,
                                             jnp.float32, -0.5, 3.0))
        np.testing.assert_array_equal(chunked.numpy(), want)


@pytest.mark.parametrize("start", [2 ** 32 - 3, 2 ** 32, 5_368_709_120 - 7])
def test_flat_bits_past_two_to_the_32(start):
    """A draw of more than 2^32 entries (one of llama4-maverick's expert
    tensors, 128 x 5120 x 8192 = 5.37 G) hashes the high word of each
    64-bit flat index beside its low word, as jax's ``iota_2x32_shape``
    does: the port's chunk at ``start`` is jax's threefry of those
    counters, computed without the entries before it."""
    from jax._src import prng as jprng
    key = prng.PRNGKey(9)
    got = prng.flat_bits(key, start, start + 1000).numpy()
    idx = np.arange(start, start + 1000, dtype=np.uint64)
    hi, lo = (idx >> 32).astype(np.uint32), (idx & 0xFFFFFFFF).astype(
        np.uint32)
    out = np.asarray(jprng.threefry_2x32(
        jnp.asarray(np.array(key.tolist(), np.uint32)),
        jnp.asarray(np.concatenate([hi, lo]))))
    want = out[:1000] ^ out[1000:]
    assert (hi > 0).any()
    np.testing.assert_array_equal(got, want.astype(np.int64))
