"""The port's threefry (``repro_torch/core/prng.py``) against jax.random.

The installed jax 0.9.0 with its default ``jax_threefry_partitionable``
is the oracle.  Keys, ``split``/``fold_in``, raw bits, uniforms,
Bernoulli masks and ``choice(replace=False)`` index sets must equal
jax's bit for bit; normals may differ by the rounding of ``log1p`` in
the float32 ``erfinv`` (measured: at most 3 ulps on 2e6 draws, the
bound here is 4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

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
