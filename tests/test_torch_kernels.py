"""Port kernels B1/B2: the plain PyTorch versions against the JAX package.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py does; the port's ``ops`` wrappers take their plain
path because every tensor here lies on the CPU.  The CUDA kernels have
no CPU mode: ``tests/test_torch_cuda.py`` holds them against the plain
versions on a card, and ``chip_smoke.py`` at the service's shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fed_aggregate import fed_weighted_sum_pallas
from repro_torch.core import aggregation as tagg
from repro_torch.kernels import _build, fed_aggregate, ops, ref, \
    topic_decoder
from repro_torch.kernels.fed_aggregate import fed_weighted_sum_cuda
from repro_torch.kernels.topic_decoder import topic_decoder_cuda

# the reference's grids (tests/test_kernels.py)
COMBINE_CASES = [
    (5, 300, 4, 128), (1, 7, 8, 128), (8, 128, 8, 128), (13, 1000, 8, 256),
    (3, 129, 2, 64),
]
TOPIC_TAIL_CASES = [
    (130, 8, 1100, 128, 512), (5, 4, 513, 4, 512), (33, 3, 96, 16, 32),
    (2, 2, 17, 2, 16),
]


def _t(a, dtype=torch.float32):
    """A JAX/numpy array as a CPU tensor, value for value (bf16 arrays
    go through fp32, which holds every bf16 value exactly)."""
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _combine_inputs(k, d, rng):
    x = rng.standard_normal((k, d)).astype(np.float32)
    w = rng.uniform(0, 2, k).astype(np.float32)
    w[rng.random(k) < 0.4] = 0.0
    x[w == 0.0] = np.nan          # zero-weight rows may hold garbage
    return x, w


# ---------------------------------------------------------------------------
# B2: Eq. (2) weighted sum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,d,bk,bd", COMBINE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_sum_plain_matches_pallas(k, d, bk, bd, dtype, rng):
    x, w = _combine_inputs(k, d, rng)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xt, wt = _t(xj, tdt), _t(wj)
    total = max(float(w.sum()), 1e-12)
    want = fed_weighted_sum_pallas(xj, wj, block_k=bk, block_d=bd,
                                   interpret=True)
    got = ops.fed_weighted_sum(xt, wt)
    assert got.dtype == torch.float32 and got.shape == (d,)
    print(f"B2 plain vs pallas K={k} D={d} {dtype}: "
          f"{np.nanmax(np.abs(got.numpy() - np.asarray(want))) / total:.3e}")
    np.testing.assert_allclose(got.numpy() / total,
                               np.asarray(want) / total, rtol=0, atol=2e-6)
    np.testing.assert_allclose(ops.fed_weighted_combine(xt, wt).numpy(),
                               np.asarray(jref.fed_combine_ref(xj, wj)),
                               rtol=0, atol=2e-6)


def test_weighted_sum_all_zero_weights_and_empty():
    nan_rows = torch.full((4, 17), float("nan"))
    out = ops.fed_weighted_sum(nan_rows, torch.zeros(4))
    assert torch.equal(out, torch.zeros(17))
    assert torch.equal(ops.fed_weighted_combine(nan_rows, torch.zeros(4)),
                       torch.zeros(17))
    want = fed_weighted_sum_pallas(jnp.zeros((0, 9)), jnp.zeros((0,)),
                                   interpret=True)
    out0 = ops.fed_weighted_sum(torch.zeros(0, 9), torch.zeros(0))
    assert out0.shape == (9,) and torch.equal(out0, _t(want))


def test_weighted_combine_per_leaf_matches_aggregate_stacked(rng):
    """A dict of stacked leaves combines leaf by leaf (the reference's
    per-leaf meaning) and agrees with both packages' aggregate_stacked."""
    tree = {"w": rng.standard_normal((4, 6, 5)).astype(np.float32),
            "b": rng.standard_normal((4, 5)).astype(np.float32)}
    w = np.asarray([3.0, 0.0, 1.0, 2.0], np.float32)
    tree["w"][1] = np.nan
    want = jagg.aggregate_stacked({k: jnp.asarray(v) for k, v in
                                   tree.items()}, jnp.asarray(w))
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    for got in (ops.fed_weighted_combine(tt, torch.from_numpy(w)),
                tagg.aggregate_stacked(tt, w)):
        for key in tree:
            assert got[key].shape == tree[key].shape[1:]
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=2e-6)


# ---------------------------------------------------------------------------
# B1: fused topic decoder (forward)
# ---------------------------------------------------------------------------
def _decoder_inputs(b, k, v, rng, lam=0.2):
    theta = jax.nn.softmax(jnp.asarray(rng.standard_normal((b, k)),
                                       jnp.float32))
    beta = jnp.asarray(rng.standard_normal((k, v)), jnp.float32)
    bow = rng.poisson(lam, (b, v)).astype(np.float32)
    sc = jnp.asarray(rng.uniform(0.5, 1.5, (v,)), jnp.float32)
    return theta, beta, bow, sc


@pytest.mark.parametrize("b,k,v,bb,bv", TOPIC_TAIL_CASES)
def test_topic_decoder_plain_matches_pallas_tails(b, k, v, bb, bv, rng):
    theta, beta, bow, sc = _decoder_inputs(b, k, v, rng)
    want = np.asarray(jops.topic_decoder_loss(
        theta, beta, jnp.asarray(bow), sc, block_b=bb, block_v=bv,
        interpret=True))
    got = ops.topic_decoder_loss(_t(theta), _t(beta), _t(bow), _t(sc))
    scale = max(float(np.max(np.abs(want))), 1.0)
    print(f"B1 plain vs pallas B={b} K={k} V={v}: "
          f"{np.max(np.abs(got.numpy() - want)) / scale:.3e}")
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5)


def test_topic_decoder_zero_bow_rows(rng):
    theta, beta, bow, _ = _decoder_inputs(12, 6, 300, rng, lam=0.3)
    bow[[0, 5, 11]] = 0.0
    want = np.asarray(jops.topic_decoder_loss(
        theta, beta, jnp.asarray(bow), interpret=True, block_b=8,
        block_v=128))
    got = ops.topic_decoder_loss(_t(theta), _t(beta), _t(bow))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy()[[0, 5, 11]], 0.0, atol=1e-6)
    zero = ops.topic_decoder_loss(_t(theta), _t(beta),
                                  torch.zeros(bow.shape))
    np.testing.assert_allclose(zero.numpy(), 0.0, atol=1e-6)


def test_topic_decoder_plain_matches_reference_oracle(rng):
    theta, beta, bow, sc = _decoder_inputs(7, 50, 5000, rng, lam=0.04)
    want = np.asarray(jref.topic_decoder_ref(theta, beta, jnp.asarray(bow),
                                             sc))
    got = ref.topic_decoder_ref(_t(theta), _t(beta), _t(bow), _t(sc))
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch and the wrappers' checks
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_path_and_build_nothing(rng):
    before = (fed_aggregate.launches, topic_decoder.launches,
              dict(_build._LIBS))
    x, w = _combine_inputs(3, 40, rng)
    ops.fed_weighted_combine(torch.from_numpy(x), torch.from_numpy(w))
    theta, beta, bow, sc = _decoder_inputs(3, 4, 50, rng)
    ops.topic_decoder_loss(_t(theta), _t(beta), _t(bow), _t(sc))
    assert (fed_aggregate.launches, topic_decoder.launches,
            dict(_build._LIBS)) == before


@pytest.mark.parametrize("call", ["weighted_sum", "decoder"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """The CUDA wrappers never run a CPU tensor (no quiet fallback)."""
    with pytest.raises(ValueError, match="CUDA"):
        if call == "weighted_sum":
            fed_weighted_sum_cuda(torch.zeros(2, 3), torch.ones(2))
        else:
            topic_decoder_cuda(torch.ones(2, 3), torch.ones(3, 5),
                               torch.ones(2, 5))


def test_kernel_sources_and_build_key():
    """Both kernels are built from sources in the package, keyed on a
    hash of source + flags, for sm_90a."""
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.SOURCES:
        src, so = _build._target(name)
        assert src.exists() and src.suffix == ".cu"
        assert so.parent == _build.BUILD_DIR and name in so.name
        text = src.read_text()
        assert 'extern "C"' in text and "cudaGetLastError" in text
    # B1's first pass: ~4 blocks per SM at the evaluate batch, never more
    # chunks than one pass of threads over the vocabulary
    assert topic_decoder.vocab_chunks(256, 5000, 132) == 9
    assert topic_decoder.vocab_chunks(1, 17, 132) == 1
    assert topic_decoder.vocab_chunks(4096, 5000, 132) == 1
