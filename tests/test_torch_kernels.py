"""Port kernels B1-B6: the plain PyTorch versions against the JAX package.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py does; the port's ``ops`` wrappers take their plain
path because every tensor here lies on the CPU.  The CUDA kernels have
no CPU mode: ``tests/test_torch_cuda.py`` holds them against the plain
versions on a card, and ``chip_smoke.py`` at the service's shapes.
"""
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fed_aggregate import (fed_dp_secure_apply_pallas,
                                         fed_topk_ef_pallas,
                                         fed_weighted_sum_pallas)
from repro.models.layers.attention import chunked_attention
from repro.models.layers.mamba2 import ssd_chunked
from repro_torch.core import aggregation as tagg
from repro_torch.kernels import _build, fed_aggregate, flash_attention, \
    ops, ref, ssd_scan, topic_decoder
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.kernels.fed_aggregate import (fed_dp_secure_apply_cuda,
                                               fed_topk_ef_cuda,
                                               fed_weighted_sum_cuda)
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
# B3: dp-noise + secure-mask application
# ---------------------------------------------------------------------------
DP_SCALE = 0.3 * 0.05          # the dp-transform preset's mult * clip


def _dp_inputs(k, d, rng):
    x = rng.standard_normal((k, d)).astype(np.float32)
    noise = rng.standard_normal((k, d)).astype(np.float32)
    masks = (rng.integers(-4096, 4097, (k, d)) * 2.0 ** -10
             ).astype(np.float32)                  # the dyadic grid
    coef = rng.uniform(0.01, 1.0, k).astype(np.float32)
    w = rng.integers(1, 100, k).astype(np.float32)
    w[-1] = 0.0                                    # max(w, 1e-9) guard
    return x, noise, masks, coef, w


def _ulps(a, b, *terms):
    """Distance in units in the last place of the largest magnitude among
    the results and the summed terms (an fma skips the rounding of a
    product term, so the drift scales with the terms, not the sum)."""
    mag = np.maximum(np.abs(a), np.abs(b))
    for t in terms:
        mag = np.maximum(mag, np.abs(t))
    return np.max(np.abs(a.astype(np.float64) - b)
                  / np.spacing(mag.astype(np.float32)))


@pytest.mark.parametrize("variant", ["clip", "mask", "noise"])
@pytest.mark.parametrize("k,d", [(k, d) for k in (1, 3, 8)
                                 for d in (1, 129, 300)])
def test_dp_secure_plain_matches_pallas(k, d, variant, rng):
    """Clip-only and mask-only bitwise; the noise term (dp: clip + noise)
    within 2 ulp — the reference's own fma caveat."""
    x, noise, masks, coef, w = _dp_inputs(k, d, rng)
    kw = {"clip": dict(clip_coef=coef), "mask": dict(masks=masks, weights=w),
          "noise": dict(noise=noise, clip_coef=coef)}[variant]
    want = np.asarray(fed_dp_secure_apply_pallas(
        jnp.asarray(x), noise_scale=DP_SCALE, interpret=True,
        **{n: jnp.asarray(v) for n, v in kw.items()}))
    got = ops.fed_dp_secure_apply(
        torch.from_numpy(x), noise_scale=DP_SCALE,
        **{n: torch.from_numpy(v) for n, v in kw.items()}).numpy()
    assert got.dtype == np.float32 and got.shape == (k, d)
    if variant == "noise":
        ulps = _ulps(got, want, x * coef[:, None],
                     np.float32(DP_SCALE) * noise)
        print(f"B3 plain vs pallas K={k} D={d} noise: {ulps:.2f} ulp")
        assert ulps <= 2.0
    else:
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# B4: top-k with error feedback
# ---------------------------------------------------------------------------
def _topk_rows(kind, shape, rng):
    if kind == "gauss":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":                 # a few exact values, many ties
        return (rng.integers(-3, 4, shape) * 0.25).astype(np.float32)
    # bf16 near-ties: values within one bf16 step collapse to one key
    return ((1.0 + rng.integers(0, 8, shape) * 2.0 ** -12)
            * np.sign(rng.standard_normal(shape))).astype(np.float32)


@pytest.mark.parametrize("kind", ["gauss", "ties", "near_ties"])
@pytest.mark.parametrize("frac", [0.01, 0.25, 1.0])
def test_topk_ef_plain_matches_pallas(kind, frac, rng):
    """(L=5) error memory, repeated ids: sent and new_err bitwise."""
    k, d = 6, 300
    msgs = _topk_rows(kind, (k, d), rng)
    err = np.zeros((5, d), np.float32)
    if kind == "gauss":
        err = (0.1 * rng.standard_normal((5, d))).astype(np.float32)
    ids = np.asarray([0, 2, 2, 4, 1, 2], np.int32)
    k_keep = max(int(frac * d), 1)
    want = fed_topk_ef_pallas(jnp.asarray(msgs), jnp.asarray(err),
                              jnp.asarray(ids), k_keep=k_keep,
                              interpret=True)
    got = ref.fed_topk_ef_ref(torch.from_numpy(msgs),
                              torch.from_numpy(err)[torch.from_numpy(ids)
                                                    .long()], k_keep)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.int32),
                              np.asarray(w).view(np.int32))
    assert int((got[0] != 0).sum(1).max()) <= k_keep


def test_topk_ef_segments_match_reference_per_leaf(rng):
    """The port's one call over a flat slab, segment per leaf, against the
    reference's per-leaf ``ops.fed_topk_ef(backend="pallas")`` on the same
    dict tree: bitwise."""
    shapes = {"b": (5,), "c": (40,), "w": (6, 5)}
    k, l_rows, frac = 4, 3, 0.25
    msgs = {n: _topk_rows("ties" if n == "c" else "gauss", (k,) + s, rng)
            for n, s in shapes.items()}
    err = {n: (0.1 * rng.standard_normal((l_rows,) + s)).astype(np.float32)
           for n, s in shapes.items()}
    ids = np.asarray([2, 0, 2, 1], np.int32)
    sent_j, new_j = jops.fed_topk_ef(
        {n: jnp.asarray(v) for n, v in msgs.items()},
        {n: jnp.asarray(v) for n, v in err.items()}, jnp.asarray(ids),
        frac=frac, backend="pallas", interpret=True)
    names = list(shapes)
    segs, off = [], 0
    for n in names:
        size = int(np.prod(shapes[n]))
        segs.append((off, size))
        off += size
    flat = lambda tree, rows: torch.from_numpy(np.concatenate(  # noqa: E731
        [tree[n].reshape(rows, -1) for n in names], axis=1))
    sent, new = ops.fed_topk_ef(flat(msgs, k), flat(err, l_rows),
                                torch.from_numpy(ids), frac=frac,
                                segments=segs)
    for (off, size), n in zip(segs, names):
        for got, want in ((sent, sent_j), (new, new_j)):
            g = got[:, off:off + size].numpy()
            assert np.array_equal(
                g.view(np.int32),
                np.asarray(want[n]).reshape(k, -1).view(np.int32)), n


def _suffix_select(hist, want):
    """Per row of ``hist (..., 256)``: the bin b at which the count of
    bins >= b first reaches ``want``, and the count in the bins above b
    (the kernel's block-wide suffix scan)."""
    incl = torch.flip(torch.cumsum(torch.flip(hist, [-1]), -1), [-1])
    b = torch.sum(incl >= want[..., None], dim=-1) - 1
    above = torch.gather(incl - hist, -1, b[..., None])[..., 0]
    return b, above


def _topk_three_pass_emulation(msgs, err_rows, segments):
    """B4's three passes (``csrc/fed_topk_ef.cu``) on CPU tensors, as the
    kernel runs them: keys and per-chunk high-byte histograms merged per
    (row, segment) and the bucket B; per-chunk low-byte histograms of the
    keys in B, T and need with the NaN accounting; each chunk's tie
    prefix from the earlier chunks' low-byte bin of T, then ranks in index
    order inside the chunk.  Returns ``(sent, new_err)``."""
    tab = fed_aggregate.chunk_table(segments)
    k_rows, nseg = msgs.shape[0], len(segments)
    nchunk = len(tab["chunk_seg"])
    seg_k = torch.from_numpy(tab["seg_k"].astype(np.int64))
    corrected = msgs + err_rows
    mag = corrected.abs().to(torch.bfloat16).view(torch.int16).to(
        torch.int64) & 0xFFFF
    keys = torch.where(mag > 0x7F80, 0xFFFF, mag)
    chunks = [(int(s), int(c0), int(c0) + int(n)) for s, c0, n in
              zip(tab["chunk_seg"], tab["chunk_start"], tab["chunk_len"])]

    def counts(v):                      # per row, 256 bins
        return torch.stack([torch.bincount(r, minlength=256) for r in v])

    # 1. key pass
    hist_hi = torch.zeros((k_rows, nseg, 256), dtype=torch.int64)
    for s, a, b in chunks:
        hist_hi[:, s] += counts(keys[:, a:b] >> 8)
    hi, above_hi = _suffix_select(hist_hi, seg_k.expand(k_rows, nseg))
    kk = seg_k - above_hi
    # 2. low pass
    lo_chunk = torch.zeros((k_rows, nchunk, 256), dtype=torch.int64)
    hist_lo = torch.zeros((k_rows, nseg, 256), dtype=torch.int64)
    for c, (s, a, b) in enumerate(chunks):
        in_b = (keys[:, a:b] >> 8) == hi[:, s:s + 1]
        lo = torch.where(in_b, keys[:, a:b] & 0xFF, 256)
        lo_chunk[:, c] = torch.stack([torch.bincount(r, minlength=257)[:256]
                                      for r in lo])
        hist_lo[:, s] += lo_chunk[:, c]
    lo_b, above_lo = _suffix_select(hist_lo, kk)
    thr = (hi << 8) | lo_b
    greater = (seg_k - kk) + above_lo - hist_hi[..., 255]
    need = torch.where(thr == 0xFFFF, 0, seg_k - greater)
    # 3. write pass: each chunk's tie prefix from bin (T & 0xFF) of the
    # segment's earlier chunks, then ranks in index order inside the chunk
    keep = torch.zeros(keys.shape, dtype=torch.bool)
    first = tab["seg_chunk0"]
    for c, (s, a, b) in enumerate(chunks):
        t = thr[:, s:s + 1]
        prior = torch.gather(lo_chunk[:, first[s]:c], 2,
                             (t & 0xFF)[:, None].expand(-1, c - first[s], 1)
                             ).sum(dim=(1, 2))
        prior = torch.where(t[:, 0] == 0xFFFF, 0, prior)
        key = keys[:, a:b]
        tie = ((key == t) & (t != 0xFFFF)).to(torch.int64)
        rank = prior[:, None] + torch.cumsum(tie, 1) - tie
        keep[:, a:b] = (key != 0xFFFF) & (
            (key > t) | ((tie == 1) & (rank < need[:, s:s + 1])))
    sent = torch.where(keep, corrected, torch.zeros((), dtype=torch.float32))
    return sent, corrected - sent


# the edge segments 1, 4095, 4096, 4097 and 8193, each at an offset 2 mod 4
# (the fillers of 2, 3, 1 and 3 columns between them are segments too)
TOPK_EDGE_SIZES = [2, 1, 3, 4095, 1, 4096, 4097, 3, 8193]
TOPK_EDGE_KINDS = ["gauss", "ties", "near_ties", "tiny", "all_equal", "inf",
                   "neg_zero", "nan"]
TOPK_EDGE_ROWS, TOPK_EDGE_L = 3, 4


def _topk_edge_kind(kind, k, l_rows, d, rng):
    """(msgs (k, d), err (l_rows, d)) of one row kind."""
    err = np.zeros((l_rows, d), np.float32)
    if kind in ("gauss", "ties", "near_ties"):
        msgs = _topk_rows(kind, (k, d), rng)
        if kind == "gauss":
            err = (0.1 * rng.standard_normal((l_rows, d))).astype(np.float32)
    elif kind == "tiny":
        msgs = (1e-3 * rng.standard_normal((k, d))).astype(np.float32)
        err = (1e-4 * rng.standard_normal((l_rows, d))).astype(np.float32)
    elif kind == "all_equal":      # every key a tie, across every chunk
        msgs = np.full((k, d), -0.375, np.float32)
    elif kind == "inf":
        msgs = rng.standard_normal((k, d)).astype(np.float32)
        msgs[rng.random((k, d)) < 0.05] = np.inf
        msgs[rng.random((k, d)) < 0.05] = -np.inf
        err = (0.1 * rng.standard_normal((l_rows, d))).astype(np.float32)
    elif kind == "neg_zero":        # -0.0 + -0.0 keeps the sign bit
        msgs = rng.standard_normal((k, d)).astype(np.float32)
        msgs[rng.random((k, d)) < 0.7] = -0.0
        err = np.full((l_rows, d), -0.0, np.float32)
    else:     # an all-NaN (padded) row; scattered NaNs rank above +inf
        msgs = rng.standard_normal((k, d)).astype(np.float32)
        msgs[rng.random((k, d)) < 0.05] = np.nan
        msgs[0] = np.nan
    return msgs, err


@functools.lru_cache(maxsize=None)
def _topk_edge_case(frac):
    """Every kind's rows stacked, and the Pallas kernel's outputs for them
    per segment (one interpret-mode call a segment for all kinds)."""
    rng = np.random.default_rng(16)
    d = sum(TOPK_EDGE_SIZES)
    parts = [_topk_edge_kind(kind, TOPK_EDGE_ROWS, TOPK_EDGE_L, d, rng)
             for kind in TOPK_EDGE_KINDS]
    msgs = np.concatenate([m for m, _ in parts])
    err = np.concatenate([e for _, e in parts])
    ids = np.concatenate([np.asarray([0, 2, 3], np.int32) + TOPK_EDGE_L * i
                          for i in range(len(TOPK_EDGE_KINDS))])
    segs = ops.topk_segments(
        [(o, n) for o, n in zip(np.cumsum([0] + TOPK_EDGE_SIZES[:-1]),
                                TOPK_EDGE_SIZES)], frac)
    sent, new = np.empty_like(msgs), np.empty_like(msgs)
    for o, n, kk in segs:
        s, e = fed_topk_ef_pallas(jnp.asarray(msgs[:, o:o + n]),
                                  jnp.asarray(err[:, o:o + n]),
                                  jnp.asarray(ids), k_keep=kk,
                                  interpret=True)
        sent[:, o:o + n], new[:, o:o + n] = np.asarray(s), np.asarray(e)
    return msgs, err, ids, segs, sent, new


@pytest.mark.parametrize("kind", TOPK_EDGE_KINDS)
@pytest.mark.parametrize("frac", [0.01, 0.25, 1.0])
def test_topk_three_pass_emulation_matches_pallas(kind, frac):
    """The CUDA kernel's algorithm (chunks of 4096 columns, per-chunk
    low-byte histograms, tie prefixes taken from them, the NaN
    accounting) is bitwise the Pallas kernel and the plain version, over
    segments that end and start around the chunk edges at misaligned
    offsets."""
    assert fed_aggregate.CHUNK == 4096
    msgs, err, ids, segs, sent_j, new_j = _topk_edge_case(frac)
    rows = slice(TOPK_EDGE_KINDS.index(kind) * TOPK_EDGE_ROWS,
                 (TOPK_EDGE_KINDS.index(kind) + 1) * TOPK_EDGE_ROWS)
    m = torch.from_numpy(msgs[rows])
    e = torch.from_numpy(err)[torch.from_numpy(ids[rows]).long()]
    sent, new = _topk_three_pass_emulation(m, e, segs)
    bits = lambda a: np.asarray(a).view(np.int32)  # noqa: E731
    nan = np.isnan(sent_j[rows]) | np.isnan(new_j[rows])
    for got, want in ((sent, sent_j[rows]), (new, new_j[rows])):
        g = got.numpy()
        assert np.array_equal(np.isnan(g), np.isnan(want))
        assert np.array_equal(bits(g)[~nan], bits(want)[~nan])
    for o, n, kk in segs:
        ws, we = ref.fed_topk_ef_ref(m[:, o:o + n], e[:, o:o + n], kk)
        for got, want in ((sent, ws), (new, we)):
            g, w = got[:, o:o + n].numpy(), want.numpy()
            assert np.array_equal(np.isnan(g), np.isnan(w))
            assert np.array_equal(bits(g)[~np.isnan(g)],
                                  bits(w)[~np.isnan(w)])
        kept = (sent[:, o:o + n] != 0).sum(1) \
            + (torch.signbit(sent[:, o:o + n])
               & (sent[:, o:o + n] == 0)).sum(1)
        assert int(kept.max()) <= kk


# ---------------------------------------------------------------------------
# dispatch and the wrappers' checks
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_path_and_build_nothing(rng):
    def counts():
        return (fed_aggregate.launches, fed_aggregate.dp_secure_launches,
                fed_aggregate.topk_ef_launches, topic_decoder.launches,
                dict(_build._LIBS))
    before = counts()
    x, w = _combine_inputs(3, 40, rng)
    ops.fed_weighted_combine(torch.from_numpy(x), torch.from_numpy(w))
    theta, beta, bow, sc = _decoder_inputs(3, 4, 50, rng)
    ops.topic_decoder_loss(_t(theta), _t(beta), _t(bow), _t(sc))
    xt = torch.from_numpy(np.nan_to_num(x))
    ops.fed_dp_secure_apply(xt, masks=torch.ones(3, 40),
                            weights=torch.ones(3))
    ops.fed_topk_ef(xt, torch.zeros(2, 40), torch.tensor([0, 1, 1]),
                    frac=0.5, segments=[(0, 10), (10, 30)])
    assert counts() == before


@pytest.mark.parametrize("call", ["weighted_sum", "decoder", "dp_secure",
                                  "topk", "flash", "ssd"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """The CUDA wrappers never run a CPU tensor (no quiet fallback)."""
    with pytest.raises(ValueError, match="CUDA"):
        if call == "flash":
            q = torch.zeros(1, 8, 2, 32)
            flash_attention_cuda(q, q, q, causal=True, window=0, scale=1.0)
        elif call == "ssd":
            ssd_scan_cuda(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2),
                          torch.zeros(2), torch.zeros(1, 8, 4),
                          torch.zeros(1, 8, 4), chunk=8)
        elif call == "weighted_sum":
            fed_weighted_sum_cuda(torch.zeros(2, 3), torch.ones(2))
        elif call == "decoder":
            topic_decoder_cuda(torch.ones(2, 3), torch.ones(3, 5),
                               torch.ones(2, 5))
        elif call == "dp_secure":
            fed_dp_secure_apply_cuda(torch.zeros(2, 3),
                                     clip_coef=torch.ones(2))
        else:
            fed_topk_ef_cuda(torch.zeros(2, 3), torch.zeros(2, 3),
                             torch.zeros(2, dtype=torch.int32), [(0, 3, 1)])


@pytest.mark.parametrize("call", ["topic_decoder", "flash_attention",
                                  "ssd_scan"])
def test_forward_only_wrappers_refuse_grad_before_the_kernel(call,
                                                             monkeypatch):
    """The routing of a CUDA tensor, forced here on CPU tensors.  B1 is
    forward-only: a call that needs a gradient raises before any kernel
    is reached, naming the kernel and A3.  B5 and B6 have backward
    kernels: a call that needs a gradient goes through their autograd
    Function on to the kernel wrapper, as one that needs none does (the
    wrapper then refuses the CPU tensors)."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    if call == "topic_decoder":
        args = [torch.ones(2, 3), torch.ones(3, 5), torch.ones(2, 5), None]
        fn = ops.topic_decoder_loss
    elif call == "flash_attention":
        args = [torch.zeros(1, 8, 2, 32)] * 3
        fn = ops.flash_attention
    else:
        args = [torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2),
                torch.zeros(2), torch.zeros(1, 8, 4), torch.zeros(1, 8, 4)]
        fn = ops.ssd_scan
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    grad = [a if a is None else a.clone().requires_grad_(i == 1)
            for i, a in enumerate(args)]
    if call == "topic_decoder":
        with pytest.raises(RuntimeError, match=f"{call}.*forward-only.*A3"):
            fn(*grad)
    else:
        with pytest.raises(ValueError, match="CUDA"):
            fn(*grad)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*grad)


def test_kernel_sources_and_build_key():
    """Every kernel is built from sources in the package, keyed on a
    hash of source + shared headers + flags, for sm_90a."""
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.SOURCES:
        src, so = _build._target(name)
        assert src.exists() and src.suffix == ".cu"
        assert so.parent == _build.BUILD_DIR and name in so.name
        text = src.read_text()
        assert 'extern "C"' in text and "cudaGetLastError" in text
    # the key covers the shared headers: B5 and B6 include wgmma.cuh, both
    # directions of B6 ssd_common.cuh
    headers = sorted(_build.CSRC.glob("*.cuh"))
    assert [h.name for h in headers] == ["ssd_common.cuh", "wgmma.cuh"]
    for name in ("flash_attention", "ssd_scan", "ssd_scan_bwd"):
        src, so = _build._target(name)
        text = src.read_text()
        assert '#include "wgmma.cuh"' in text
        assert name == "flash_attention" \
            or '#include "ssd_common.cuh"' in text
        key = hashlib.sha256(src.read_bytes()
                             + b"".join(h.read_bytes() for h in headers)
                             + " ".join(_build.NVCC_FLAGS).encode())
        assert so.name == f"lib{name}-{key.hexdigest()[:16]}.so"
    # B1's one launch: 32 documents x 128 words a block, the tails ragged
    assert topic_decoder.grid(256, 5000) == (8, 40)
    assert topic_decoder.grid(1, 17) == (1, 1)
    assert topic_decoder.grid(33, 129) == (2, 2)


# ---------------------------------------------------------------------------
# B5: flash attention (the reference's grid, tests/test_kernels.py)
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # (b, hq, hkv, s, d, causal, window)
    (2, 4, 2, 256, 64, True, 0),
    (1, 4, 1, 128, 32, True, 0),      # MQA
    (2, 2, 2, 256, 64, True, 64),     # sliding window
    (1, 4, 4, 128, 64, False, 0),     # bidirectional
    (1, 8, 2, 100, 32, True, 0),      # non-block-multiple sequence
]


def _qkv(b, hq, hkv, s, d, rng):
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(b, hq, hkv, s, d, causal,
                                              window, dtype, rng):
    """(B,S,H,D) in and out, as ``ops.flash_attention`` in both packages;
    2e-5 in fp32, 2e-2 in bf16 (the reference's own bounds)."""
    q, k, v = (jnp.asarray(a, dtype) for a in _qkv(b, hq, hkv, s, d, rng))
    want = jops.flash_attention(q, k, v, causal=causal, window=window,
                                interpret=True)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = ops.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                              causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (b, s, hq, d)
    tol = 2e-5 if dtype == "float32" else 2e-2
    dev = float(np.max(np.abs(got.to(torch.float32).numpy()
                              - np.asarray(want, np.float32))))
    print(f"B5 plain vs pallas {(b, hq, hkv, s, d, causal, window)} "
          f"{dtype}: {dev:.3e}")
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES)
def test_flash_attention_plain_matches_chunked_attention(b, hq, hkv, s, d,
                                                         causal, window,
                                                         rng):
    """Against the jnp core the reference's layers run (chunk 64, so the
    longer cases cross chunks): 2e-5 in fp32."""
    q, k, v = _qkv(b, hq, hkv, s, d, rng)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             pos, pos, causal=causal, window=window,
                             scale=d ** -0.5, chunk=64)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _flash_tensor_core_emulation(q, k, v, *, causal, window, scale):
    """The arithmetic of B5's bf16 tensor-core route, in plain PyTorch on
    (B,S,H,D) bf16 tensors: 64-key tiles, fp32 scores from the bf16 q and
    k, the online softmax in exp2 with ``scale * log2(e)`` folded in, P
    rounded to bf16 before P V, l summed from the fp32 p, one cast of the
    output.  Test-only: the kernel's numeric design, checked on the CPU."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float().transpose(1, 2)                          # (B,H,S,D)
    kf = k.float().transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    c = scale * 1.4426950408889634
    qpos = torch.arange(s)[:, None]
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, 64):
        kpos = torch.arange(k0, min(k0 + 64, s))[None, :]
        mask = torch.ones(s, kpos.shape[1], dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        t = torch.matmul(qf, kf[:, :, k0:k0 + 64].transpose(-1, -2)) * c
        t = torch.where(mask, t, -1e30)
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(mask, torch.exp2(t - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(),
                                         vf[:, :, k0:k0 + 64])
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES)
def test_flash_tensor_core_arithmetic_matches_pallas(b, hq, hkv, s, d,
                                                     causal, window, rng):
    """B5's bf16 route rounds P to bf16 before P V: its arithmetic, in
    plain PyTorch, against the Pallas kernel in interpret mode on bf16
    inputs within the reference's bf16 bound, 2e-2 abs + rel."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16)
               for a in _qkv(b, hq, hkv, s, d, rng))
    want = np.asarray(jops.flash_attention(q, k, v, causal=causal,
                                           window=window, interpret=True),
                      np.float32)
    got = _flash_tensor_core_emulation(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        causal=causal, window=window, scale=d ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, hq, d)
    got = got.float().numpy()
    print(f"B5 tensor-core arithmetic vs pallas "
          f"{(b, hq, hkv, s, d, causal, window)} bf16: "
          f"{float(np.max(np.abs(got - want))):.3e}")
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def _flash_bwd_tensor_core_emulation(q, k, v, out, lse, dout, *, causal,
                                     window, scale):
    """The arithmetic of B5's backward on its bf16 tensor-core route, in
    plain PyTorch on (B,S,H,D) bf16 tensors and the (B,H,S) fp32 lse: fp32
    S and dP from the bf16 operands, delta = rowsum(dO o O) in fp32, P =
    exp2(S scale log2(e) - lse log2(e)), dS = P (dP - delta) scale; P and
    dS rounded to bf16 before their products; dQ, dK, dV (dK and dV per
    query head, then summed over each kv head's group) accumulated in
    fp32 and cast once.  Test-only: the kernels' numeric design, checked
    on the CPU."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    log2e = 1.4426950408889634
    qf, dof, of = (t.float().transpose(1, 2) for t in (q, dout, out))
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(h // hkv, dim=1)
              for t in (k, v))                              # (B,H,S,D)
    pos = torch.arange(s)
    mask = torch.ones(s, s, dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    t = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * log2e)
    p = torch.where(mask, torch.exp2(t - lse[..., None] * log2e), 0.0)
    delta = torch.sum(dof * of, dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    pb, dsb = (x.to(torch.bfloat16).float() for x in (p, ds))
    dq = torch.matmul(dsb, kf)
    dk = torch.matmul(dsb.transpose(-1, -2), qf)
    dv = torch.matmul(pb.transpose(-1, -2), dof)
    group = lambda x: x.reshape(b, hkv, h // hkv, s, d).sum(2)  # noqa: E731
    return (dq.transpose(1, 2).to(torch.bfloat16),
            group(dk).transpose(1, 2).to(torch.bfloat16),
            group(dv).transpose(1, 2).to(torch.bfloat16))


# the B5 backward grid of tests/test_torch_lm_train.py
FLASH_BWD_CASES = [  # (b, s, hq, hkv, d, causal, window)
    (2, 70, 4, 2, 32, True, 16),     # GQA, window, ragged over chunks
    (1, 64, 4, 4, 16, True, 0),      # causal
    (1, 37, 3, 1, 16, False, 0),     # full, MQA, ragged
    (2, 50, 6, 2, 32, False, 8),     # bidirectional window
    (1, 65, 5, 5, 32, True, 64),     # one past a chunk, window = chunk
]


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_bwd_tensor_core_arithmetic_matches_jax_vjp(case, rng):
    """B5's backward on its bf16 route rounds P and dS to bf16 before
    their products: its arithmetic, in plain PyTorch from the forward
    route's bf16 output, against ``jax.vjp`` of the reference's
    ``chunked_attention`` on the same seeded bf16 inputs, within 2e-2 of
    each gradient's max|reference|."""
    b, s, hq, hkv, d, causal, window = case
    q, k, v = (jnp.asarray(a, jnp.bfloat16)
               for a in _qkv(b, hq, hkv, s, d, rng))
    dout = jnp.asarray(rng.standard_normal((b, s, hq, d)), jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    _, vjp = jax.vjp(lambda q, k, v: chunked_attention(
        q, k, v, pos, pos, causal=causal, window=window, scale=d ** -0.5,
        chunk=16), q, k, v)
    want = vjp(dout)
    qt, kt, vt, dt = (_t(a, torch.bfloat16) for a in (q, k, v, dout))
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    out = _flash_tensor_core_emulation(qt, kt, vt, **kw)
    _, lse = ref.flash_attention_fwd_ref(qt, kt, vt, **kw)
    got = _flash_bwd_tensor_core_emulation(qt, kt, vt, out, lse, dt, **kw)
    devs = []
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        devs.append(float(np.max(np.abs(g.float().numpy() - w)))
                    / float(np.max(np.abs(w))))
    print(f"B5 backward tensor-core arithmetic vs jax.vjp {case} bf16: dq, "
          f"dk, dv {['%.3e' % e for e in devs]} of max|reference|")
    assert max(devs) <= 2e-2


# ---------------------------------------------------------------------------
# B6: the SSD scan (the reference's grid, tests/test_kernels.py)
# ---------------------------------------------------------------------------
SSD_CASES = [
    # (b, s, h, p, n, chunk)
    (2, 256, 3, 32, 16, 64),
    (1, 100, 2, 16, 8, 32),           # ragged sequence
    (1, 64, 1, 64, 128, 64),          # mamba2-1.3b-like state
]


def _ssd_inputs(b, s, h, p, n, rng):
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_scan_plain_matches_pallas(b, s, h, p, n, chunk, rng):
    args = _ssd_inputs(b, s, h, p, n, rng)
    yj, hj = jops.ssd_scan(*(jnp.asarray(a) for a in args), chunk=chunk,
                           interpret=True)
    yt, ht = ops.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert yt.shape == (b, s, h, p) and ht.shape == (b, h, p, n)
    print(f"B6 plain vs pallas {(b, s, h, p, n, chunk)}: y "
          f"{np.max(np.abs(yt.numpy() - np.asarray(yj))):.3e}, h "
          f"{np.max(np.abs(ht.numpy() - np.asarray(hj))):.3e}")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_scan_plain_matches_ssd_chunked(b, s, h, p, n, chunk, rng):
    """Against the jnp scan the reference's mamba2 layer runs; a ragged
    sequence is padded with dt = 0 steps for it, as mamba2_apply pads."""
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, rng)
    pad = -s % chunk
    padded = [np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
              for t in (x, dt, bb, cc)]
    yj, hj = ssd_chunked(*(jnp.asarray(t) for t in padded[:2]),
                         jnp.asarray(a),
                         *(jnp.asarray(t) for t in padded[2:]), chunk)
    yt, ht = ops.ssd_scan(*(torch.from_numpy(t) for t in (x, dt, a, bb, cc)),
                          chunk=chunk)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj)[:, :s], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4,
                               rtol=1e-4)


def test_ssd_scan_plain_keeps_bf16_and_the_padding_state(rng):
    """bf16 x/b/c in, y out in bf16 and h_last in fp32; dt = 0 steps
    appended to a sequence leave its final state as it was."""
    x, dt, a, bb, cc = _ssd_inputs(1, 40, 2, 16, 8, rng)
    y, h = ops.ssd_scan(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(dt), torch.from_numpy(a),
                        torch.from_numpy(bb).to(torch.bfloat16),
                        torch.from_numpy(cc).to(torch.bfloat16), chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    z = [np.concatenate([t, np.zeros((1, 8) + t.shape[2:], t.dtype)], 1)
         for t in (x, dt, bb, cc)]
    _, h_pad = ops.ssd_scan(*(torch.from_numpy(t) for t in z[:2]),
                            torch.from_numpy(a),
                            *(torch.from_numpy(t) for t in z[2:]), chunk=16)
    _, h_ref = ops.ssd_scan(*(torch.from_numpy(t) for t in (x, dt, a, bb,
                                                            cc)), chunk=16)
    np.testing.assert_allclose(h_pad.numpy(), h_ref.numpy(), atol=1e-6)


def _ssd_tensor_core_emulation(x, dt, a, b, c, chunk):
    """The arithmetic of B6's bf16 tensor-core route, in plain PyTorch on
    bf16 x (B,S,H,P), b/c (B,S,N) and fp32 dt, a: fp32 products of the
    bf16 operands and fp32 sums; B o w (the chunk's own state), the
    carried state in its product and W = (C B^T) o decay o dt are each
    rounded to bf16 once; the carried state stays fp32; y is cast once.
    Test-only: the kernels' numeric design, checked on the CPU."""
    f32, bf = torch.float32, torch.bfloat16
    s = x.shape[1]
    pad = -s % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt, b, c = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                    for t in (dt, b, c))
    bs, sp, h, p = x.shape
    n = b.shape[-1]
    nc = sp // chunk
    xc = x.to(f32).reshape(bs, nc, chunk, h, p)
    dtc = dt.to(f32).reshape(bs, nc, chunk, h)
    bc = b.to(f32).reshape(bs, nc, chunk, n)
    cc = c.to(f32).reshape(bs, nc, chunk, n)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    hst = torch.zeros(bs, h, p, n)
    ys = []
    for i in range(nc):
        xb, dtb, bb, cb = xc[:, i], dtc[:, i], bc[:, i], cc[:, i]
        cum = torch.cumsum(dtb * a.to(f32), dim=1)                # (B,Q,H)
        w = torch.exp(cum[:, -1:] - cum) * dtb
        bw = (bb[:, :, None, :] * w[..., None]).to(bf).to(f32)    # (B,Q,H,N)
        own = torch.einsum("bjhp,bjhn->bhpn", xb, bw)
        y = torch.exp(cum)[..., None] * torch.einsum(
            "bin,bhpn->bihp", cb, hst.to(bf).to(f32))
        ct = cum.transpose(1, 2)                                  # (B,H,Q)
        decay = torch.where(tril, torch.exp(ct[..., :, None]
                                            - ct[..., None, :]), 0.0)
        wm = torch.einsum("bin,bjn->bij", cb, bb)[:, None] * decay \
            * dtb.transpose(1, 2)[:, :, None, :]
        y = y + torch.einsum("bhij,bjhp->bihp", wm.to(bf).to(f32), xb)
        hst = torch.exp(cum[:, -1])[..., None, None] * hst + own
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bs, sp, h, p)[:, :s]
    return y.to(bf), hst


# the reference's grid, the hymba prefill's head (P=64, N=16, chunk 256,
# ragged) and mamba2-1.3b's state (N=128, chunk 256)
SSD_TC_CASES = SSD_CASES + [(1, 600, 2, 64, 16, 256), (1, 520, 2, 64, 128,
                                                       256)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_TC_CASES)
def test_ssd_tensor_core_arithmetic_matches_pallas(b, s, h, p, n, chunk,
                                                   rng):
    """B6's bf16 route rounds W, the carried state in its product and
    B o w to bf16: its arithmetic, in plain PyTorch, against the Pallas
    kernel in interpret mode on bf16 inputs within the reference's bf16
    bound, 2e-2 of max|y| and of max|h_last|."""
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, rng)
    xj, bj, cj = (jnp.asarray(t, jnp.bfloat16) for t in (x, bb, cc))
    yj, hj = jops.ssd_scan(xj, jnp.asarray(dt), jnp.asarray(a), bj, cj,
                           chunk=chunk, interpret=True)
    yt, ht = _ssd_tensor_core_emulation(
        _t(xj, torch.bfloat16), torch.from_numpy(dt), torch.from_numpy(a),
        _t(bj, torch.bfloat16), _t(cj, torch.bfloat16), chunk)
    assert yt.dtype == torch.bfloat16 and yt.shape == (b, s, h, p)
    devs = []
    for got, want in ((yt.float().numpy(), np.asarray(yj, np.float32)),
                      (ht.numpy(), np.asarray(hj, np.float32))):
        scale = max(float(np.max(np.abs(want))), 1.0)
        devs.append(float(np.max(np.abs(got - want))) / scale)
    print(f"B6 tensor-core arithmetic vs pallas {(b, s, h, p, n, chunk)} "
          f"bf16: y {devs[0]:.3e}, h_last {devs[1]:.3e} of the scale")
    assert max(devs) <= 2e-2


def _ssd_bwd_tensor_core_emulation(x, dt, a, b, c, dy, chunk):
    """The arithmetic of B6's backward on its bf16 tensor-core route, in
    plain PyTorch on bf16 x, dy (B,S,H,P), b/c (B,S,N) and fp32 dt, a,
    from a zero state and no cotangent on h_last (the training path's
    case).  The states entering the chunks are the forward route's (B o w
    rounded to bf16 for the chunk's own state, fp32 carried).  Per chunk,
    fp32 G = C B^T, D = dY X^T and M = D o G o L o dt_j from the bf16
    operands; W_D = D o L o dt_j, W_G = G o L o dt_j and C o exp(cum)
    rounded to bf16 before their products; h0 and dh1 rounded to bf16
    for their products only; M's diagonal left out of dcum (it enters
    once from each side with opposite signs); dcum, g, ddt and da summed
    in fp32; dx, db, dc cast once.  Test-only: the kernels' numeric
    design, checked on the CPU."""
    f32, bf = torch.float32, torch.bfloat16
    rb = lambda t: t.to(bf).to(f32)  # noqa: E731
    s = x.shape[1]
    pad = -s % chunk
    if pad:
        x, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                 for t in (x, dy))
        dt, b, c = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                    for t in (dt, b, c))
    bs, sp, h, p = x.shape
    n = b.shape[-1]
    nc = sp // chunk
    # (B, H, chunk, Q, .) layouts
    xc = x.to(f32).reshape(bs, nc, chunk, h, p).permute(0, 3, 1, 2, 4)
    dyc = dy.to(f32).reshape(bs, nc, chunk, h, p).permute(0, 3, 1, 2, 4)
    dtc = dt.to(f32).reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)
    bc = b.to(f32).reshape(bs, 1, nc, chunk, n)
    cc = c.to(f32).reshape(bs, 1, nc, chunk, n)
    cum = torch.cumsum(dtc * a.to(f32)[None, :, None, None], dim=-1)
    cq = cum[..., -1]                                          # (B,H,nc)
    e = torch.exp(cum)
    w = torch.exp(cq[..., None] - cum) * dtc
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    ldt = torch.where(tril, torch.exp(cum[..., :, None] - cum[..., None, :]),
                      0.0) * dtc[..., None, :]                 # L o dt_j
    # the forward's states entering each chunk
    own = torch.einsum("bhcjp,bhcjn->bhcpn", xc, rb(bc * w[..., None]))
    h0 = [torch.zeros(bs, h, p, n)]
    for i in range(nc - 1):
        h0.append(torch.exp(cq[..., i])[..., None, None] * h0[-1]
                  + own[:, :, i])
    h0 = torch.stack(h0, dim=2)                                # (B,H,nc,P,N)
    g_m = torch.einsum("bhcin,bhcjn->bhcij", cc.expand(-1, h, -1, -1, -1),
                       bc.expand(-1, h, -1, -1, -1))
    d_m = torch.einsum("bhcip,bhcjp->bhcij", dyc, xc)
    m = d_m * g_m * ldt
    off = ~torch.eye(chunk, dtype=torch.bool)
    # 1. rows: dC, the row part of dcum, U
    z = torch.einsum("bhcip,bhcpn->bhcin", dyc, rb(h0))
    dc_h = torch.einsum("bhcij,bhcjn->bhcin", rb(d_m * ldt), bc) \
        + e[..., None] * z
    dcum = torch.where(off, m, 0.0).sum(-1) + e * (z * cc).sum(-1)
    u = torch.einsum("bhcip,bhcin->bhcpn", dyc, rb(cc * e[..., None]))
    # 2. the state pass, from the last chunk back
    dh1, carry = [None] * nc, torch.zeros(bs, h, p, n)
    for i in reversed(range(nc)):
        dh1[i] = carry
        carry = torch.exp(cq[..., i])[..., None, None] * carry + u[:, :, i]
    dh1 = torch.stack(dh1, dim=2)
    # 3. columns: dx, dB, the direct ddt and the column part of dcum
    t = torch.einsum("bhcjn,bhcpn->bhcjp", bc.expand(-1, h, -1, -1, -1),
                     rb(dh1))
    dx = torch.einsum("bhcij,bhcip->bhcjp", rb(g_m * ldt), dyc) \
        + w[..., None] * t
    sj = (xc * t).sum(-1)
    db_h = torch.einsum("bhcij,bhcin->bhcjn", rb(d_m * ldt), cc) \
        + w[..., None] * torch.einsum("bhcjp,bhcpn->bhcjn", xc, rb(dh1))
    r_all = (d_m * g_m * torch.where(tril, torch.exp(
        cum[..., :, None] - cum[..., None, :]), 0.0)).sum(-2)
    ddt_direct = r_all + torch.exp(cq[..., None] - cum) * sj
    dcum = dcum - torch.where(off, m, 0.0).sum(-2) - w * sj
    dcum[..., -1] += torch.exp(cq) * (dh1 * h0).sum((-1, -2)) \
        + (w * sj).sum(-1)
    g = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = ddt_direct + a.to(f32)[None, :, None, None] * g
    da = (dtc * g).sum((0, 2, 3))
    back = lambda t: t.permute(0, 2, 3, 1, *range(4, t.dim())).reshape(  # noqa
        bs, sp, h, *t.shape[4:])[:, :s]
    return (back(dx).to(bf), back(ddt), da,
            db_h.sum(1).reshape(bs, sp, n)[:, :s].to(bf),
            dc_h.sum(1).reshape(bs, sp, n)[:, :s].to(bf))


# the plain backward's grid of tests/test_torch_lm_train.py, the training
# path's head (P=64, N=16, chunk 256, ragged) and mamba2-1.3b's state
# (N=128, chunk 256)
SSD_BWD_TC_CASES = [(2, 64, 3, 8, 4, 16), (1, 40, 2, 16, 8, 16),
                    (1, 48, 2, 8, 16, 48), (1, 17, 2, 8, 4, 8),
                    (2, 31, 1, 4, 2, 8), (1, 300, 2, 64, 16, 256),
                    (1, 260, 2, 64, 128, 256)]


@pytest.mark.parametrize("case", SSD_BWD_TC_CASES)
def test_ssd_bwd_tensor_core_arithmetic_matches_jax_vjp(case, rng):
    """B6's backward on its bf16 route rounds W_D, W_G, C o exp(cum), h0
    and dh1 to bf16 before their products: its arithmetic, in plain
    PyTorch, against ``jax.vjp`` of the reference's ``ssd_chunked`` on
    the same bf16-rounded inputs (held in fp32, a ragged tail padded with
    zero steps as mamba2_apply pads), within 2e-2 of each gradient's
    max|reference| for all five gradients."""
    b, s, h, p, n, chunk = case
    rnd = lambda t: np.asarray(jnp.asarray(t, jnp.bfloat16),  # noqa: E731
                               np.float32)
    x = rnd(rng.standard_normal((b, s, h, p)))
    dt = rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, h).astype(np.float32)
    bm, cm = (rnd(rng.standard_normal((b, s, n))) for _ in range(2))
    dy = rnd(rng.standard_normal((b, s, h, p)))
    pad = -s % chunk

    def f(x, dt, a, bm, cm):
        padt = lambda t: jnp.pad(t, [(0, 0), (0, pad)]  # noqa: E731
                                 + [(0, 0)] * (t.ndim - 2))
        return ssd_chunked(padt(x), padt(dt), a, padt(bm), padt(cm),
                           chunk)[0][:, :s]
    _, vjp = jax.vjp(f, x, dt, a, bm, cm)
    want = vjp(jnp.asarray(dy))
    bf = torch.bfloat16
    got = _ssd_bwd_tensor_core_emulation(
        _t(x, bf), torch.from_numpy(dt), torch.from_numpy(a), _t(bm, bf),
        _t(cm, bf), _t(dy, bf), chunk)
    devs = []
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        devs.append(float(np.max(np.abs(g.float().numpy() - w)))
                    / float(np.max(np.abs(w))))
    print(f"B6 backward tensor-core arithmetic vs jax.vjp {case} bf16: dx, "
          f"ddt, da, db, dc {['%.3e' % d for d in devs]} of max|reference|")
    assert max(devs) <= 2e-2


def test_lm_kernels_on_cpu_launch_nothing(rng):
    before = (flash_attention.launches, ssd_scan.launches, dict(_build._LIBS))
    q, k, v = _qkv(1, 4, 2, 40, 32, rng)
    ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=16)
    ops.ssd_scan(*(torch.from_numpy(t) for t in _ssd_inputs(1, 40, 2, 16, 8,
                                                            rng)), chunk=16)
    assert (flash_attention.launches, ssd_scan.launches,
            dict(_build._LIBS)) == before
