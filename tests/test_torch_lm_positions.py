"""Explicit positions through B5 and B5-bwd, and a carried SSM state
through B6 and B6-bwd, in the port's plain versions against the JAX
package, on the CPU.

Left-padded prompts carry ``positions = arange(S) - pad``: the pad keys
(negative positions) drop out of every mask, and a pad query under a
causal mask attends no key, which gives 0 and ``lse = -1e30`` (the
reference's ``_flash_fwd_scan`` with ``l_safe``) and no gradient.  A
continued Mamba-2 sequence carries ``ssm_state`` into ``ssd_chunked(...,
h0=)``.  Inputs are drawn with numpy from a seed and go through the
reference's jnp cores (``chunked_attention``, ``ssd_chunked``) and their
``jax.vjp``, the layers and the transformer, and through the port's plain
versions (``kernels/ref.py``, CPU tensors), in fp32.  Bounds: 1e-5 of
each output's scale for the kernels' plain versions and the layers, 2e-4
for whole models (the repo's bound of the LM path), 1e-6 for ``vmap``
against a loop of the same arithmetic.  The card holds the kernels
against these plain versions (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as jattn
from repro.models.layers import mamba2 as jmamba
from repro_torch.kernels import ops, ref
from torch_lm_zoo_common import dev, t

NEG_INF = -1e30
S = 128
# one batch row each: none, one, up to a tile's edge and past it, all but
# one token, and the whole row (every query attends nothing)
PADS = (0, 1, 63, 64, 65, S - 1, S)
MASKS = {"causal": (True, 0), "window": (True, 48), "full": (False, 0)}


def _positions(kind, b, s, rng):
    """(B, S) int positions of one kind: left pads, a permutation, each
    position twice, or arange shifted by 1000."""
    if kind == "pads":
        return np.stack([np.arange(s) - p for p in PADS])
    if kind == "permuted":
        return np.stack([rng.permutation(s) - 5 for _ in range(b)])
    if kind == "repeated":
        return np.stack([np.repeat(np.arange(s // 2), 2) - 3 - i
                         for i in range(b)])
    return np.broadcast_to(np.arange(s) + 1000, (b, s)).copy()


def _attention_case(kind, pair, rng, h=4, hkv=2):
    pos = _positions(kind, 3, S, rng)
    b = pos.shape[0]
    dqk, dv = pair
    q = rng.standard_normal((b, S, h, dqk)).astype(np.float32)
    k = rng.standard_normal((b, S, hkv, dqk)).astype(np.float32)
    v = rng.standard_normal((b, S, hkv, dv)).astype(np.float32)
    dout = rng.standard_normal((b, S, h, dv)).astype(np.float32)
    return pos, q, k, v, dout


CASES = [("pads", m, p) for m in MASKS for p in ((64, 64), (96, 64),
                                                  (80, 80))] \
    + [(kind, m, (64, 64)) for kind in ("permuted", "repeated", "offset")
       for m in MASKS]


@pytest.mark.parametrize("kind,mask,pair", CASES)
def test_flash_attention_plain_with_positions_matches_jax(kind, mask, pair,
                                                          rng):
    """B5's and B5-bwd's plain versions at explicit positions against
    ``chunked_attention`` and its ``jax.vjp`` (GQA 4/2), 1e-5; a fully
    masked row gives exactly 0 and lse -1e30, as the reference's."""
    causal, window = MASKS[mask]
    pos, q, k, v, dout = _attention_case(kind, pair, rng)
    scale = pair[0] ** -0.5
    jp = jnp.asarray(pos, jnp.int32)

    def f(q, k, v):
        return jattn.chunked_attention(q, k, v, jp, jp, causal=causal,
                                       window=window, scale=scale)
    jout, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(dout))
    _, jlse = jattn._flash_vjp(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jp, jp, causal, window, scale,
                               512, False)
    tp = torch.from_numpy(pos)
    out, lse = ref.flash_attention_fwd_ref(t(q), t(k), t(v), causal=causal,
                                           window=window, scale=scale,
                                           q_pos=tp, k_pos=tp)
    grads = ref.flash_attention_bwd_ref(t(q), t(k), t(v), out, lse, t(dout),
                                        causal=causal, window=window,
                                        scale=scale, q_pos=tp, k_pos=tp)
    devs = [dev(out, jout)] + [dev(g, w) for g, w in zip(grads, jgrads)]
    jl = np.asarray(jlse).reshape(lse.shape)
    dead = jl <= 0.5 * NEG_INF
    assert np.array_equal(lse.numpy() <= 0.5 * NEG_INF, dead)
    assert np.all(lse.numpy()[dead] == np.float32(NEG_INF))
    devs.append(float(np.max(np.abs(lse.numpy()[~dead] - jl[~dead]),
                             initial=0.0)
                      / max(float(np.max(np.abs(jl[~dead]), initial=1)),
                            1.0)))
    print(f"B5 plain {kind} {mask} {pair}: out, dq, dk, dv, lse dev {devs}; "
          f"{int(dead.sum())} fully masked rows")
    assert max(devs) <= 1e-5
    rows = dead.any(axis=1)            # (B, S): the query rows with no key
    assert torch.all(out[torch.from_numpy(rows)] == 0.0)
    assert torch.all(grads[0][torch.from_numpy(rows)] == 0.0)


def test_fully_masked_rows_give_zero_output_and_gradients():
    """A row of nothing but pads under a causal mask: out 0, lse -1e30,
    zero dq, dk, dv; the pad keys of a partly padded row get no dk, dv;
    through ``ops.flash_attention`` under autograd as well."""
    g = np.random.default_rng(5)
    b, s, h, d = 2, 40, 2, 32
    pos = torch.from_numpy(np.stack([np.arange(s) - s, np.arange(s) - 9]))
    q, k, v = (torch.tensor(g.standard_normal((b, s, h, d)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal=True, q_pos=pos,
                                           k_pos=pos)
    assert torch.all(out[0] == 0.0) and torch.all(out[1, :9] == 0.0)
    assert torch.all(lse[0] == NEG_INF) and torch.all(lse[1, :, :9]
                                                      == NEG_INF)
    assert not torch.isnan(out).any()
    dout = torch.tensor(g.standard_normal((b, s, h, d)), dtype=torch.float32)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                             causal=True, q_pos=pos,
                                             k_pos=pos)
    for grad in (dq, dk, dv):
        assert torch.all(grad[0] == 0.0) and torch.all(grad[1, :9] == 0.0)
    y = ops.flash_attention(q, k, v, causal=True, q_pos=pos, k_pos=pos)
    got = torch.autograd.grad(torch.sum(y * dout), (q, k, v))
    for a, e in zip(got, (dq, dk, dv)):
        assert torch.equal(a, e)


def _ssd_draw(rng, b, s, h, p, n):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dh = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, h0, dy, dh


@pytest.mark.parametrize("chunk,s", [(1, 20), (16, 40), (256, 300)])
def test_ssd_scan_plain_with_h0_matches_ssd_chunked(chunk, s, rng):
    """B6's and B6-bwd's plain versions from a carried state against
    ``ssd_chunked(..., h0=)`` and its ``jax.vjp``, ``dh0`` included (a
    ragged tail padded with dt = 0 steps, as ``mamba2_apply`` pads), 1e-5;
    without h0 the backward's dh0 is the gradient of a zero start."""
    x, dt, a, bm, cm, h0, dy, dh = _ssd_draw(rng, 2, s, 3, 8, 16)
    pad = -s % chunk

    def f(x, dt, a, bm, cm, h0):
        padded = [jnp.pad(u, ((0, 0), (0, pad)) + ((0, 0),) * (u.ndim - 2))
                  for u in (x, dt, bm, cm)]
        y, h_last = jmamba.ssd_chunked(padded[0], padded[1], a, padded[2],
                                       padded[3], chunk, h0=h0)
        return y[:, :s], h_last
    (jy, jh), vjp = jax.vjp(f, *(jnp.asarray(u) for u in
                                 (x, dt, a, bm, cm, h0)))
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    y, h_last = ref.ssd_scan_ref(t(x), t(dt), t(a), t(bm), t(cm), chunk,
                                 t(h0))
    grads = ref.ssd_scan_bwd_ref(t(x), t(dt), t(a), t(bm), t(cm), t(dy),
                                 t(dh), chunk, t(h0))
    devs = [dev(y, jy), dev(h_last, jh)] + [dev(g, w) for g, w in
                                            zip(grads, jgrads)]
    print(f"B6 plain h0 chunk {chunk} S {s}: y, h_last, dx, ddt, da, db, "
          f"dc, dh0 dev {devs}")
    assert len(grads) == 6 and max(devs) <= 1e-5
    zero = ref.ssd_scan_bwd_ref(t(x), t(dt), t(a), t(bm), t(cm), t(dy),
                                t(dh), chunk)
    jz = jax.vjp(f, *(jnp.asarray(u) for u in (x, dt, a, bm, cm)),
                 jnp.zeros(h0.shape, jnp.float32))[1](
        (jnp.asarray(dy), jnp.asarray(dh)))
    assert max(dev(g, w) for g, w in zip(zero, jz)) <= 1e-5
