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

from repro.data import lm_data as jdata
from repro.models import transformer as jtfm
from repro.models.layers import attention as jattn
from repro.models.layers import hymba as jhymba
from repro.models.layers import mamba2 as jmamba
from repro.models.layers.rope import rope_angles as jrope_angles
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import hymba as thymba
from repro_torch.models.layers import mamba2 as tmamba
from repro_torch.models.layers.rope import rope_angles as trope_angles
from repro_torch.optim import optimizers as toptim
from torch_lm_zoo_common import (batch_j, batch_t, dev, model, pairs,
                                 reduced, t)

NEG_INF = -1e30
S = 128
# one batch row each: none, one, up to a tile's edge and past it, all but
# one token, and the whole row (every query attends nothing)
PADS = (0, 1, 63, 64, 65, S - 1, S)
MASKS = {"causal": (True, 0), "window": (True, 48), "full": (False, 0)}


def _tree(node):
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    return torch.from_numpy(np.array(node, dtype=np.float32))


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


def _left_pad_positions(b, s, pads):
    return np.stack([np.arange(s) - pads[i % len(pads)] for i in range(b)])


@pytest.mark.parametrize("layer", ["gqa", "mla", "hymba"])
def test_full_layers_with_positions_match_reference(layer, rng):
    """``gqa_full`` (phi3), ``mla_full`` (minicpm3-4b) and ``hymba_full``
    at left-padded positions against the reference's layers, 1e-5 of each
    output's scale (hymba's SSM branch from a zero state in both)."""
    arch = {"gqa": "phi3-mini-3.8b", "mla": "minicpm3-4b",
            "hymba": "hymba-1.5b"}[layer]
    jc, tc = reduced(arch)
    b, s = 3, 80
    pos = _left_pad_positions(b, s, (0, 7, 70))
    x = rng.standard_normal((b, s, jc.d_model)).astype(np.float32)
    head = jc.mla_rope_head_dim if layer == "mla" else jc.resolved_head_dim
    ja = jrope_angles(jnp.asarray(pos), head, jc.rope_theta)
    ta = trope_angles(t(pos), head, tc.rope_theta)
    key = jax.random.PRNGKey(7)
    if layer == "gqa":
        jp = jattn.gqa_init(key, jc)
        jout, jcache = jattn.gqa_full(jp, jc, jnp.asarray(x), ja,
                                      positions=jnp.asarray(pos))
        tout, tcache = tattn.gqa_full(_tree(jp), tc, t(x), ta,
                                      positions=t(pos))
    elif layer == "mla":
        jp = jattn.mla_init(key, jc)
        jout, jcache = jattn.mla_full(jp, jc, jnp.asarray(x), ja,
                                      positions=jnp.asarray(pos))
        tout, tcache = tattn.mla_full(_tree(jp), tc, t(x), ta,
                                      positions=t(pos))
    else:
        jp = jhymba.hymba_init(key, jc)
        jout, (jkv, jstate) = jhymba.hymba_full(jp, jc, jnp.asarray(x), ja,
                                                positions=jnp.asarray(pos))
        tout, (tkv, tstate) = thymba.hymba_full(_tree(jp), tc, t(x), ta,
                                                positions=t(pos))
        jcache, tcache = (*jkv, *jstate), (*tkv, *tstate)
    devs = [dev(tout, jout)] + [dev(a, w) for a, w in zip(tcache, jcache)]
    print(f"{layer}_full with positions: out and cache dev {devs}")
    assert max(devs) <= 1e-5


def test_mamba2_apply_with_a_carried_state_matches_reference(rng):
    """``mamba2_apply`` from ``ssm_state`` (and an ignored ``conv_state``)
    over a ragged sequence against the reference's: y and both states,
    and the gradient with respect to ``ssm_state``, 1e-5."""
    jc, tc = reduced("mamba2-1.3b")
    jp = jmamba.mamba2_init(jax.random.PRNGKey(4), jc)
    _, nh, conv_ch = tmamba.mamba2_dims(tc)
    b, s = 2, 96
    x = rng.standard_normal((b, s, jc.d_model)).astype(np.float32)
    state = 0.5 * rng.standard_normal(
        (b, nh, jc.ssm.head_dim, jc.ssm.state_dim)).astype(np.float32)
    conv = rng.standard_normal((b, jc.ssm.conv_width - 1, conv_ch)) \
        .astype(np.float32)
    wy = rng.standard_normal((b, s, jc.d_model)).astype(np.float32)
    wh = rng.standard_normal(state.shape).astype(np.float32)

    def jloss(st):
        y, (cs, hs) = jmamba.mamba2_apply(jp, jc, jnp.asarray(x),
                                          conv_state=jnp.asarray(conv),
                                          ssm_state=st)
        return jnp.sum(y * wy) + jnp.sum(hs * wh), (y, cs, hs)
    (jl, (jy, jcs, jhs)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(state))
    tp = _tree(jp)
    st = t(state).requires_grad_(True)
    y, (cs, hs) = tmamba.mamba2_apply(tp, tc, t(x), conv_state=t(conv),
                                      ssm_state=st)
    loss = torch.sum(y * t(wy)) + torch.sum(hs * t(wh))
    (grad,) = torch.autograd.grad(loss, st)
    devs = [dev(y, jy), dev(cs, jcs), dev(hs, jhs), dev(grad, jg)]
    print(f"mamba2_apply from ssm_state: y, conv, ssm, d ssm_state dev "
          f"{devs}")
    assert max(devs) <= 1e-5
    y0, _ = tmamba.mamba2_apply(tp, tc, t(x), ssm_state=t(state))
    assert torch.equal(y0, y.detach())      # conv_state is not read


# ---------------------------------------------------------------------------
# whole models: a left-padded batch through forward/prefill + 4 decode
# steps and train_loss with every gradient leaf, 2e-4
# ---------------------------------------------------------------------------
MODELS = ["phi3-mini-3.8b", "hymba-1.5b", "minicpm3-4b", "qwen2-vl-7b",
          "qwen3-moe-235b-a22b", "hubert-xlarge"]
PROMPT, STEPS = 24, 4


@pytest.mark.parametrize("arch", MODELS)
def test_left_padded_models_match_reference(arch):
    """A batch with ``positions = arange(S) - pad`` (pads 0, 5 and 17; a
    VLM batch's patches and M-RoPE streams, hubert's frames) through the
    port and the reference: prefill logits and cache, then four decode
    steps (hubert: the encoder's forward), and ``train_loss`` with every
    gradient leaf, within 2e-4."""
    jc, tc, jp, tp = model(arch, seed=2)
    b = 3
    batch = jdata.synthetic_lm_batch(jc, b, PROMPT, seed=6)
    batch["positions"] = _left_pad_positions(b, PROMPT, (0, 5, 17))
    devs = {}
    if not jc.encoder_only:
        toks = np.random.default_rng(8).integers(0, jc.vocab_size,
                                                 (b, STEPS))
        cut = {k: v for k, v in batch.items()
               if k not in ("labels", "loss_mask")}
        jl, jcache = jtfm.prefill(jp, jc, batch_j(cut), dtype=jnp.float32,
                                  max_len=PROMPT + STEPS)
        tl, tcache = ttfm.prefill(tp, tc, batch_t(cut), dtype=torch.float32,
                                  max_len=PROMPT + STEPS)
        devs["prefill"] = dev(tl, jl)
        for key in jcache:
            if key != "pos":
                devs[key] = dev(tcache[key], jcache[key])
        for i in range(STEPS):
            step = toks[:, i:i + 1]
            jl, jcache = jtfm.decode_step(jp, jc, jcache,
                                          jnp.asarray(step, jnp.int32),
                                          dtype=jnp.float32)
            tl, tcache = ttfm.decode_step(tp, tc, tcache, t(step),
                                          dtype=torch.float32)
            devs[f"decode{i}"] = dev(tl, jl)
    else:
        jl, _ = jtfm.forward_train(jp, jc, batch_j(batch), dtype=jnp.float32)
        tl, _ = ttfm.forward_train(tp, tc, batch_t(batch),
                                   dtype=torch.float32)
        devs["forward"] = dev(tl, jl)
    jloss, jg = jax.value_and_grad(
        lambda p: jtfm.train_loss(p, jc, batch_j(batch),
                                  dtype=jnp.float32))(jp)
    for leaf in toptim.tree_leaves(tp):
        leaf.requires_grad_(True)
    tloss = ttfm.train_loss(tp, tc, batch_t(batch), dtype=torch.float32)
    tloss.backward()
    gdevs = {path: dev(u.grad, w) for path, w, u in pairs(jg, tp)}
    worst = max(gdevs, key=gdevs.get)
    print(f"{arch} left-padded: {devs}; train_loss {tloss.item()} vs "
          f"{float(jloss)}, {len(gdevs)} gradient leaves, worst {worst} "
          f"{gdevs[worst]:.3e}")
    assert max(devs.values()) <= 2e-4
    assert abs(float(tloss) - float(jloss)) <= 2e-4 * abs(float(jloss))
    assert len(gdevs) == len(toptim.tree_leaves(tp))
    assert max(gdevs.values()) <= 2e-4


# ---------------------------------------------------------------------------
# vmap(grad) with batched positions and h0, against per-client loops
# ---------------------------------------------------------------------------
def test_vmap_grad_with_batched_positions_matches_a_loop():
    """``vmap(grad)`` through ``ops.flash_attention`` with each client's
    own left pads (positions (K, B, S), folded with q, k, v into one call)
    equals a loop of per-client ``torch.func.grad``, 1e-6."""
    g = np.random.default_rng(3)
    kc, b, s, h, hkv, d = 3, 2, 24, 4, 2, 32

    def r(*shape):
        return torch.tensor(g.standard_normal(shape), dtype=torch.float32)
    q, k, v, w = r(kc, b, s, h, d), r(kc, b, s, hkv, d), r(b, s, hkv, d), \
        r(kc, b, s, h, d)
    pos = torch.from_numpy(np.stack([_left_pad_positions(b, s, (i, 2 * i))
                                     for i in range(kc)]))

    def f(q, k, v, pos, w):
        return torch.sum(ops.flash_attention(q, k, v, causal=True, window=8,
                                             q_pos=pos, k_pos=pos) * w)
    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)),
                          in_dims=(0, 0, None, 0, 0))(q, k, v, pos, w)
    for i in range(kc):
        want = torch.func.grad(f, argnums=(0, 1, 2))(q[i], k[i], v, pos[i],
                                                      w[i])
        for a, e in zip(got, want):
            assert float((a[i] - e).abs().max()) <= 1e-6


def test_vmap_grad_with_batched_h0_matches_a_loop():
    """``vmap(grad)`` through ``ops.ssd_scan`` with each client's own
    ``h0`` (and decay ``a``) equals a loop of per-client
    ``torch.func.grad``, ``dh0`` included, 1e-6."""
    g = np.random.default_rng(4)
    kc, b, s, h, p, n = 3, 2, 24, 3, 16, 8

    def r(*shape, lo=None, hi=None):
        x = g.standard_normal(shape) if lo is None \
            else g.uniform(lo, hi, shape)
        return torch.tensor(x, dtype=torch.float32)
    x, dt, a = r(kc, b, s, h, p), r(kc, b, s, h, lo=0.01, hi=0.2), \
        r(kc, h, lo=-2.0, hi=-0.5)
    bb, cc, h0 = r(b, s, n), r(kc, b, s, n), r(kc, b, h, p, n)
    wy, wh = r(kc, b, s, h, p), r(kc, b, h, p, n)

    def f(x, dt, a, b, c, h0, wy, wh):
        y, h_last = ops.ssd_scan(x, dt, a, b, c, chunk=8, h0=h0)
        return torch.sum(y * wy) + torch.sum(h_last * wh)
    args = (0, 1, 2, 3, 4, 5)
    got = torch.func.vmap(torch.func.grad(f, argnums=args),
                          in_dims=(0, 0, 0, None, 0, 0, 0, 0))(
        x, dt, a, bb, cc, h0, wy, wh)
    for i in range(kc):
        want = torch.func.grad(f, argnums=args)(
            x[i], dt[i], a[i], bb, cc[i], h0[i], wy[i], wh[i])
        for u, e in zip(got, want):
            assert float((u[i] - e).abs().max()) <= 1e-6
