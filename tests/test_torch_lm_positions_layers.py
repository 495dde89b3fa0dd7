"""Explicit positions and a carried SSM state through the port's layers
on the CPU, against the JAX package: ``gqa_full``, ``mla_full`` and
``hymba_full`` at left-padded positions, ``mamba2_apply`` from a carried
state, and ``vmap(grad)`` with batched positions and ``h0`` against
per-client loops (the kernels' plain versions are in
``tests/test_torch_lm_positions.py``; bounds as there: 1e-5 for layers,
1e-6 for ``vmap`` against a loop)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as jattn
from repro.models.layers import hymba as jhymba
from repro.models.layers import mamba2 as jmamba
from repro.models.layers.rope import rope_angles as jrope_angles
from repro_torch.kernels import ops
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import hymba as thymba
from repro_torch.models.layers import mamba2 as tmamba
from repro_torch.models.layers.rope import rope_angles as trope_angles
from torch_lm_positions_common import left_pad_positions
from torch_lm_zoo_common import dev, reduced, t


def _tree(node):
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    return torch.from_numpy(np.array(node, dtype=np.float32))


@pytest.mark.parametrize("layer", ["gqa", "mla", "hymba"])
def test_full_layers_with_positions_match_reference(layer, rng):
    """``gqa_full`` (phi3), ``mla_full`` (minicpm3-4b) and ``hymba_full``
    at left-padded positions against the reference's layers, 1e-5 of each
    output's scale (hymba's SSM branch from a zero state in both)."""
    arch = {"gqa": "phi3-mini-3.8b", "mla": "minicpm3-4b",
            "hymba": "hymba-1.5b"}[layer]
    jc, tc = reduced(arch)
    b, s = 3, 80
    pos = left_pad_positions(b, s, (0, 7, 70))
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
    pos = torch.from_numpy(np.stack([left_pad_positions(b, s, (i, 2 * i))
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
