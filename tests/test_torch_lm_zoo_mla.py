"""MLA (minicpm3-4b's multi-head latent attention) in the port against the
JAX package, at reduced width (q/k head dim 64 + 16 rope channels = 80,
v head dim 64): ``mla_full`` through B5's plain version with a value
head dim of its own (1e-5), prefill plus four decode steps with the
expanded and the absorbed decode (2e-4), the absorbed decode against the
full forward as the reference's own test holds it, ``train_loss`` and
every gradient leaf (2e-4), the serve launcher's tokens, and B5's plain
forward and backward at (80, 64) and (96, 64) against ``jax.vjp`` of the
reference's ``chunked_attention`` (2e-5, abs + rel).  Set-up shared with
``test_torch_lm_zoo.py`` in ``torch_lm_zoo_common.py``.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm_data as jdata
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro.models.layers import attention as jattn
from repro.models.layers import rope as jrope
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import rope as trope
from repro_torch.optim import optimizers as toptim
from torch_lm_zoo_common import (DECODE_STEPS, PROMPT, batch_j, batch_t, dev,
                                 model, pairs, perturbed, prefill_and_decode,
                                 reduced, t, tokens)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_full_matches_reference(absorb, rng):
    jc, tc = reduced("minicpm3-4b")
    jc = dataclasses.replace(jc, mla_absorb=absorb)
    tc = dataclasses.replace(tc, mla_absorb=absorb)
    jp = perturbed(jattn.mla_init(jax.random.PRNGKey(3), jc), 3)
    b, s = 2, PROMPT
    x = rng.standard_normal((b, s, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    ja = jrope.rope_angles(jnp.asarray(pos), jc.mla_rope_head_dim,
                           jc.rope_theta)
    ta = trope.rope_angles(t(pos), tc.mla_rope_head_dim, tc.rope_theta)
    jout, (jckv, jkr) = jattn.mla_full(jp, jc, jnp.asarray(x), ja,
                                       positions=jnp.asarray(pos),
                                       causal=True)
    tout, (tckv, tkr) = tattn.mla_full(
        jax.tree_util.tree_map(t, jp), tc, t(x), ta)
    devs = [dev(tout, jout), dev(tckv, jckv), dev(tkr, jkr)]
    print(f"mla_full absorb={absorb}: out/ckv/kr dev {devs}")
    assert max(devs) <= 1e-5


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_prefill_and_decode_match_reference(absorb):
    jc, tc, jp, tp = model("minicpm3-4b", cfg_change={"mla_absorb": absorb})
    toks = tokens(jc, 2, PROMPT + DECODE_STEPS)
    devs, _, tcache = prefill_and_decode(jc, tc, jp, tp, toks)
    print(f"prefill+decode minicpm3 absorb={absorb}: {devs}")
    assert set(tcache) == {"ckv", "kr", "pos"}
    assert tcache["ckv"].shape == (tc.num_layers, 2, PROMPT + DECODE_STEPS,
                                   tc.mla_kv_lora_rank)
    assert tcache["kr"].shape[-1] == tc.mla_rope_head_dim
    assert max(devs.values()) <= 2e-4


def test_mla_absorbed_decode_equals_the_expanded_one():
    """As ``tests/test_decode_consistency.py`` holds the reference: the
    absorbed decode's logits against the full forward's at the same
    positions (rtol = atol = 2e-4), and against the expanded decode."""
    jc, tc, jp, tp = model("minicpm3-4b", seed=1)
    tc_a = dataclasses.replace(tc, mla_absorb=True)
    s = 17
    toks = t(tokens(tc, 2, s + 3))
    full, _ = ttfm.forward_train(tp, tc, {"tokens": toks},
                                 dtype=torch.float32)
    _, cache_a = ttfm.prefill(tp, tc_a, {"tokens": toks[:, :s]},
                              dtype=torch.float32, max_len=s + 3)
    _, cache_e = ttfm.prefill(tp, tc, {"tokens": toks[:, :s]},
                              dtype=torch.float32, max_len=s + 3)
    for i in range(3):
        step = toks[:, s + i:s + i + 1]
        la, cache_a = ttfm.decode_step(tp, tc_a, cache_a, step,
                                       dtype=torch.float32)
        le, cache_e = ttfm.decode_step(tp, tc, cache_e, step,
                                       dtype=torch.float32)
        np.testing.assert_allclose(full[:, s + i].numpy(),
                                   la[:, 0].numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(le[:, 0].numpy(), la[:, 0].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_mla_train_loss_and_grads_match_reference():
    """Through B5's plain forward and backward at (80, 64) on the CPU."""
    jc, tc, jp, tp = model("minicpm3-4b", seed=3)
    batch = jdata.synthetic_lm_batch(jc, 2, 40, seed=4)
    jl, jg = jax.value_and_grad(
        lambda p: jtfm.train_loss(p, jc, batch_j(batch),
                                  dtype=jnp.float32))(jp)
    for leaf in toptim.tree_leaves(tp):
        leaf.requires_grad_(True)
    tl = ttfm.train_loss(tp, tc, batch_t(batch), dtype=torch.float32)
    tl.backward()
    devs = {path: dev(tt.grad, w) for path, w, tt in pairs(jg, tp)}
    worst = max(devs, key=devs.get)
    print(f"train_loss minicpm3: {float(tl)} vs {float(jl)}; {len(devs)} "
          f"gradient leaves, worst {worst} {devs[worst]:.3e}")
    assert abs(float(tl) - float(jl)) <= 2e-4 * abs(float(jl))
    assert len(devs) == len(toptim.tree_leaves(tp))
    assert max(devs.values()) <= 2e-4


# ---------------------------------------------------------------------------
# B5's plain versions with a value head dim of its own
# ---------------------------------------------------------------------------
DV_CASES = [  # (b, s, hq, hkv, dqk, dv, causal, window)
    (2, 70, 4, 2, 80, 64, True, 0),     # minicpm3's reduced pair, GQA,
                                        # ragged over the chunks
    (1, 50, 3, 1, 96, 64, False, 8),    # its width pair, MQA,
                                        # bidirectional window
]


def _close(got, want, tol):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return bool(np.all(np.abs(got - want) <= tol + tol * np.abs(want)))


@pytest.mark.parametrize("case", DV_CASES)
def test_flash_attention_ref_with_dv_matches_jax_vjp(case, rng):
    b, s, hq, hkv, dqk, dv, causal, window = case
    q = rng.standard_normal((b, s, hq, dqk)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dqk)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dv)).astype(np.float32)
    dout = rng.standard_normal((b, s, hq, dv)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))

    def f(q, k, v):
        return jattn.chunked_attention(q, k, v, pos, pos, causal=causal,
                                       window=window, scale=dqk ** -0.5,
                                       chunk=16)
    out, vjp = jax.vjp(f, q, k, v)
    want = vjp(jnp.asarray(dout))
    o, lse = ref.flash_attention_fwd_ref(t(q), t(k), t(v), causal=causal,
                                         window=window)
    got = ref.flash_attention_bwd_ref(t(q), t(k), t(v), o, lse, t(dout),
                                      causal=causal, window=window, chunk=16)
    devs = [dev(o, out)] + [dev(g, w) for g, w in zip(got, want)]
    print(f"B5 plain with Dv vs jax {case}: out, dq, dk, dv {devs}")
    assert o.shape == (b, s, hq, dv) and _close(o, out, 2e-5)
    for g, w in zip(got, want):
        assert _close(g, w, 2e-5)
    # the autograd Function over the plain versions gives the same
    qt, kt, vt = (t(a).requires_grad_(True) for a in (q, k, v))
    ops.flash_attention(qt, kt, vt, causal=causal, window=window
                        ).backward(t(dout))
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        assert _close(g, w, 2e-5)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("absorb", [False, True])
def test_mla_serve_generates_the_reference_tokens(absorb, monkeypatch):
    """minicpm3's expanded decode, and the absorbed one under
    ``mla_absorb`` (both packages read the flag from the config)."""
    args = argparse.Namespace(arch="minicpm3-4b", reduced=True, batch=2,
                              prompt_len=PROMPT, max_new=5, seed=3,
                              device="cpu")
    if absorb:
        from repro.configs import ARCHS as JARCHS
        from repro_torch.configs import ARCHS as TARCHS
        for archs in (JARCHS, TARCHS):
            cfg = archs["minicpm3-4b"]
            monkeypatch.setitem(archs, "minicpm3-4b",
                                dataclasses.replace(cfg, mla_absorb=True))
    want = jserve.serve(args)
    jc, tc = reduced("minicpm3-4b")
    assert jc.mla_absorb == tc.mla_absorb == absorb
    tree = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(args.seed), jc))
    got = tserve.serve(args, params=ttfm.params_from_reference(tree, tc))
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))
