"""The Mixture-of-Experts half of the LM zoo in the port against the JAX
package, at reduced width: qwen3-moe-235b-a22b (top-2 of 4 experts,
every layer MoE) and llama4-maverick-400b-a17b (top-1 of 4 with a
shared expert, dense and MoE layers interleaved in units).

``moe_apply`` within 1e-5 (with drops, with most tokens dropped,
without drops, with every probability tied, top-1 with the shared
expert); each model's forward logits and aux, prefill and four decode
steps, ``train_loss`` and every gradient leaf within 2e-4; inits from
the seed within 4 ulps; the bf16 init bitwise the cast of the fp32 init
for every arch; the unit tree's round trip through the flat form; the
serve launcher's tokens.  The reference's trees are carried in with
``params_from_reference`` after their norm scales are redrawn
(``torch_lm_zoo_common.py``).  Run with ``-s`` to print every measured
deviation.  The federated rounds and the launcher's step are in
``test_torch_lm_moe_federation.py``.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import lm_data as jdata
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro.models.layers import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.core import prng
from repro_torch.launch import serve as tserve
from repro_torch.models import agreement
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import moe as tmoe
from repro_torch.optim import optimizers as toptim
from torch_lm_zoo_common import (DECODE_STEPS, PROMPT, batch_j, batch_t,
                                 dev, model, pairs, prefill_and_decode, t,
                                 tokens)

MOE = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]


def _with_moe(arch, **moe):
    jc, tc = jget_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


# ---------------------------------------------------------------------------
# the block: 1e-5
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape,moe,zero_router", [
    pytest.param(MOE[0], (2, 8), {}, False, id="qwen3-2x8"),
    pytest.param(MOE[0], (4, 64), {}, False, id="qwen3-4x64"),
    pytest.param(MOE[0], (1, 64), {"capacity_factor": 0.01, "top_k": 1},
                 False, id="qwen3-most-drop"),
    pytest.param(MOE[0], (2, 8), {"capacity_factor": 64.0}, False,
                 id="qwen3-no-drop"),
    pytest.param(MOE[0], (4, 64), {}, True, id="qwen3-all-tie"),
    pytest.param(MOE[1], (4, 64), {}, False, id="llama4-shared"),
])
def test_moe_apply_matches_reference(arch, shape, moe, zero_router, rng):
    """Outputs within 1e-5 of their scale and the aux within 1e-6; the
    drops the case is built for happen (or do not); with every
    probability tied (a zero router) the lower expert wins, as in
    ``jax.lax.top_k``, and the aux is 1.0; without drops the block is the
    plain dense top-k mixture."""
    jc, tc = _with_moe(arch, **moe)
    p = jax.tree_util.tree_map(np.asarray,
                               jmoe.moe_init(jax.random.PRNGKey(0), jc))
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    x = rng.standard_normal(shape + (jc.d_model,)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(p, jc, jnp.asarray(x))
    tp = jax.tree_util.tree_map(lambda a: t(np.array(a)), p)
    with tmoe.record_routes() as routes:
        ty, taux = tmoe.moe_apply(tp, tc, t(x))
    kept = routes[0]["kept"]
    d = dev(ty, jy)
    print(f"moe_apply {arch} {shape} {moe} zero router {zero_router}: dev "
          f"{d:.3e}, aux {float(taux)} vs {float(jaux)}, kept "
          f"{int(kept.sum())} of {kept.numel()}")
    assert d <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-6
    cf = tc.moe.capacity_factor
    if cf >= 64:
        assert bool(kept.all())
        plain = agreement.dense_mixture(tp, tc, t(x))
        assert dev(ty, plain.numpy()) <= 1e-5
    elif cf < 0.1:
        assert tmoe.capacity(64, tc) == 1 and float(kept.float().mean()) < 0.1
    if zero_router:
        assert float(taux) == pytest.approx(1.0, abs=1e-6)
        want = torch.arange(tc.moe.top_k).expand_as(routes[0]["experts"])
        assert torch.equal(routes[0]["experts"], want)


# ---------------------------------------------------------------------------
# the model: 2e-4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_moe_model_matches_reference(arch):
    """``forward_train``'s logits and summed aux, then prefill and four
    teacher-forced decode steps (the cache of a llama4 unit under ``k, v,
    k2, v2``, one entry a unit)."""
    jc, tc, jp, tp = model(arch)
    assert len(tp["layers"]) == ttfm.num_units(tc) \
        == jax.tree_util.tree_leaves(jp["layers"])[0].shape[0]
    toks = tokens(jc, 2, PROMPT + DECODE_STEPS)
    devs, jcache, tcache = prefill_and_decode(jc, tc, jp, tp, toks)
    fb = {"tokens": toks[:, :PROMPT]}
    jl, jaux = jtfm.forward_train(jp, jc, batch_j(fb), dtype=jnp.float32)
    tl, taux = ttfm.forward_train(tp, tc, batch_t(fb), dtype=torch.float32)
    devs["forward"] = dev(tl, jl)
    print(f"{arch}: {devs}, aux {float(taux)} vs {float(jaux)}")
    assert max(devs.values()) <= 2e-4
    assert abs(float(taux) - float(jaux)) <= 2e-4 * abs(float(jaux))
    assert set(tcache) == set(jcache)
    assert tcache["k"].shape[0] == ttfm.num_units(tc)


@pytest.mark.parametrize("arch", MOE)
def test_moe_train_loss_and_grads_match_reference(arch):
    """``train_loss`` (the token loss plus ``router_aux_weight`` x aux)
    and its gradient on every leaf, experts and router included;
    ``train_loss_sum`` with a padded row."""
    jc, tc, jp, tp = model(arch, seed=3)
    batch = jdata.synthetic_lm_batch(jc, 2, 40, seed=4)
    jl, jg = jax.value_and_grad(
        lambda p: jtfm.train_loss(p, jc, batch_j(batch),
                                  dtype=jnp.float32))(jp)
    for leaf in toptim.tree_leaves(tp):
        leaf.requires_grad_(True)
    tl = ttfm.train_loss(tp, tc, batch_t(batch), dtype=torch.float32)
    tl.backward()
    devs = {path: dev(leaf.grad, w) for path, w, leaf in pairs(jg, tp)}
    worst = max(devs, key=devs.get)
    print(f"train_loss {arch}: {tl.item()} vs {float(jl)}; {len(devs)} "
          f"gradient leaves, worst {worst} {devs[worst]:.3e}")
    assert abs(float(tl) - float(jl)) <= 2e-4 * abs(float(jl))
    assert len(devs) == len(toptim.tree_leaves(tp))
    assert max(devs.values()) <= 2e-4
    batch["doc_mask"] = np.array([1.0, 0.0], np.float32)
    s, n = ttfm.train_loss_sum(tp, tc, batch_t(batch), dtype=torch.float32)
    js, jn = jtfm.train_loss_sum(jp, jc, batch_j(batch), dtype=jnp.float32)
    assert float(n) == float(jn) and abs(float(s) - float(js)) \
        <= 2e-4 * abs(float(js))


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_then_decode_matches_forward(arch):
    """The port's own serving path (``tests/test_decode_consistency.py``'s
    check): at capacity_factor 16 nothing drops, so prefill plus three
    decode steps reproduce the full forward within 2e-4."""
    _, tc = _with_moe(arch, capacity_factor=16.0)
    params = ttfm.init_params(prng.PRNGKey(1), tc)
    s = 17
    toks = t(np.random.default_rng(0).integers(0, tc.vocab_size, (2, s + 3)))
    with torch.no_grad():
        full, _ = ttfm.forward_train(params, tc, {"tokens": toks},
                                     dtype=torch.float32)
        logits, cache = ttfm.prefill(params, tc, {"tokens": toks[:, :s]},
                                     dtype=torch.float32, max_len=s + 3)
        torch.testing.assert_close(logits, full[:, :s], rtol=2e-4,
                                   atol=2e-4)
        for i in range(3):
            step, cache = ttfm.decode_step(params, tc, cache,
                                           toks[:, s + i:s + i + 1],
                                           dtype=torch.float32)
            torch.testing.assert_close(step[:, 0], full[:, s + i],
                                       rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# init and the flat form
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_moe_init_is_the_references(arch):
    """Every leaf within 4 ulps (the unit tree of llama4, the experts'
    fan-in E), and ``stack_layers`` gives the reference's flattened paths
    in its order; ``unstack_layers`` gives the unit tree back."""
    jc, tc = jget_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    want = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(11), jc))
    flat = {".".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    tree = ttfm.init_params(prng.PRNGKey(11), tc)
    got = ttfm.stack_layers(tree)
    assert list(got) == list(flat)
    for name, g in got.items():
        w = np.asarray(flat[name], np.float32)
        assert g.shape == w.shape, name
        ulps = np.abs(g.numpy().view(np.int32).astype(np.int64)
                      - w.view(np.int32).astype(np.int64))
        assert ulps.max() <= 4, (name, int(ulps.max()))
    e = tc.moe.num_experts
    w_gate = got["layers.moe_sub.ffn.w_gate" if arch == MOE[1]
                 else "layers.ffn.w_gate"]
    assert w_gate.shape[1:] == (e, tc.d_model, tc.d_ff)
    # fan-in E: the experts' std is E**-0.5, not d_model**-0.5
    assert 1.5 * e ** -0.5 < float(w_gate.abs().max()) <= 2 * e ** -0.5
    back = ttfm.unstack_layers(got)
    assert len(back["layers"]) == ttfm.num_units(tc)
    assert ttfm.stack_layers(back).keys() == got.keys()
    for name in got:
        assert torch.equal(ttfm.stack_layers(back)[name], got[name])


@pytest.mark.parametrize("arch", [a for a, c in tconfigs.ARCHS.items()
                                  if c.kind != "ntm"])
def test_bf16_init_is_the_cast_of_the_fp32_init(arch, monkeypatch):
    """``init_params(dtype=bf16)`` draws the cast leaves straight into
    bf16, chunk by chunk: bitwise ``activation_copy`` of the fp32 init
    (chunks of 4096 entries here, so every weight crosses chunk edges);
    the router and the norm scales stay fp32."""
    cfg = tconfigs.get_config(arch).reduced()
    want = ttfm.stack_layers(ttfm.activation_copy(
        ttfm.init_params(prng.PRNGKey(3), cfg), cfg, torch.bfloat16))
    monkeypatch.setattr(prng, "_CHUNK", 4096)
    got = ttfm.stack_layers(ttfm.init_params(prng.PRNGKey(3), cfg,
                                             dtype=torch.bfloat16))
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    assert any(v.dtype == torch.bfloat16 for v in got.values())
    for name, v in got.items():
        if name.endswith(("router", "scale")):
            assert v.dtype == torch.float32, name


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_moe_serve_generates_the_reference_tokens():
    """llama4's units through ``launch.serve`` (reduced, fp32): the
    reference's greedy tokens from the reference's weights."""
    arch = MOE[1]
    args = argparse.Namespace(arch=arch, reduced=True, batch=2,
                              prompt_len=PROMPT, max_new=5, seed=3,
                              device="cpu")
    want = jserve.serve(args)
    jc, tc = jget_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(args.seed), jc))
    got = tserve.serve(args, params=ttfm.params_from_reference(tree, tc))
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))
