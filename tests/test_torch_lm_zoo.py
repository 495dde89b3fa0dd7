"""The dense half of the LM zoo in the port against the JAX package, at
reduced width: granite-34b (MQA), qwen1.5-110b (q/k/v biases),
qwen2-vl-7b (M-RoPE, the patch merge) and hubert-xlarge (the audio
encoder: LayerNorm, the tanh GELU MLP, bidirectional attention).  MLA
(minicpm3-4b) is in ``test_torch_lm_zoo_mla.py``; the set-up is shared in
``torch_lm_zoo_common.py``.

Layers within 1e-6, attention within 1e-5, prefill plus four decode
steps (hubert: the forward) within the repo's 2e-4 bound of this path,
``train_loss`` and every gradient leaf within 2e-4, inits from the seed
within 4 ulps, the audio and VLM batches bitwise, and the serve
launcher's tokens equal to the reference's.  The port's kernels take
their plain versions here (CPU tensors); the card holds the kernels
against those (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Run
with ``-s`` to print every measured deviation.
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
from repro.models.layers import attention as jattn
from repro.models.layers import embedding as jemb
from repro.models.layers import mlp as jmlp
from repro.models.layers import norms as jnorms
from repro.models.layers import rope as jrope
from repro_torch import configs as tconfigs
from repro_torch.core import prng
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import embedding as temb
from repro_torch.models.layers import mlp as tmlp
from repro_torch.models.layers import norms as tnorms
from repro_torch.models.layers import rope as trope
from repro_torch.optim import optimizers as toptim
from torch_lm_zoo_common import (DECODE_STEPS, GQA_ZOO, PROMPT, ZOO,
                                 batch_j, batch_t, dev, model, pairs,
                                 perturbed, prefill_and_decode, reduced, t,
                                 tokens)

# reference fields the port leaves out (test_torch_lm.py says why)
OMITTED = {"scan_layers", "unroll_chunks"}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("is_reduced", [False, True])
def test_zoo_config_parity(arch, is_reduced):
    """Field for field, ``num_params`` and the derived head sizes; the
    reduced configs (MLA ranks, M-RoPE sections, the frontend width) by
    the reference's ``reduced()`` rule."""
    jc, tc = jget_config(arch), tconfigs.get_config(arch)
    if is_reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jf = {f.name for f in dataclasses.fields(jc)}
    tf = {f.name for f in dataclasses.fields(tc)}
    assert tf | OMITTED == jf and not tf & OMITTED
    for name in tf:
        want, got = getattr(jc, name), getattr(tc, name)
        if dataclasses.is_dataclass(want):
            want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert got == want, name
    assert tc.num_params() == jc.num_params()
    assert tc.resolved_head_dim == jc.resolved_head_dim
    assert tc.q_per_kv == jc.q_per_kv


# ---------------------------------------------------------------------------
# layers: 1e-6
# ---------------------------------------------------------------------------
def test_layernorm_matches_reference(rng):
    x = (3.0 + 2.0 * rng.standard_normal((2, 9, 64))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    want = jnorms.layernorm(p, jnp.asarray(x), 1e-5)
    got = tnorms.layernorm({k: t(v) for k, v in p.items()}, t(x), 1e-5)
    d = dev(got, want)
    print(f"layernorm: dev {d:.3e}")
    assert d <= 1e-6
    init = tnorms.layernorm_init(64, device="cpu")
    assert torch.equal(init["scale"], torch.ones(64)) \
        and torch.equal(init["bias"], torch.zeros(64))


def test_gelu_mlp_matches_reference(rng):
    """``jax.nn.gelu``'s default tanh approximation, with both biases."""
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray, jmlp.gelu_mlp_init(
        jax.random.PRNGKey(2), 32, 48))
    p = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in p.items()}
    want = jmlp.gelu_mlp(p, jnp.asarray(x))
    got = tmlp.gelu_mlp({k: t(v) for k, v in p.items()}, t(x))
    d = dev(got, want)
    print(f"gelu_mlp: dev {d:.3e}")
    assert d <= 1e-6


@pytest.mark.parametrize("arch", ["qwen2-vl-7b"])
@pytest.mark.parametrize("is_reduced", [False, True])
def test_mrope_angles_match_reference(arch, is_reduced, rng):
    """Three streams on their sections; text positions give RoPE."""
    cfg = tconfigs.get_config(arch)
    cfg = cfg.reduced() if is_reduced else cfg
    hd = cfg.resolved_head_dim
    pos = rng.integers(0, 500, (3, 2, 11)).astype(np.int32)
    want = jrope.mrope_angles(jnp.asarray(pos), hd, cfg.rope_theta,
                              cfg.mrope_sections)
    got = trope.mrope_angles(t(pos), hd, cfg.rope_theta, cfg.mrope_sections)
    d = dev(got, want)
    text = t(np.broadcast_to(np.arange(11), (2, 11)))
    same = trope.mrope_angles(trope.text_mrope_positions(text), hd,
                              cfg.rope_theta, cfg.mrope_sections)
    print(f"mrope_angles {cfg.mrope_sections}: dev {d:.3e}")
    assert d <= 1e-6
    assert torch.equal(same, trope.rope_angles(text, hd, cfg.rope_theta))
    with pytest.raises(ValueError, match="sum"):
        trope.mrope_angles(t(pos), hd + 2, cfg.rope_theta,
                           cfg.mrope_sections)


def test_merge_patch_embeds_matches_reference(rng):
    """A negative position is no patch (slot 0's token survives), two
    patches on one slot add up, a patch replaces its slot's token."""
    b, s, p, d = 2, 12, 5, 16
    tok = rng.standard_normal((b, s, d)).astype(np.float32)
    patches = rng.standard_normal((b, p, d)).astype(np.float32)
    pos = np.array([[3, -1, 7, 7, 11], [-1, -5, 0, 4, 4]], np.int32)
    want = jemb.merge_patch_embeds(jnp.asarray(tok), jnp.asarray(patches),
                                   jnp.asarray(pos))
    got = temb.merge_patch_embeds(t(tok), t(patches), t(pos))
    d_ = dev(got, want)
    print(f"merge_patch_embeds: dev {d_:.3e}")
    assert d_ <= 1e-6
    g = got.numpy()
    np.testing.assert_array_equal(g[0, 0], tok[0, 0])     # -1 -> no patch
    np.testing.assert_allclose(g[0, 7], patches[0, 2] + patches[0, 3],
                               rtol=1e-6)
    np.testing.assert_array_equal(g[1, 0], patches[1, 2])  # slot 0 patched


def test_masked_prediction_embed_matches_reference(rng):
    frames = rng.standard_normal((2, 10, 8)).astype(np.float32)
    mask = rng.random((2, 10)) < 0.3
    emb = rng.standard_normal(8).astype(np.float32)
    want = jemb.masked_prediction_embed({"mask_embed": jnp.asarray(emb)},
                                        jnp.asarray(frames),
                                        jnp.asarray(mask))
    got = temb.masked_prediction_embed({"mask_embed": t(emb)}, t(frames),
                                       t(mask))
    assert dev(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# attention with biases (and M-RoPE angles): 1e-5
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", GQA_ZOO)
def test_gqa_full_with_biases_matches_reference(arch, rng):
    jc, tc = reduced(arch)
    jp = perturbed(jattn.gqa_init(jax.random.PRNGKey(3), jc), 3)
    assert ("bq" in jp) == jc.qkv_bias
    b, s = 2, PROMPT
    x = rng.standard_normal((b, s, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    hd = jc.resolved_head_dim
    if jc.use_mrope:
        mpos = rng.integers(0, 64, (3, b, s)).astype(np.int32)
        ja = jrope.mrope_angles(jnp.asarray(mpos), hd, jc.rope_theta,
                                jc.mrope_sections)
        ta = trope.mrope_angles(t(mpos), hd, tc.rope_theta,
                                tc.mrope_sections)
    else:
        ja = jrope.rope_angles(jnp.asarray(pos), hd, jc.rope_theta)
        ta = trope.rope_angles(t(pos), hd, tc.rope_theta)
    jout, (jk, jv) = jattn.gqa_full(jp, jc, jnp.asarray(x), ja,
                                    positions=jnp.asarray(pos), causal=True)
    tout, (tk, tv) = tattn.gqa_full({k: t(v) for k, v in jp.items()}, tc,
                                    t(x), ta)
    devs = [dev(tout, jout), dev(tk, jk), dev(tv, jv)]
    print(f"gqa_full {arch}: out/k/v dev {devs}")
    assert max(devs) <= 1e-5


# ---------------------------------------------------------------------------
# the model: prefill + decode, the VLM batch, the audio encoder: 2e-4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", GQA_ZOO)
def test_zoo_prefill_and_decode_match_reference(arch):
    jc, tc, jp, tp = model(arch)
    toks = tokens(jc, 2, PROMPT + DECODE_STEPS)
    devs, _, tcache = prefill_and_decode(jc, tc, jp, tp, toks)
    print(f"prefill+decode {arch}: {devs}")
    assert tcache["k"].shape == (tc.num_layers, 2, PROMPT + DECODE_STEPS,
                                 tc.num_kv_heads, tc.resolved_head_dim)
    assert max(devs.values()) <= 2e-4


def test_vlm_batch_prefill_and_forward_match_reference(rng):
    """qwen2-vl with a ``synthetic_lm_batch`` VLM batch (patch embeds at
    their positions) and M-RoPE streams that differ by section."""
    jc, tc, jp, tp = model("qwen2-vl-7b", seed=2)
    batch = jdata.synthetic_lm_batch(jc, 2, PROMPT, seed=5)
    batch["mrope_positions"] = rng.integers(
        0, PROMPT, (3, 2, PROMPT)).astype(np.int32)
    extra = {k: batch[k] for k in ("patch_embeds", "patch_positions",
                                   "mrope_positions")}
    toks = np.concatenate([batch["tokens"],
                           tokens(jc, 2, DECODE_STEPS, seed=6)], axis=1)
    devs, _, _ = prefill_and_decode(jc, tc, jp, tp, toks, batch=extra)
    jl, _ = jtfm.forward_train(jp, jc, batch_j(batch), dtype=jnp.float32)
    tl, _ = ttfm.forward_train(tp, tc, batch_t(batch), dtype=torch.float32)
    devs["forward"] = dev(tl, jl)
    plain, _ = ttfm.forward_train(tp, tc, {"tokens": t(batch["tokens"])},
                                  dtype=torch.float32)
    print(f"VLM batch qwen2-vl: {devs}")
    assert max(devs.values()) <= 2e-4
    assert float((plain - tl).abs().max()) > 1e-3   # the merge and M-RoPE act


def test_hubert_forward_matches_reference():
    """The encoder: frame projection, masked frames, position embedding,
    LayerNorm, GELU, bidirectional B5, the prediction head."""
    jc, tc, jp, tp = model("hubert-xlarge", seed=2)
    batch = jdata.synthetic_lm_batch(jc, 2, PROMPT, seed=3)
    jl, jaux = jtfm.forward_train(jp, jc, batch_j(batch), dtype=jnp.float32)
    tl, taux = ttfm.forward_train(tp, tc, batch_t(batch),
                                  dtype=torch.float32)
    d = dev(tl, jl)
    print(f"forward hubert: logits {tuple(tl.shape)} dev {d:.3e}")
    assert tl.shape == (2, PROMPT, tc.vocab_size) and float(taux) == 0.0
    assert d <= 2e-4
    causal = dataclasses.replace(tc, encoder_only=False)
    tc_logits, _ = ttfm.forward_train(tp, causal, batch_t(batch),
                                      dtype=torch.float32)
    assert float((tc_logits - tl).abs().max()) > 1e-3   # bidirectional


def test_encoder_only_has_no_decode_path():
    _, tc, _, tp = model("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        ttfm.init_cache(tc, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        ttfm.prefill(tp, tc, {"frame_embeds": torch.zeros(1, 8, tc.d_model),
                              "frame_mask": torch.zeros(1, 8, dtype=bool)})
    bundle = treg.build_model(tc, dtype=torch.float32)
    logits, _ = bundle.forward(tp, {
        "frame_embeds": torch.zeros(1, 8, tc.frontend_embed_dim),
        "frame_mask": torch.zeros(1, 8, dtype=torch.bool)})
    assert logits.shape == (1, 8, tc.vocab_size)


# ---------------------------------------------------------------------------
# training: train_loss and every gradient leaf, 2e-4 of each leaf's scale
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen1.5-110b", "hubert-xlarge"])
def test_zoo_train_loss_and_grads_match_reference(arch):
    jc, tc, jp, tp = model(arch, seed=3)
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
    print(f"train_loss {arch}: {float(tl)} vs {float(jl)}; {len(devs)} "
          f"gradient leaves, worst {worst} {devs[worst]:.3e}")
    assert abs(float(tl) - float(jl)) <= 2e-4 * abs(float(jl))
    assert len(devs) == len(toptim.tree_leaves(tp))
    assert max(devs.values()) <= 2e-4
    s, n = ttfm.train_loss_sum(tp, tc, batch_t(batch), dtype=torch.float32)
    js, jn = jtfm.train_loss_sum(jp, jc, batch_j(batch), dtype=jnp.float32)
    assert float(n) == float(jn) and abs(float(s) - float(js)) \
        <= 2e-4 * abs(float(js))


# ---------------------------------------------------------------------------
# init from the seed: 4 ulps (the erfinv of the truncated normals)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ZOO)
def test_zoo_init_is_the_references(arch):
    jc, tc = reduced(arch)
    want = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(11), jc))
    flat = {".".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    got = ttfm.stack_layers(ttfm.init_params(prng.PRNGKey(11), tc))
    assert set(got) == set(flat)
    same = total = 0
    for name, g in got.items():
        g, w = g.numpy(), np.asarray(flat[name], np.float32)
        assert g.shape == w.shape, name
        ulps = np.abs(g.view(np.int32).astype(np.int64)
                      - w.view(np.int32).astype(np.int64))
        assert ulps.max() <= 4, (name, int(ulps.max()))
        same += int((ulps == 0).sum())
        total += ulps.size
    print(f"{arch} init: {same / total:.4f} of entries bitwise")
    tree = ttfm.unstack_layers(got)
    assert len(tree["layers"]) == tc.num_layers


def test_activation_copy_gives_the_bits_of_per_use_casts():
    """bf16 activations: the once-cast weight copy and the fp32 masters
    give bitwise the same outputs for the new leaves (biases, the GELU
    MLP, the audio frontend, MLA's projections)."""
    for arch in ("qwen1.5-110b", "minicpm3-4b", "hubert-xlarge"):
        jc, tc, _, tp = model(arch)
        copy = ttfm.activation_copy(tp, tc, torch.bfloat16)
        if tc.kind == "audio":
            batch = batch_t(jdata.synthetic_lm_batch(jc, 2, 24, seed=1))
            a, _ = ttfm.forward_train(tp, tc, batch, dtype=torch.bfloat16)
            b, _ = ttfm.forward_train(copy, tc, batch, dtype=torch.bfloat16)
            assert copy["frontend_proj"]["w"].dtype == torch.bfloat16
            assert copy["pred_head"]["w"].dtype == torch.float32
        else:
            toks = {"tokens": t(tokens(jc, 2, 24))}
            a, ca = ttfm.prefill(tp, tc, toks, dtype=torch.bfloat16,
                                 max_len=26)
            b, cb = ttfm.prefill(copy, tc, toks, dtype=torch.bfloat16,
                                 max_len=26)
            for key in ca:
                if key != "pos":
                    assert torch.equal(ca[key], cb[key]), (arch, key)
        assert torch.equal(a, b), arch


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _serve_args(arch, **kw):
    a = dict(arch=arch, reduced=True, batch=2, prompt_len=PROMPT,
             max_new=5, seed=3, device="cpu")
    a.update(kw)
    return argparse.Namespace(**a)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "granite-34b"])
def test_zoo_serve_generates_the_reference_tokens(arch):
    args = _serve_args(arch)
    want = jserve.serve(args)
    jc, tc = reduced(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(args.seed), jc))
    got = tserve.serve(args, params=ttfm.params_from_reference(tree, tc))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))


def test_serve_refuses_an_encoder_only_arch():
    args = _serve_args("hubert-xlarge")
    with pytest.raises(SystemExit) as jerr:
        jserve.serve(args)
    with pytest.raises(SystemExit) as terr:
        tserve.serve(args)
    assert str(terr.value) == str(jerr.value)
