"""The port's LM serving path against the JAX package, at reduced width.

The reference's init trees (numpy leaves) are carried into the port with
``params_from_reference``; the same numpy token batches go through both
in fp32.  Every layer must agree within 1e-5 of the output's scale, and
prefill logits and caches, then four teacher-forced decode steps, within
the repo's 2e-4 bound of this path (``tests/test_decode_consistency.py``).
The port's kernels take their plain versions here (CPU tensors); the
card holds the kernels against those (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro.models.layers import attention as jattn
from repro.models.layers import hymba as jhymba
from repro.models.layers import mamba2 as jmamba
from repro.models.layers.rope import rope_angles as jrope_angles
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.core import prng
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import hymba as thymba
from repro_torch.models.layers import mamba2 as tmamba
from repro_torch.models.layers.rope import rope_angles as trope_angles

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

ARCHS = ["hymba-1.5b", "mamba2-1.3b", "phi3-mini-3.8b"]
# longer than the reduced window (64) and than one reduced SSD chunk (64)
PROMPT = 96
DECODE_STEPS = 4


def _tree(node):
    """A reference param (sub)tree as torch tensors, value for value."""
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    return torch.from_numpy(np.array(node, dtype=np.float32))


def _dev(got, want) -> float:
    """max |got - want| / max(max |want|, 1)."""
    got = got.detach().to(torch.float32).numpy() \
        if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1.0))


def _reduced(arch):
    return jget_config(arch).reduced(), tconfigs.get_config(arch).reduced()


def _x(cfg, rng, b=2, s=PROMPT):
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _angles(cfg, b, s):
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    j = jrope_angles(jnp.asarray(pos), cfg.resolved_head_dim, cfg.rope_theta)
    t = trope_angles(torch.from_numpy(np.ascontiguousarray(pos)),
                     cfg.resolved_head_dim, cfg.rope_theta)
    assert _dev(t, j) <= 1e-6
    return jnp.asarray(pos), j, t


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
# reference fields the port leaves out: the lowering knobs no ported path
# reads (configs/base.py says so; remat_layers joined with LM training,
# the CTM fields with the NTM train mode)
OMITTED = {"scan_layers", "unroll_chunks"}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_parity(arch, reduced):
    jc, tc = jget_config(arch), tconfigs.get_config(arch)
    if reduced:
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


def test_config_defaults_match_reference():
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import SSMConfig as JSSMConfig
    jd, td = JModelConfig(), tbase.ModelConfig()
    for f in dataclasses.fields(td):
        want, got = getattr(jd, f.name), getattr(td, f.name)
        if dataclasses.is_dataclass(want):
            want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert got == want, f.name
    assert dataclasses.asdict(tbase.SSMConfig()) \
        == dataclasses.asdict(JSSMConfig())
    assert tconfigs.get_config("hymba-1.5b").num_params() == 1_718_382_400


# the two MoE ids, refused until the MoE slice ported them (the test
# keeps its name; every id of the reference's registry is ported)
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "qwen3-moe-235b-a22b"])
def test_unported_arch_ids_raise(arch):
    assert tconfigs.NOT_PORTED == ()
    jc, tc = jget_config(arch), tconfigs.get_config(arch)
    for cfg_j, cfg_t in ((jc, tc), (jc.reduced(), tc.reduced())):
        for f in dataclasses.fields(cfg_t):
            want, got = getattr(cfg_j, f.name), getattr(cfg_t, f.name)
            if dataclasses.is_dataclass(want):
                want, got = dataclasses.asdict(want), dataclasses.asdict(got)
            assert got == want, (arch, f.name)
        assert cfg_t.num_params() == cfg_j.num_params()
        assert cfg_t.num_active_params() == cfg_j.num_active_params()


def test_unknown_arch_id_raises():
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-17")


@pytest.mark.parametrize("change", [{"kind": tbase.MOE}, {"kind": tbase.NTM}])
def test_kinds_outside_the_slice_raise(change):
    """The NTM kind is no transformer and raises; the MoE kind, refused
    until the MoE slice, builds (reduced qwen3-moe: every layer's FFN a
    mixture of 4 experts) and its forward gives logits and a positive
    aux."""
    if change["kind"] == tbase.MOE:
        cfg = tconfigs.get_config("qwen3-moe-235b-a22b").reduced()
        params = ttfm.init_params(prng.PRNGKey(0), cfg)
        assert all(lp["ffn"]["w_gate"].shape == (4, cfg.d_model, cfg.d_ff)
                   for lp in params["layers"])
        logits, aux = treg.build_model(cfg, dtype=torch.float32).forward(
            params, {"tokens": torch.zeros((2, 8), dtype=torch.int64)})
        assert logits.shape == (2, 8, cfg.vocab_size) and float(aux) > 0
        return
    cfg = dataclasses.replace(tconfigs.get_config("phi3-mini-3.8b").reduced(),
                              **change)
    with pytest.raises(ValueError, match="no transformer"):
        ttfm.init_params(prng.PRNGKey(0), cfg)
    with pytest.raises(ValueError, match="no transformer"):
        treg.build_model(cfg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["hymba-1.5b", "phi3-mini-3.8b"])
def test_gqa_full_matches_reference(arch, rng):
    jc, tc = _reduced(arch)
    jp = jattn.gqa_init(jax.random.PRNGKey(3), jc)
    x = _x(jc, rng)
    pos, ja, ta = _angles(jc, *x.shape[:2])
    jout, (jk, jv) = jattn.gqa_full(jp, jc, jnp.asarray(x), ja,
                                    positions=pos, causal=True)
    tout, (tk, tv) = tattn.gqa_full(_tree(jp), tc, torch.from_numpy(x), ta)
    devs = [_dev(tout, jout), _dev(tk, jk), _dev(tv, jv)]
    print(f"gqa_full {arch}: out/k/v dev {devs}")
    assert max(devs) <= 1e-5


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0), (False, 24)])
def test_make_mask_and_sdpa_match_reference(causal, window, rng):
    """The materialized core of decode, at Sq > 1 under every mask."""
    b, s, hq, hkv, hd = 2, 40, 6, 2, 16
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    jm = jattn.make_mask(jnp.asarray(pos), jnp.asarray(pos), causal=causal,
                         window=window)
    tp = torch.from_numpy(np.ascontiguousarray(pos))
    tm = tattn.make_mask(tp, tp, causal=causal, window=window)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    jo = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                     hd ** -0.5)
    to = tattn._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), tm, hd ** -0.5)
    assert _dev(to, jo) <= 1e-5


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-1.3b"])
@pytest.mark.parametrize("slen", [PROMPT, 37])
def test_mamba2_apply_matches_reference(arch, slen, rng):
    """Two chunks at 96 steps (one ragged, padded), one short chunk."""
    jc, tc = _reduced(arch)
    jp = jmamba.mamba2_init(jax.random.PRNGKey(4), jc)
    x = _x(jc, rng, s=slen)
    jout, (jcs, jss) = jmamba.mamba2_apply(jp, jc, jnp.asarray(x))
    tout, (tcs, tss) = tmamba.mamba2_apply(_tree(jp), tc, torch.from_numpy(x))
    devs = [_dev(tout, jout), _dev(tcs, jcs), _dev(tss, jss)]
    print(f"mamba2_apply {arch} S={slen}: out/conv/ssm dev {devs}")
    assert max(devs) <= 1e-5


def test_hymba_full_matches_reference(rng):
    jc, tc = _reduced("hymba-1.5b")
    jp = jhymba.hymba_init(jax.random.PRNGKey(5), jc)
    x = _x(jc, rng)
    pos, ja, ta = _angles(jc, *x.shape[:2])
    jout, ((jk, jv), (jcs, jss)) = jhymba.hymba_full(
        jp, jc, jnp.asarray(x), ja, positions=pos)
    tout, ((tk, tv), (tcs, tss)) = thymba.hymba_full(
        _tree(jp), tc, torch.from_numpy(x), ta)
    devs = [_dev(a, b) for a, b in ((tout, jout), (tk, jk), (tv, jv),
                                    (tcs, jcs), (tss, jss))]
    print(f"hymba_full: out/k/v/conv/ssm dev {devs}")
    assert max(devs) <= 1e-5


# ---------------------------------------------------------------------------
# the model: prefill, decode, forward
# ---------------------------------------------------------------------------
def _model(arch, seed=1):
    jc, tc = _reduced(arch)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jc)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jc, tc, jp, ttfm.params_from_reference(tree, tc)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jc, tc, jp, tp = _model(arch)
    toks = _tokens(jc, 2, PROMPT + DECODE_STEPS)
    max_len = PROMPT + DECODE_STEPS
    jl, jcache = jtfm.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :PROMPT],
                                                             jnp.int32)},
                              dtype=jnp.float32, max_len=max_len)
    tl, tcache = ttfm.prefill(tp, tc, {"tokens": torch.from_numpy(
        toks[:, :PROMPT])}, dtype=torch.float32, max_len=max_len)
    devs = {"logits": _dev(tl, jl)}
    for key in ("k", "v", "conv", "ssm"):
        if key in jcache:
            devs[key] = _dev(tcache[key], jcache[key])
    assert set(tcache) == set(jcache)
    assert tcache["pos"] == int(jcache["pos"]) == PROMPT
    if "k" in tcache and jc.sliding_window:
        assert tcache["k"].shape[2] == jc.sliding_window   # ring buffer
    for i in range(DECODE_STEPS):
        step = toks[:, PROMPT + i:PROMPT + i + 1]
        jl, jcache = jtfm.decode_step(jp, jc, jcache,
                                      jnp.asarray(step, jnp.int32),
                                      dtype=jnp.float32)
        tl, tcache = ttfm.decode_step(tp, tc, tcache,
                                      torch.from_numpy(step),
                                      dtype=torch.float32)
        devs[f"decode{i}"] = _dev(tl, jl)
    for key in ("k", "v", "conv", "ssm"):
        if key in jcache:
            devs[f"{key}_after"] = _dev(tcache[key], jcache[key])
    assert tcache["pos"] == int(jcache["pos"])
    print(f"prefill+decode {arch}: {devs}")
    assert max(devs.values()) <= 2e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    jc, tc, jp, tp = _model(arch, seed=2)
    toks = _tokens(jc, 2, 70, seed=1)
    jl, _ = jtfm.forward_train(jp, jc, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)},
                               dtype=jnp.float32)
    tl, aux = ttfm.forward_train(tp, tc, {"tokens": torch.from_numpy(toks)},
                                 dtype=torch.float32)
    dev = _dev(tl, jl)
    print(f"forward_train {arch}: logits dev {dev:.3e}")
    assert dev <= 2e-4 and float(aux) == 0.0


def test_forward_train_cpu_is_differentiable():
    """On CPU tensors B5 and B6 take their plain versions, which autograd
    sees through: a backward from ``forward_train``'s logits reaches the
    attention core (``wq``) and the scan (Mamba-2's ``in_proj`` and
    ``A_log``, which enters only through the scan), and agrees with
    ``jax.grad`` of the reference within 2e-4 of each gradient's scale.
    (On the card the same call runs B5's and B6's backward kernels.)"""
    jc, tc, jp, tp = _model("hymba-1.5b", seed=2)
    toks = _tokens(jc, 2, 70, seed=1)
    cot = np.random.default_rng(3).standard_normal(
        (2, 70, jc.vocab_size)).astype(np.float32)

    def jloss(p):
        logits, _ = jtfm.forward_train(
            p, jc, {"tokens": jnp.asarray(toks, jnp.int32)},
            dtype=jnp.float32)
        return jnp.sum(logits * cot)
    jgrad = jax.grad(jloss)(jp)["layers"]["mixer"]
    leaves = [tp["layers"][i]["mixer"][part][name]
              for i in range(tc.num_layers)
              for part, name in (("attn", "wq"), ("ssm", "in_proj"),
                                 ("ssm", "A_log"))]
    for leaf in leaves:
        leaf.requires_grad_(True)
    logits, _ = ttfm.forward_train(tp, tc, {"tokens": torch.from_numpy(toks)},
                                   dtype=torch.float32)
    torch.sum(logits * torch.from_numpy(cot)).backward()
    devs = {}
    for i in range(tc.num_layers):
        for part, name in (("attn", "wq"), ("ssm", "in_proj"),
                           ("ssm", "A_log")):
            got = tp["layers"][i]["mixer"][part][name].grad
            want = np.asarray(jgrad[part][name])[i]
            assert got is not None and float(got.abs().max()) > 0.0
            devs[f"{name}{i}"] = float(np.max(np.abs(got.numpy() - want))
                                       / np.max(np.abs(want)))
    print(f"forward_train gradients vs jax.grad: {devs}")
    assert max(devs.values()) <= 2e-4


def test_bundle_matches_module_functions():
    _, tc, _, tp = _model("hymba-1.5b")
    bundle = treg.build_model(tc, dtype=torch.float32)
    toks = torch.from_numpy(_tokens(tc, 1, 20))
    a, _ = bundle.forward(tp, {"tokens": toks})
    b, cache = bundle.prefill(tp, {"tokens": toks})
    assert torch.equal(a, b) and cache["pos"] == 20
    empty = bundle.init_cache(1, 20, device="cpu")
    assert {k: tuple(v.shape) for k, v in empty.items() if k != "pos"} \
        == {k: tuple(v.shape) for k, v in cache.items() if k != "pos"}
    fresh = bundle.init(prng.PRNGKey(0))
    assert len(fresh["layers"]) == tc.num_layers


def test_activation_copy_gives_the_bits_of_per_use_casts():
    """bf16 activations: the once-cast weight copy and the fp32 masters
    (cast at every use) give bitwise the same logits and caches."""
    _, tc, _, tp = _model("hymba-1.5b")
    toks = {"tokens": torch.from_numpy(_tokens(tc, 2, PROMPT))}
    copy = ttfm.activation_copy(tp, tc, torch.bfloat16)
    assert copy["layers"][0]["mixer"]["attn"]["wq"].dtype == torch.bfloat16
    assert copy["layers"][0]["mixer"]["beta_ssm"].dtype == torch.float32
    a, ca = ttfm.prefill(tp, tc, toks, dtype=torch.bfloat16, max_len=100)
    b, cb = ttfm.prefill(copy, tc, toks, dtype=torch.bfloat16, max_len=100)
    assert torch.equal(a, b)
    for key in ("k", "v", "conv", "ssm"):
        assert torch.equal(ca[key], cb[key]), key
    step = torch.from_numpy(_tokens(tc, 2, 1, seed=3))
    da, _ = ttfm.decode_step(tp, tc, ca, step, dtype=torch.bfloat16)
    db, _ = ttfm.decode_step(copy, tc, cb, step, dtype=torch.bfloat16)
    assert torch.equal(da, db)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _serve_args(arch, **kw):
    a = dict(arch=arch, reduced=True, batch=2, prompt_len=PROMPT,
             max_new=5, seed=3, device="cpu")
    a.update(kw)
    return argparse.Namespace(**a)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-1.3b"])
def test_serve_cpu_generates_the_reference_tokens(arch):
    args = _serve_args(arch)
    want = jserve.serve(args)
    jc = jget_config(arch).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(args.seed), jc))
    tc = tconfigs.get_config(arch).reduced()
    got = tserve.serve(args, params=ttfm.params_from_reference(tree, tc))
    assert set(got) == set(want)
    assert got["generated"].dtype == np.int32
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))


def test_serve_defaults_to_the_card(monkeypatch):
    """With no --device the launcher runs on ``cuda`` and, with no card,
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "hymba-1.5b", "--reduced", "--batch", "1",
                     "--prompt-len", "4", "--max-new", "2"])


def test_serve_demo_twin_runs_on_the_cpu():
    """``examples/torch_serve_demo.py``'s ring-buffer case (reduced
    granite with a 32-token window under a 48-token prompt and 16 new
    tokens): the greedy tokens of ``examples/serve_demo.py``'s same call,
    each package from its own seeded init."""
    import importlib.util
    here = os.path.join(os.path.dirname(__file__), "..", "examples")
    mods = {}
    for name in ("serve_demo", "torch_serve_demo"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(here, f"{name}.py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    got = mods["torch_serve_demo"].demo("granite-34b", window=32,
                                        device="cpu")
    want = mods["serve_demo"].demo("granite-34b", window=32)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got, want)
