"""Shared set-up of ``tests/test_torch_lm_zoo*.py``: the dense half of the
LM zoo (granite-34b, qwen1.5-110b, qwen2-vl-7b, minicpm3-4b,
hubert-xlarge) at reduced width, reference against port.

The reference's init trees are carried into the port with
``params_from_reference``; every leaf the reference initializes to a
constant (q/k/v and MLP biases, LayerNorm biases, norm scales) is first
drawn anew from a seeded numpy generator, so that the parity tests see
the bias and scale paths at work and not only zeros and ones.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as ttfm

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

ZOO = ["granite-34b", "qwen1.5-110b", "qwen2-vl-7b", "minicpm3-4b",
       "hubert-xlarge"]
# the decoders of the zoo without MLA
GQA_ZOO = ["granite-34b", "qwen1.5-110b", "qwen2-vl-7b"]
PROMPT = 48
DECODE_STEPS = 4
# leaves the reference initializes to zeros (biases) or ones (scales)
_CONSTANT = ("bq", "bk", "bv", "b_up", "b_down", "bias", "scale")


def reduced(arch):
    return jget_config(arch).reduced(), tconfigs.get_config(arch).reduced()


def perturbed(tree, seed: int):
    """The reference tree as numpy, its constant-initialized leaves
    redrawn: biases N(0, 0.1^2), scales 1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = np.asarray(v, np.float32)
            if k in _CONSTANT:
                a = (a + 0.1 * rng.standard_normal(a.shape)).astype(
                    np.float32)
            out[k] = a
        return out
    return walk(jax.tree_util.tree_map(np.asarray, tree))


def model(arch, seed=1, cfg_change=None):
    """(reference cfg, port cfg, reference tree, port tree) from the
    reference's init, constant leaves redrawn."""
    jc, tc = reduced(arch)
    if cfg_change:
        import dataclasses
        jc = dataclasses.replace(jc, **cfg_change)
        tc = dataclasses.replace(tc, **cfg_change)
    tree = perturbed(jtfm.init_params(jax.random.PRNGKey(seed), jc), seed)
    return jc, tc, tree, ttfm.params_from_reference(tree, tc)


def dev(got, want) -> float:
    """max |got - want| / max(max |want|, 1)."""
    got = got.detach().to(torch.float32).numpy() \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1.0))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def batch_t(batch):
    return {k: t(v) for k, v in batch.items()}


def batch_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def pairs(jtree, ttree, path=""):
    """(path, reference leaf, port leaf) over the reference tree, whose
    ``layers`` are stacked on a leading axis and the port's a list."""
    out = []
    for k, v in jtree.items():
        if k == "layers":
            for i, lp in enumerate(ttree["layers"]):
                sub = jax.tree_util.tree_map(lambda a: a[i], v)
                out += pairs(sub, lp, f"{path}layers[{i}].")
        elif isinstance(v, dict):
            out += pairs(v, ttree[k], f"{path}{k}.")
        else:
            out.append((path + k, v, ttree[k]))
    return out


def prefill_and_decode(jc, tc, jp, tp, toks, *, batch=None):
    """Prefill ``toks[:, :PROMPT]`` (plus the optional extra batch keys),
    then DECODE_STEPS teacher-forced steps, in both packages (fp32);
    returns the deviations by stage and both final caches."""
    extra = batch or {}
    jb = {"tokens": jnp.asarray(toks[:, :PROMPT], jnp.int32),
          **batch_j(extra)}
    tb = {"tokens": t(toks[:, :PROMPT]), **batch_t(extra)}
    max_len = PROMPT + DECODE_STEPS
    jl, jcache = jtfm.prefill(jp, jc, jb, dtype=jnp.float32,
                              max_len=max_len)
    tl, tcache = ttfm.prefill(tp, tc, tb, dtype=torch.float32,
                              max_len=max_len)
    devs = {"prefill": dev(tl, jl)}
    assert set(tcache) == set(jcache)
    for key in jcache:
        if key != "pos":
            devs[key] = dev(tcache[key], jcache[key])
    for i in range(DECODE_STEPS):
        step = toks[:, PROMPT + i:PROMPT + i + 1]
        jl, jcache = jtfm.decode_step(jp, jc, jcache,
                                      jnp.asarray(step, jnp.int32),
                                      dtype=jnp.float32)
        tl, tcache = ttfm.decode_step(tp, tc, tcache, t(step),
                                      dtype=torch.float32)
        devs[f"decode{i}"] = dev(tl, jl)
    assert tcache["pos"] == int(jcache["pos"]) == PROMPT + DECODE_STEPS
    return devs, jcache, tcache
