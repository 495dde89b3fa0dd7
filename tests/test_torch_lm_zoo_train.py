"""The zoo's training on the port's CPU path against the JAX package.

The launcher's sgd steps (``repro_torch.launch.train.main``) for the
reduced minicpm3-4b (MLA, B5 at (80, 64)), hubert-xlarge (the encoder:
frames, bidirectional B5) and qwen2-vl-7b (M-RoPE, the VLM batch) from
the reference's init, against the reference's jit-ed ``make_train_step``
over the same synthetic stream: every step's loss within 1e-5, the final
weights (written by ``--checkpoint-dir`` as the reference's npz) within
2e-4 of each leaf's scale.  One federated round of the reduced
minicpm3-4b on the host loop and on the batched path against the
reference's, 2e-4 on every parameter and 1e-5 on the loss.  The
backward operator's batching rule at Dv != Dqk against a loop of
clients.  Every entry point's device defaults to the card.  Run with
``-s`` to print the measured deviations.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.configs import get_config as jget_config
from repro.data import lm_data as jdata
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.optim import optimizers as joptim
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm

from torch_lm_federation_common import _devs_to_ref
from test_torch_lm_moe_federation import _round

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

STEPS, BATCH, SEQ, CLIENTS = 3, 2, 48, 2


def _leaf_devs(got, want, path=""):
    """max |got - want| / max(max |want|, 1) of every leaf of two
    reference trees, by path."""
    out = {}
    for k, w in want.items():
        if isinstance(w, dict):
            out.update(_leaf_devs(got[k], w, f"{path}{k}."))
        else:
            g, w = np.asarray(got[k], np.float32), np.asarray(w, np.float32)
            assert g.shape == w.shape, (path + k, g.shape, w.shape)
            out[path + k] = float(np.max(np.abs(g - w))
                                  / max(float(np.max(np.abs(w))), 1.0))
    return out


@pytest.mark.parametrize("arch", ["minicpm3-4b", "hubert-xlarge",
                                  "qwen2-vl-7b"])
def test_launcher_steps_match_reference(arch, tmp_path):
    jc = jget_config(arch).reduced()
    tc = tconfigs.get_config(arch).reduced()
    jp = jtfm.init_params(jax.random.PRNGKey(0), jc)
    tp = ttfm.params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                    tc)
    argv = ["--arch", arch, "--reduced", "--steps", str(STEPS), "--batch",
            str(BATCH), "--seq", str(SEQ), "--num-clients", str(CLIENTS),
            "--log-every", str(STEPS), "--device", "cpu",
            "--checkpoint-dir", str(tmp_path)]
    got = []
    ttrain.main(argv, init=lambda: tp,
                on_step=lambda i, loss: got.append(float(loss)))
    opt = joptim.get_optimizer("sgd", 2e-3)
    jstep = jax.jit(jsteps.make_train_step(jc, opt, dtype=jnp.float32))
    state, want = opt.init(jp), []
    stream = jdata.SyntheticLMStream(jc, BATCH, SEQ, num_clients=CLIENTS,
                                     seed=0)
    for i, batch in zip(range(STEPS), stream):
        jp, state, loss = jstep(jp, state, {k: jnp.asarray(v) for k, v
                                            in batch.items()}, i)
        want.append(float(loss))
    tree, step = jload(str(tmp_path), jp)
    devs = _leaf_devs(tree, jax.tree_util.tree_map(np.asarray, jp))
    print(f"{arch}: losses {got} vs {want}; final weights max dev "
          f"{max(devs.values()):.3e} over {len(devs)} leaves")
    assert step == STEPS and len(got) == STEPS
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-5
    assert max(devs.values()) <= 2e-4


@pytest.mark.parametrize("mode", ["loop", "vmap"])
def test_minicpm3_federated_round_matches_reference(mode):
    """One round of the reduced minicpm3-4b (MLA) on ``model.family="lm"``
    from the reference's init, both packages: the port's batched path
    runs B5's backward operator under its vmap rule at (80, 64)."""
    jf, tf = _round("minicpm3-4b", mode)
    devs = _devs_to_ref(jf.engine.params, tf.engine.params)
    loss = abs(tf.history[0]["loss"] - jf.history[0]["loss"])
    print(f"minicpm3-4b {mode}: params {devs.max():.3e}, loss {loss:.3e}")
    assert tf.model_cfg.use_mla and len(tf.history) == 1
    assert tf.history[0]["participants"] == jf.history[0]["participants"]
    assert devs.max() <= 2e-4 and loss <= 1e-5


@pytest.mark.parametrize("dqk,dv", [(96, 64), (80, 64), (80, 80)])
def test_flash_vmap_rules_fold_clients_at_a_pair(dqk, dv, rng,
                                                 monkeypatch):
    """``vmap(grad)`` through ``ops.flash_attention`` at a zoo pair (the
    forward's and the backward operator's batching rules, which fold the
    clients into the batch axis whatever the head dims): one forward and
    one backward call for the cohort, and a loop of per-client
    ``torch.func.grad``'s gradients within 1e-6 of each one's scale."""
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    kc = 3
    args = (t(kc, 2, 40, 4, dqk), t(kc, 2, 40, 2, dqk), t(2, 40, 2, dv),
            t(kc, 2, 40, 4, dv))

    def f(q, k, v, w):
        return torch.sum(ops.flash_attention(q, k, v, window=16) * w)
    calls = []
    for name in ("flash_attention_fwd_ref", "flash_attention_bwd_ref"):
        def counted(*a, _real=getattr(ref, name), _name=name, **kw):
            calls.append((_name, tuple(a[0].shape), a[2].shape[-1]))
            return _real(*a, **kw)
        monkeypatch.setattr(ref, name, counted)
    in_dims = (0, 0, None, 0)
    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)),
                          in_dims=in_dims)(*args)
    assert calls == [(n, (kc * 2, 40, 4, dqk), dv) for n in
                     ("flash_attention_fwd_ref", "flash_attention_bwd_ref")]
    monkeypatch.undo()
    for i in range(kc):
        one = [a if d is None else a[i] for a, d in zip(args, in_dims)]
        want = torch.func.grad(f, argnums=(0, 1, 2))(*one)
        for g, w in zip(got, want):
            assert g[i].shape == w.shape
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g[i] - w).abs().max()) / scale <= 1e-6


@pytest.mark.parametrize("module", [
    "repro_torch.launch.train", "repro_torch.launch.serve",
    "repro_torch.launch.simulate", "repro_torch.launch.federate_serve",
    "repro_torch.launch.federate_load"])
def test_entry_points_default_to_the_card(module, monkeypatch):
    """Every launcher's ``--device`` is ``cuda`` (or unset, which
    ``resolve_device`` reads as ``cuda``) when it is not given, and on a
    host without a card that raises rather than falling back to the
    CPU."""
    import argparse
    from repro_torch.api import resolve_device
    built = []

    def grab(self, args=None, namespace=None):
        built.append(self)
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        importlib.import_module(module).main([])
    default = [a.default for a in built[0]._actions if a.dest == "device"]
    assert default in (["cuda"], [None])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(default[0])
