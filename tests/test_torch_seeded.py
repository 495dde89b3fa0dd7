"""Same seed, same run: the port against the JAX package with nothing
carried in.

Both packages draw init, minibatches, dp noise and secure masks from the
reference's threefry keys (``repro_torch/core/prng.py``), so the port
builds its weights and runs its rounds from the seed alone, with no
``params_from_reference`` and no carried noise:

* inits (ProdLDA in its three input modes, CTM, reduced hymba, mamba2
  and phi3) are the reference's within 4 ulps (the ``erfinv`` of their
  normals), bitwise where the reference draws uniforms or writes
  constants;
* the default spec, ``dp-transform``, ``secure-transform`` and
  ``pallas-topk`` on both exec modes, and the service with dp uploads,
  agree with the reference within 1e-5 on every parameter every round,
  with the round records' integers equal;
* ``repro_torch.launch.simulate --device cpu`` reproduces
  ``repro.launch.simulate``'s history and evaluation.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Federation as JFederation
from repro.api import FederationSpec as JSpec
from repro.api import spec_replace as jspec_replace
from repro.api.registry import scenario_spec as jscenario
from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JConfig
from repro.core.ntm import ctm as jctm
from repro.core.ntm import prodlda as jp
from repro.launch import simulate as jsimulate
from repro.models import transformer as jtfm
from repro.serve import FederationService as JService
from repro_torch import configs as tconfigs
from repro_torch.api import Federation, FederationSpec, max_param_dev
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core import prng
from repro_torch.core.ntm import ctm as tctm
from repro_torch.core.ntm import prodlda as tp
from repro_torch.launch import simulate
from repro_torch.models import transformer as ttfm
from repro_torch.serve import FederationService

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

TOL = 1e-5
ULPS = 4
ROUNDS = 3
INTS = ("round", "participants", "arrived", "superseded", "in_flight")
_SMALL = {"model": {"vocab": 64, "topics": 4, "hidden": 16},
          "data": {"num_clients": 3, "docs_per_node": 40,
                   "val_docs_per_node": 8},
          "schedule": {"rounds": ROUNDS},
          "execution": {"batch_size": 64, "learning_rate": 2e-4}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _held_to(got_flat, want_flat, what):
    """Every leaf within ULPS ulps; returns the share of bitwise-equal
    entries."""
    assert set(got_flat) == set(want_flat), what
    same = total = 0
    for name, g in got_flat.items():
        g, w = g.detach().cpu().numpy(), np.asarray(want_flat[name])
        assert g.shape == w.shape, (what, name)
        u = _ulps(g, w)
        assert u.max() <= ULPS, (what, name, int(u.max()))
        same += int((u == 0).sum())
        total += u.size
    return same / total


# ---------------------------------------------------------------------------
# inits from the seed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["bow", "combined", "zeroshot"])
@pytest.mark.parametrize("seed", [0, 7])
def test_prodlda_init_is_the_references(mode, seed):
    kw = dict(vocab_size=96, num_topics=6, ntm_hidden=(24, 16),
              contextual_dim=12)
    want = tp.params_from_reference(_np(jp.init_params(
        jax.random.PRNGKey(seed), JConfig(**kw), input_mode=mode)))
    got = tp.init_params(prng.PRNGKey(seed), TConfig(**kw), input_mode=mode)
    share = _held_to(got, want, mode)
    print(f"prodlda {mode} seed {seed}: {share:.4f} of entries bitwise")
    for name in got:
        if not (name.endswith(".w") or name == "beta"):
            assert torch.equal(got[name], want[name]), name


def test_ctm_inits_are_the_references():
    kw = dict(vocab_size=80, num_topics=5, ntm_hidden=(16,),
              contextual_dim=10)
    for jinit, tinit in ((jctm.init_combined, tctm.init_combined),
                         (jctm.init_zeroshot, tctm.init_zeroshot)):
        want = tp.params_from_reference(_np(jinit(jax.random.PRNGKey(3),
                                                  JConfig(**kw))))
        _held_to(tinit(prng.PRNGKey(3), TConfig(**kw)), want,
                 jinit.__name__)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-1.3b",
                                  "phi3-mini-3.8b"])
def test_lm_init_is_the_references(arch):
    """The reference's key tree: ``split(key, 8)``, layer i from
    ``split(keys[0], num_layers)[i]``, each layer's ``k1, k2``, mamba2's
    ``uniform`` for ``dt`` (its raw draw bitwise)."""
    jc, tc = jget_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    want = _np(jtfm.init_params(jax.random.PRNGKey(11), jc))
    got = ttfm.stack_layers(ttfm.init_params(prng.PRNGKey(11), tc))
    flat = {".".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    share = _held_to(got, flat, arch)
    print(f"{arch}: {share:.4f} of entries bitwise")
    if tc.kind != "dense":
        keys = prng.split(prng.split(prng.PRNGKey(11), 8)[0],
                          tc.num_layers)
        k1 = prng.split(keys[0])[0]
        mixer = prng.split(k1)[1] if tc.kind == "hybrid" else k1
        dt_key = prng.split(mixer, 4)[2]
        jkeys = jax.random.split(jax.random.split(jax.random.PRNGKey(11),
                                                  8)[0], jc.num_layers)
        jk1 = jax.random.split(jkeys[0])[0]
        jmixer = jax.random.split(jk1)[1] if tc.kind == "hybrid" else jk1
        nh = flat[[k for k in flat if k.endswith("A_log")][0]].shape[1]
        assert np.array_equal(
            prng.uniform(dt_key, (nh,), float(np.log(np.float32(1e-3))),
                         float(np.log(np.float32(1e-1)))).numpy(),
            np.asarray(jax.random.uniform(
                jax.random.split(jmixer, 4)[2], (nh,), jnp.float32,
                jnp.log(1e-3), jnp.log(1e-1))))


# ---------------------------------------------------------------------------
# runs from the seed
# ---------------------------------------------------------------------------
RUN_CELLS = ["paper", "dp-transform", "secure-transform", "pallas-topk"]


def _pair(name, mode):
    js = jspec_replace(jscenario(name, JSpec.from_dict(_SMALL)),
                       {"execution.exec_mode": mode})
    return (JFederation.from_spec(js),
            Federation.from_spec(FederationSpec.from_dict(js.to_dict()),
                                 device="cpu"))


@pytest.mark.parametrize("mode", ["loop", "vmap"])
@pytest.mark.parametrize("name", RUN_CELLS)
def test_runs_from_the_seed_track_reference(name, mode):
    jf, tf = _pair(name, mode)
    devs = [max_param_dev(tp.params_from_reference(_np(jf.params)),
                          tf.params)]
    for _ in range(ROUNDS):
        a, b = jf.step(), tf.step()
        devs.append(max_param_dev(tp.params_from_reference(_np(jf.params)),
                                  tf.params))
        assert {k: a[k] for k in INTS} == {k: b[k] for k in INTS}
        assert abs(a["loss"] - b["loss"]) <= TOL * abs(a["loss"])
    print(f"{name} [{mode}] from the seed: max_param_dev per round "
          + ", ".join(f"{d:.2e}" for d in devs))
    assert max(devs) <= TOL
    assert tf.engine.exec_mode == mode


def test_service_with_dp_uploads_tracks_reference():
    """The dp service from the seed: each upload's noise is the
    reference's, every aggregation within 1e-5."""
    js = jspec_replace(
        jscenario("buffered_async", JSpec.from_dict(
            {**_SMALL, "schedule": {"rounds": 3,
                                    "mode": "buffered_async"}})),
        {"transforms.names": ("dp",),
         "transforms.dp_noise_multiplier": 0.3,
         "transforms.dp_clip_norm": 0.05})
    jsvc = JService.from_spec(js)
    tsvc = FederationService.from_spec(
        FederationSpec.from_dict(js.to_dict()), device="cpu")
    worst = 0.0
    for c in [0, 1, 2, 2, 0, 1, 1, 0, 2]:
        assert jsvc.upload(c) == tsvc.upload(c)
        worst = max(worst, max_param_dev(
            tp.params_from_reference(_np(jsvc._live[1])), tsvc._live[1]))
    print(f"dp service from the seed: max_param_dev {worst:.2e}")
    assert tsvc.history == jsvc.history and tsvc.version >= 3
    assert worst <= TOL


def test_simulate_cli_reproduces_the_reference(tmp_path):
    """``--rounds 5`` at the launcher's default sizes."""
    got = simulate.main(["--rounds", "5", "--device", "cpu"])
    want = jsimulate.main(["--rounds", "5"])
    assert got["spec"] == want["spec"] and got["rounds_run"] == 5
    for a, b in zip(want["history"], got["history"]):
        assert {k: a[k] for k in INTS} == {k: b[k] for k in INTS}
        for k in ("loss", "rel_change"):
            assert abs(a[k] - b[k]) <= TOL * abs(a[k]), k
    for k in ("heldout_elbo_per_token", "npmi_coherence", "tss",
              "final_loss"):
        print(f"simulate {k}: port {got[k]!r} reference {want[k]!r}")
        assert abs(got[k] - want[k]) <= TOL * max(abs(want[k]), 1.0), k
