"""The paper's training mode in the port against the JAX package: the
train-mode ELBO (dropout, reparametrization, batch norm) in the three
input modes, CombinedTM/ZeroShotTM (``core/ntm/ctm.py``), the NTM arch
ids, the stochastic ``Federation`` on both exec modes, Algorithm 1 and
the baselines on CombinedTM data, the ``--ntm`` launcher and the
service's ``infer(contextual=...)``.

Both packages draw from the same threefry keys (``repro_torch/core/
prng.py`` equals jax.random bit for bit, ``tests/test_torch_prng.py``),
the weights are the reference's init (``params_from_reference``), and
batches are smaller than the client corpora, so the port must select
the reference's documents and noise; everything agrees within 1e-5.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Federation as JFederation
from repro.api import FederationSpec as JSpec
from repro.configs import get_config as jget_config
from repro.configs.base import NTM
from repro.configs.base import FederatedConfig as JFed
from repro.configs.base import ModelConfig as JConfig
from repro.core import protocol as jprotocol
from repro.core.ntm import ctm as jctm
from repro.core.ntm import prodlda as jp
from repro.data.synthetic_lda import \
    fake_contextual_embeddings as jfake_ctx
from repro.data.synthetic_lda import generate_lda_corpus as jgen
from repro.launch import train as jtrain
from repro.optim import optimizers as jopt
from repro.serve import FederationService as JService
from repro_torch import configs as tconfigs
from repro_torch.api import Federation, FederationSpec, max_param_dev
from repro_torch.configs.base import FederatedConfig, ModelConfig, \
    RoundConfig
from repro_torch.core import prng, protocol
from repro_torch.core.engine import ClientState
from repro_torch.core.ntm import ctm as tctm
from repro_torch.core.ntm import prodlda as tp
from repro_torch.core.rounds import RoundEngine
from repro_torch.data.synthetic_lda import fake_contextual_embeddings
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt
from repro_torch.serve import FederationService

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

TOL = 1e-5
V, K, H, C = 64, 4, 16, 8
MODES = ("bow", "combined", "zeroshot")


def _host(tree):
    return tp.params_from_reference(jax.tree_util.tree_map(np.asarray, tree))


def _close(got, want, tol=TOL):
    """|got - want| / max(max|want|, 1) <= tol; returns that deviation."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)
    return float(np.max(np.abs(got - want))) / scale


def _cfgs(**kw):
    kw = dict(dict(vocab_size=V, num_topics=K, ntm_hidden=(H, H),
                   contextual_dim=C), **kw)
    return JConfig(name="t", kind=NTM, **kw), ModelConfig(name="t", kind=NTM,
                                                          **kw)


def _batches(seed, docs=12):
    rng = np.random.default_rng(seed)
    bow = rng.poisson(0.4, (docs, V)).astype(np.float32)
    ctx = jfake_ctx(bow, C, seed=1)
    jb = {"bow": jnp.asarray(bow), "contextual": jnp.asarray(ctx),
          "rng": jax.random.PRNGKey(seed + 5)}
    tb = {"bow": torch.from_numpy(bow), "contextual": torch.from_numpy(ctx),
          "rng": prng.PRNGKey(seed + 5)}
    return jb, tb


# ---------------------------------------------------------------------------
# the train-mode ELBO
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bn", [False, True])
def test_train_mode_forward_loss_and_grads_match(mode, bn):
    jcfg, tcfg = _cfgs()
    jparams = jp.init_params(jax.random.PRNGKey(3), jcfg, input_mode=mode)
    tparams = _host(jparams)
    assert {k: tuple(v.shape) for k, v in tparams.items()} == \
        tp.param_shapes(tcfg, mode)
    jb, tb = _batches(0)
    kw = dict(train=True, use_batchnorm=bn, input_mode=mode)
    want = jp.forward(jparams, jcfg, jb, **kw)
    got = tp.forward(tparams, tcfg, tb, **kw)
    dev = max(_close(got[k], want[k])
              for k in ("theta", "mu", "logvar", "log_recon"))
    # the draws matter: train mode differs from the posterior mean
    assert not np.allclose(np.asarray(want["theta"]), np.asarray(
        jp.forward(jparams, jcfg, jb, **{**kw, "train": False})["theta"]))
    mask = np.asarray([1] * 9 + [0] * 3, np.float32)
    _close(tp.elbo_loss(tparams, tcfg, tb, **kw),
           jp.elbo_loss(jparams, jcfg, jb, **kw))
    s_j, n_j = jp.elbo_loss_sum(jparams, jcfg, {**jb, "doc_mask": mask}, **kw)
    s_t, n_t = tp.elbo_loss_sum(tparams, tcfg, {
        **tb, "doc_mask": torch.from_numpy(mask)}, **kw)
    _close(s_t, s_j)
    assert float(n_t) == float(n_j)
    jg = _host(jax.grad(lambda q: jp.elbo_loss(q, jcfg, jb, **kw))(jparams))
    tg = torch.func.grad(lambda q: tp.elbo_loss(q, tcfg, tb, **kw))(tparams)
    gdev = max(_close(tg[k], jg[k].numpy()) for k in jg)
    print(f"{mode} bn={bn}: forward {dev:.3e}, grads {gdev:.3e}")


def test_train_mode_without_key_or_dropout_is_the_posterior_mean():
    """The reference's defaults: ``train=True`` draws nothing without a
    key, and ``ntm_dropout=0`` keeps the reparametrization only."""
    jcfg, tcfg = _cfgs(ntm_dropout=0.0)
    jparams = jp.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = _host(jparams)
    jb, tb = _batches(2)
    nokey = {k: v for k, v in tb.items() if k != "rng"}
    _close(tp.elbo_loss(tparams, tcfg, nokey),
           tp.elbo_loss(tparams, tcfg, nokey, train=False))
    _close(tp.elbo_loss(tparams, tcfg, tb), jp.elbo_loss(jparams, jcfg, jb))


def test_ctm_module_matches_reference():
    jcfg, tcfg = _cfgs()
    jb, tb = _batches(4)
    for jinit, tinit, jloss, tloss, zs in (
            (jctm.init_combined, tctm.init_combined, jctm.loss_combined,
             tctm.loss_combined, False),
            (jctm.init_zeroshot, tctm.init_zeroshot, jctm.loss_zeroshot,
             tctm.loss_zeroshot, True)):
        jparams = jinit(jax.random.PRNGKey(0), jcfg)
        tparams = _host(jparams)
        shapes = {k: tuple(v.shape)
                  for k, v in tinit(prng.PRNGKey(0), tcfg).items()}
        assert shapes == {k: tuple(v.shape) for k, v in tparams.items()}
        _close(tloss(tparams, tcfg, tb), jloss(jparams, jcfg, jb))
        _close(tctm.infer_theta(tparams, tcfg, tb["bow"], tb["contextual"],
                                zeroshot=zs),
               jctm.infer_theta(jparams, jcfg, jb["bow"], jb["contextual"],
                                zeroshot=zs))
        _close(tctm.get_topics(tparams), jctm.get_topics(jparams))
    with pytest.raises(ValueError, match="contextual_dim"):
        tctm.init_combined(prng.PRNGKey(0), _cfgs(contextual_dim=0)[1])


@pytest.mark.parametrize("arch", ["prodlda-synthetic", "ctm-s2orc"])
def test_ntm_arch_ids_match_reference(arch):
    jc, tc = jget_config(arch), tconfigs.get_config(arch)
    for f in dataclasses.fields(tc):
        want = getattr(jc, f.name)
        if dataclasses.is_dataclass(want):
            continue
        assert getattr(tc, f.name) == want, f.name
    assert tc.num_params() == jc.num_params()
    assert dataclasses.asdict(tc.reduced()) == {
        k: v for k, v in dataclasses.asdict(jc.reduced()).items()
        if k in dataclasses.asdict(tc)}
    if arch == "ctm-s2orc":
        # the gFedNTM-CTM message: every leaf of the combined layout
        assert sum(int(np.prod(s)) for s in
                   tp.param_shapes(tc).values()) == 1_352_150


def test_fake_contextual_embeddings_bitwise():
    bows = np.random.default_rng(0).poisson(0.5, (30, 50)).astype(np.float32)
    for dim, seed in ((8, 1), (32, 0)):
        a, b = jfake_ctx(bows, dim, seed), fake_contextual_embeddings(
            bows, dim, seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the stochastic Federation and the loop == vmap twin
# ---------------------------------------------------------------------------
_SPEC = {"model": {"vocab": V, "topics": K, "hidden": H},
         "data": {"num_clients": 3, "docs_per_node": 40,
                  "val_docs_per_node": 8},
         "schedule": {"rounds": 3},
         "execution": {"batch_size": 16, "learning_rate": 1e-3,
                       "stochastic_loss": True}}


@pytest.mark.parametrize("exec_mode", ["loop", "vmap"])
def test_stochastic_federation_tracks_reference(exec_mode):
    js = JSpec.from_dict({**_SPEC, "execution": {
        **_SPEC["execution"], "exec_mode": exec_mode}})
    jf = JFederation.from_spec(js)
    tf = Federation.from_spec(FederationSpec.from_dict(js.to_dict()),
                              device="cpu", init_params=_host(jf.params))
    devs = []
    for _ in range(3):
        a, b = jf.step(), tf.step()
        devs.append(max_param_dev(_host(jf.params), tf.params))
        assert abs(a["loss"] - b["loss"]) <= TOL * abs(a["loss"])
    print(f"stochastic {exec_mode}: " + ", ".join(f"{d:.3e}" for d in devs))
    assert max(devs) <= TOL
    # and the draws were stochastic: eval mode lands elsewhere
    ef = Federation.from_spec(
        FederationSpec.from_dict({**js.to_dict(), "execution": {
            **js.to_dict()["execution"], "stochastic_loss": False}}),
        device="cpu", init_params=_host(JFederation.from_spec(js).params))
    ef.run()
    assert max_param_dev(ef.params, tf.params) > 1e-4


def test_stochastic_loop_equals_vmap():
    """Twin of tests/test_vmap_equivalence.py:117 in the port: the
    batched path's losses draw from the keys the loop puts in
    ``batch["rng"]``; full batches (unpadded cohort)."""
    rng = np.random.default_rng(3)
    _, cfg = _cfgs(contextual_dim=0)
    clients = [ClientState(data={"bow": torch.from_numpy(
        rng.poisson(0.3, (40, V)).astype(np.float32))}, num_docs=40)
        for _ in range(3)]
    init = tp.init_params(prng.PRNGKey(3), cfg)
    fed = FederatedConfig(num_clients=3, learning_rate=1e-2, max_rounds=3,
                          rel_tol=0.0)
    loop = RoundEngine(lambda p, b: tp.elbo_loss(p, cfg, b, train=True),
                       init, clients, fed, RoundConfig(), batch_size=40,
                       exec_mode="loop")
    vm = RoundEngine(lambda p, b: tp.elbo_loss(p, cfg, b, train=True), init,
                     clients, fed, RoundConfig(), batch_size=40,
                     exec_mode="vmap",
                     loss_sum_fn=lambda p, b: tp.elbo_loss_sum(
                         p, cfg, b, train=True))
    for r in range(3):
        ra, rb = loop.round(seed=r), vm.round(seed=r)
        assert max_param_dev(loop.params, vm.params) < TOL
        np.testing.assert_allclose(ra["loss"], rb["loss"], rtol=1e-4)


# ---------------------------------------------------------------------------
# CombinedTM through Algorithm 1 and the baselines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ctm_setup():
    syn = jgen(vocab_size=V, num_topics=K, num_nodes=3, shared_topics=1,
               docs_per_node=40, val_docs_per_node=4, seed=0)
    jcfg, tcfg = _cfgs()
    datas = [{"bow": b, "contextual": jfake_ctx(b, C, seed=1)}
             for b in syn.node_bows]
    return {"jcfg": jcfg, "cfg": tcfg, "datas": datas,
            "jinit": jp.init_params(jax.random.PRNGKey(100), jcfg)}


def _tdata(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("exec_mode", ["loop", "vmap"])
def test_combinedtm_federated_trainer_tracks_reference(ctm_setup, exec_mode):
    """gFedNTM-CTM as ``benchmarks/bench_wmd.py`` runs it: adam 2e-3,
    batch 16 of 40 documents, the train-mode CombinedTM loss."""
    s = ctm_setup
    jcfg, cfg = s["jcfg"], s["cfg"]
    jtr = jprotocol.FederatedTrainer(
        lambda p, b: jp.elbo_loss(p, jcfg, b), s["jinit"],
        [jprotocol.ClientState(data=d, num_docs=40) for d in s["datas"]],
        JFed(num_clients=3, learning_rate=2e-3, max_rounds=3, rel_tol=0.0),
        optimizer=jopt.adam(2e-3), batch_size=16, exec_mode=exec_mode,
        loss_sum_fn=lambda p, b: jp.elbo_loss_sum(p, jcfg, b))
    ttr = protocol.FederatedTrainer(
        lambda p, b: tp.elbo_loss(p, cfg, b), _host(s["jinit"]),
        [ClientState(data=_tdata(d), num_docs=40) for d in s["datas"]],
        FederatedConfig(num_clients=3, learning_rate=2e-3, max_rounds=3,
                        rel_tol=0.0),
        optimizer=topt.adam(2e-3), batch_size=16, exec_mode=exec_mode,
        loss_sum_fn=lambda p, b: tp.elbo_loss_sum(p, cfg, b))
    devs = []
    for r in range(3):
        a, b = jtr.round(seed=r), ttr.round(seed=r)
        devs.append(max_param_dev(_host(jtr.params), ttr.params))
        assert abs(a["loss"] - b["loss"]) <= TOL * abs(a["loss"])
    print(f"CombinedTM FederatedTrainer {exec_mode}: "
          + ", ".join(f"{d:.3e}" for d in devs))
    assert max(devs) <= TOL


def test_combinedtm_baselines_track_reference(ctm_setup):
    """``train_centralized`` (the ``split(key, 3)`` schedule) and
    ``train_non_collaborative`` on CombinedTM data, 4 adam steps each;
    node l's init is carried from the reference's ``PRNGKey(17 l)``."""
    s = ctm_setup
    jcfg, cfg = s["jcfg"], s["cfg"]
    jloss = lambda p, b: jp.elbo_loss(p, jcfg, b)  # noqa: E731
    tloss = lambda p, b: tp.elbo_loss(p, cfg, b)  # noqa: E731
    pooled = {k: np.concatenate([d[k] for d in s["datas"]])
              for k in s["datas"][0]}
    want = jprotocol.train_centralized(
        jloss, s["jinit"], pooled, optimizer=jopt.adam(2e-3), batch_size=16,
        steps=4, seed=2)
    got = protocol.train_centralized(
        tloss, _host(s["jinit"]), _tdata(pooled),
        optimizer=topt.adam(2e-3), batch_size=16, steps=4, seed=2)
    assert max_param_dev(_host(want), got) <= TOL
    inits = {17 * l: jp.init_params(jax.random.PRNGKey(17 * l), jcfg)
             for l in range(3)}
    want = jprotocol.train_non_collaborative(
        jloss, lambda key: inits[int(np.asarray(key)[1])], s["datas"],
        optimizer_factory=lambda: jopt.adam(2e-3), batch_size=16, steps=4)
    got = protocol.train_non_collaborative(
        tloss, lambda key: _host(inits[int(key[1])]),
        [_tdata(d) for d in s["datas"]],
        optimizer_factory=lambda: topt.adam(2e-3), batch_size=16, steps=4)
    for w, g in zip(want, got):
        assert max_param_dev(_host(w), g) <= TOL


# ---------------------------------------------------------------------------
# the --ntm launcher and the service's contextual input
# ---------------------------------------------------------------------------
_NTM_LAUNCH = ["--arch", "prodlda-synthetic", "--ntm", "--reduced",
               "--steps", "3", "--batch", "16", "--num-clients", "2",
               "--docs-per-node", "30", "--log-every", "1"]


def test_ntm_launcher_matches_train_ntm():
    """``launch.train --ntm`` (train mode, vocabulary consensus,
    FederatedTrainer) from the reference's init against its
    ``train_ntm``: the final round's loss within 1e-5."""
    jcfg = jget_config("prodlda-synthetic").reduced()
    init = _host(jp.init_params(jax.random.PRNGKey(0), jcfg))
    want = jtrain.main(_NTM_LAUNCH)
    seen = []
    got = ttrain.main(_NTM_LAUNCH + ["--device", "cpu"], init=lambda: init,
                      on_step=lambda r, loss: seen.append(loss))
    print(f"--ntm final loss: port {got} vs reference {want}")
    assert abs(got - want) <= TOL * abs(want)
    assert len(seen) == 3 and seen[-1] == got


def test_ctm_arch_launcher_fails_as_reference_does():
    """The reference's ``train_ntm`` gives its clients BoW only, so the
    CombinedTM loss of ``ctm-s2orc`` finds no ``contextual`` input."""
    argv = ["--arch", "ctm-s2orc", "--ntm", "--reduced", "--steps", "1",
            "--batch", "4", "--num-clients", "2", "--docs-per-node", "6"]
    with pytest.raises(KeyError, match="contextual"):
        jtrain.main(argv)
    with pytest.raises(KeyError, match="contextual"):
        ttrain.main(argv + ["--device", "cpu"])


def test_service_infer_with_contextual_matches_reference():
    spec = {**_SPEC, "schedule": {"rounds": 3, "mode": "buffered_async"},
            "execution": {"batch_size": 64, "learning_rate": 2e-4}}
    jsvc = JService.from_spec(JSpec.from_dict(spec))
    tsvc = FederationService.from_spec(
        FederationSpec.from_dict(spec), device="cpu",
        init_params=_host(jsvc._live[1]))
    bow = np.random.default_rng(0).poisson(0.5, (5, V)).astype(np.float32)
    ctx = jfake_ctx(bow, C, seed=1)
    got = tsvc.infer(bow, contextual=ctx)
    _close(got, jsvc.infer(bow, contextual=ctx))
    assert torch.equal(got, tsvc.infer(bow))
