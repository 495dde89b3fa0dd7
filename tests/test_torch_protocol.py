"""Algorithm 1 in the port against the JAX package: the optimizers, the
stage-1 vocabulary consensus, DSS/TSS, the loop path's combine, the
trainers and the paper's baselines.

Both packages train ProdLDA in evaluation mode here (each loss passes
``train=False``: no dropout, the posterior mean; the train-mode runs are
in ``tests/test_torch_ctm.py``) from the reference's init weights
(``params_from_reference``).  The minibatches are the reference's own
threefry draws (``repro_torch/core/prng.py``), and the draws here are
the whole client corpus (``batch_size >= num_docs``).  The two then
differ in fp32 summation order alone, and trajectories must agree
within 1e-5 every round.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FederatedConfig as JFed
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import protocol as jprotocol
from repro.core import vocab as jvocab
from repro.core.engine import combine_arrivals as jcombine_arrivals
from repro.core.ntm import prodlda as jprodlda
from repro.metrics import similarity as jsim
from repro.optim import optimizers as jopt
from repro_torch.api import max_param_dev
from repro_torch.configs.base import NTM, FederatedConfig, ModelConfig
from repro_torch.core import prng, protocol, vocab
from repro_torch.core.aggregation import aggregate_host
from repro_torch.core.engine import ClientState, combine_arrivals
from repro_torch.core.ntm import prodlda
from repro_torch.core.ntm.prodlda import params_from_reference
from repro_torch.core.rounds import RoundEngine
from repro_torch.data.synthetic_lda import generate_lda_corpus
from repro_torch.metrics import dss, tss_baseline
from repro_torch.optim import optimizers as opt
from repro_torch.parallel import fed_mesh

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

TOL = 1e-5
V, K, H = 64, 4, 16
DOCS, BATCH = 40, 64            # BATCH >= DOCS: whole-corpus draws


def _host(tree):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def setup():
    """Three clients of a small synthetic corpus, the reference's init,
    and each package's evaluation-mode loss."""
    syn = generate_lda_corpus(vocab_size=V, num_topics=K, num_nodes=3,
                              shared_topics=1, docs_per_node=DOCS,
                              val_docs_per_node=8, seed=0)
    jcfg = JModelConfig(name="t", kind=NTM, vocab_size=V, num_topics=K,
                        ntm_hidden=(H, H))
    cfg = ModelConfig(name="t", kind=NTM, vocab_size=V, num_topics=K,
                      ntm_hidden=(H, H))
    jinit = jprodlda.init_params(jax.random.PRNGKey(0), jcfg)
    return {
        "syn": syn,
        "jloss": lambda p, b: jprodlda.elbo_loss(p, jcfg, b, train=False),
        "loss": lambda p, b: prodlda.elbo_loss(p, cfg, b, train=False),
        "jinit": jinit, "init": _host(jinit), "cfg": cfg,
        "jclients": [jprotocol.ClientState(data={"bow": b},
                                           num_docs=len(b))
                     for b in syn.node_bows],
        "clients": [ClientState(data={"bow": torch.from_numpy(b)},
                                num_docs=len(b)) for b in syn.node_bows],
    }


def _tree_np(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("adam", {}), ("adam", {"b1": 0.8, "eps": 1e-6}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.1})])
def test_optimizer_matches_reference(name, kw):
    """Four steps on fixed gradient trees, the step index passed as the
    engine passes the round index: every leaf within 1e-6."""
    rng = np.random.default_rng(3)
    shapes = {"w": (7, 5), "b": (5,), "beta": (3, 11)}
    params = _tree_np(rng, shapes)
    grads = [_tree_np(rng, shapes) for _ in range(4)]
    sched = opt.cosine_schedule(1e-2, 4)
    jsched = jopt.cosine_schedule(1e-2, 4)
    j = jopt.get_optimizer(name, jsched, **kw)
    t = opt.get_optimizer(name, sched, **kw)
    jp, jst = params, j.init(params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tst = t.init(tp)
    for step, g in enumerate(grads):
        jp, jst = j.update(jp, g, jst, step)
        tp, tst = t.update(tp, {k: torch.from_numpy(v)
                                for k, v in g.items()}, tst, step)
        dev = max(float(np.max(np.abs(np.asarray(jp[k]) - tp[k].numpy())))
                  for k in shapes)
        assert dev <= 1e-6, (step, dev)
    with pytest.raises(KeyError):
        opt.get_optimizer("lamb", 1e-3)


@pytest.mark.parametrize("make", [
    lambda m: m.constant_schedule(3e-3),
    lambda m: m.cosine_schedule(1e-2, 50, 0.2),
    lambda m: m.warmup_cosine(1e-2, 10, 60)])
def test_schedules_match_reference(make):
    want, got = make(jopt), make(opt)
    for step in (0, 1, 5, 10, 11, 37, 60, 80):
        assert abs(float(want(step)) - got(step)) <= 1e-6 * 1e-2, step


# ---------------------------------------------------------------------------
# stage 1: vocabulary consensus (bitwise)
# ---------------------------------------------------------------------------
def test_vocabulary_consensus_matches_reference(rng):
    terms = [[f"w{i}" for i in range(0, 30)],
             [f"w{i}" for i in range(20, 55)],
             [f"w{i}" for i in range(10, 40, 2)]]
    bows = [rng.poisson(0.7, (12, len(t))).astype(np.float32)
            for t in terms]
    jv = [jvocab.Vocabulary.from_bow(b, t) for b, t in zip(bows, terms)]
    tv = [vocab.Vocabulary.from_bow(b, t) for b, t in zip(bows, terms)]
    assert [v.counts for v in jv] == [v.counts for v in tv]
    jm, tm = jvocab.merge_vocabularies(jv), vocab.merge_vocabularies(tv)
    assert jm.counts == tm.counts and jm.terms == tm.terms
    assert jm.index() == tm.index()
    # order-independent: a commutative monoid
    assert vocab.merge_vocabularies(tv[::-1]).terms == tm.terms
    for b, t in zip(bows, terms):
        want = jvocab.reindex_bow(b, t, jm)
        got = vocab.reindex_bow(b, t, tm)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    docs = [["a", "b", "a"], ["c", "a"]]
    assert vocab.Vocabulary.from_documents(docs).counts == \
        jvocab.Vocabulary.from_documents(docs).counts
    sets = [{3: 2.0, 7: 1.0, 9: 4.0}, {7: 5.0, 11: 1.0}, {}]
    jmap, jtab = jvocab.consensus_token_map(sets)
    tmap, ttab = vocab.consensus_token_map(sets)
    assert jmap == tmap
    assert all(np.array_equal(a, b) for a, b in zip(jtab, ttab))


# ---------------------------------------------------------------------------
# DSS and the TSS baseline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("docs,block", [(60, 2048), (300, 64), (129, 128)])
def test_dss_matches_reference(docs, block):
    rng = np.random.default_rng(docs)
    a = rng.dirichlet(np.full(6, 0.3), size=docs).astype(np.float32)
    b = rng.dirichlet(np.full(6, 0.3), size=docs).astype(np.float32)
    want = jsim.dss(a, b, block=block)
    got = dss(torch.from_numpy(a), torch.from_numpy(b), block=block)
    print(f"dss docs={docs} block={block}: {want:.6f} vs {got:.6f}")
    assert abs(got - want) <= 1e-6 * abs(want)
    assert dss(a, a) == 0.0


def test_tss_baseline_matches_reference():
    want = jsim.tss_baseline(200, 6, 0.05, runs=3, seed=4)
    got = tss_baseline(200, 6, 0.05, runs=3, seed=4)
    assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# the loop path's combine (B2's plain version on the CPU)
# ---------------------------------------------------------------------------
def _deltas(rng, n):
    shapes = {"w": (6, 5), "b": (5,), "beta": (3, 9)}
    return [_tree_np(rng, shapes) for _ in range(n)]


@pytest.mark.parametrize("ages,weights,decay,clients", [
    ((0, 0, 0), (10.0, 20.0, 5.0), 0.5, None),
    ((2,), (7.0,), 0.5, None),
    ((1, 1), (1.0, 3.0), 0.25, [4, 1]),
    ((0, 3, 1, 2), (40.0, 12.0, 0.0, 9.0), 0.9, [0, 1, 2, 3]),
    ((0, 1), (5.0, 0.0), 1.0, [2, 2]),
    ((3, 0), (2.0, 2.0), 0.0, [1, 0]),
])
def test_combine_arrivals_matches_reference(rng, ages, weights, decay,
                                            clients):
    ds = _deltas(rng, len(ages))
    want = jcombine_arrivals(list(zip(ages, ds, weights)), decay,
                             clients=clients)
    td = [{k: torch.from_numpy(v) for k, v in d.items()} for d in ds]
    got = combine_arrivals(list(zip(ages, td, weights)), decay,
                           clients=clients)
    assert list(got) == ["w", "b", "beta"]
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    # written into a reused wider slab: the same values
    slab = torch.full((6, 62), float("nan"))     # 62 = 30 + 5 + 27
    again = combine_arrivals(list(zip(ages, td, weights)), decay,
                             clients=clients, slab=slab)
    assert all(torch.equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("arrivals,decay,clients,match", [
    ([(1, 0, 1.0)], -0.5, None, "staleness_decay"),
    ([(1, 0, 1.0)], 1.01, None, "staleness_decay"),
    ([], 0.5, None, "at least one"),
    ([(0, 0, 0.0), (2, 1, 0.0)], 0.5, None, "at least one"),
    ([(0, 0, 1.0), (1, 1, 2.0), (0, 2, 3.0)], 0.5, [2, 5, 2],
     "client\\(s\\) \\[2\\]"),
    ([(0, 0, 1.0), (1, 1, 2.0)], 0.5, [2], "alignment"),
])
def test_combine_arrivals_refusals_match_reference(rng, arrivals, decay,
                                                   clients, match):
    ds = _deltas(rng, 3)
    jarr = [(a, ds[i], w) for a, i, w in arrivals]
    tarr = [(a, {k: torch.from_numpy(v) for k, v in ds[i].items()}, w)
            for a, i, w in arrivals]
    with pytest.raises(ValueError, match=match):
        jcombine_arrivals(jarr, decay, clients=clients)
    with pytest.raises(ValueError, match=match):
        combine_arrivals(tarr, decay, clients=clients)


def test_aggregate_host_matches_reference(rng):
    ds = _deltas(rng, 3)
    want = jprotocol.agg.aggregate_host(ds, [3.0, 1.0, 6.0])
    got = aggregate_host([{k: torch.from_numpy(v) for k, v in d.items()}
                          for d in ds], [3.0, 1.0, 6.0])
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the trainers against the reference
# ---------------------------------------------------------------------------
def _trainers(setup, cls, fed_kw, jopt_make=None, topt_make=None, **kw):
    jfed, fed = JFed(**fed_kw), FederatedConfig(**fed_kw)
    jk = dict(kw, optimizer=jopt_make()) if jopt_make else kw
    tk = dict(kw, optimizer=topt_make()) if topt_make else kw
    jt = getattr(jprotocol, cls)(setup["jloss"], setup["jinit"],
                                 setup["jclients"], jfed,
                                 batch_size=BATCH, **jk)
    tt = getattr(protocol, cls)(setup["loss"], setup["init"],
                                setup["clients"], fed, batch_size=BATCH,
                                **tk)
    return jt, tt


@pytest.mark.parametrize("kw", [{}, {"momentum": 0.9},
                                {"momentum": 0.9, "nesterov": True}])
def test_federated_trainer_sgd_tracks_reference(setup, kw):
    """Algorithm 1 with Eq. (3) SGD (and with momentum): 5 rounds, every
    round's parameters within 1e-5, the round records equal."""
    jt, tt = _trainers(setup, "FederatedTrainer",
                       dict(num_clients=3, learning_rate=2e-3),
                       lambda: jopt.sgd(2e-3, **kw),
                       lambda: opt.sgd(2e-3, **kw))
    devs = []
    for r in range(5):
        a, b = jt.round(seed=r), tt.round(seed=r)
        devs.append(max_param_dev(_host(jt.params), tt.params))
        for key in ("round", "participants", "arrived", "superseded",
                    "in_flight"):
            assert a[key] == b[key], key
        assert abs(a["loss"] - b["loss"]) <= TOL * abs(a["loss"])
    print(f"FederatedTrainer sgd {kw}: max_param_dev per round "
          + ", ".join(f"{d:.3e}" for d in devs))
    assert max(devs) <= TOL
    if kw:
        assert set(tt.opt_state) == {"mu"}


def test_federated_trainer_adam_tracks_reference_loss(setup):
    """Adam held on the loss trajectory, not on every parameter:
    ``m / (sqrt(v) + eps)`` turns a gradient element whose true value is
    near zero into a full +-lr step, and a summation-order difference
    between the packages can flip its sign, moving that parameter by up
    to 2 * lr.  The loss, a sum over every parameter, stays within a
    relative 1e-4 over 8 rounds; the Adam arithmetic itself is held at
    1e-6 by test_optimizer_matches_reference."""
    jt, tt = _trainers(setup, "FederatedTrainer",
                       dict(num_clients=3, learning_rate=2e-3,
                            max_rounds=8, rel_tol=0.0),
                       lambda: jopt.adam(2e-3), lambda: opt.adam(2e-3))
    jt.fit(seed=1)
    tt.fit(seed=1)
    rel = [abs(a["loss"] - b["loss"]) / abs(a["loss"])
           for a, b in zip(jt.history, tt.history)]
    print("FederatedTrainer adam: loss rel dev per round "
          + ", ".join(f"{x:.2e}" for x in rel))
    assert len(tt.history) == 8 and max(rel) <= 1e-4
    assert tt.history[-1]["loss"] < tt.history[0]["loss"]


def test_fedavg_trainer_tracks_reference(setup):
    jt, tt = _trainers(setup, "FedAvgTrainer",
                       dict(num_clients=3, learning_rate=2e-3,
                            local_steps=3, max_rounds=4, rel_tol=0.0))
    jt.fit(seed=2)
    tt.fit(seed=2)
    assert max_param_dev(_host(jt.params), tt.params) <= TOL
    assert [h["loss"] for h in tt.history] == pytest.approx(
        [h["loss"] for h in jt.history], rel=TOL)
    with pytest.raises(NotImplementedError, match="loop-only"):
        protocol.FedAvgTrainer(setup["loss"], setup["init"],
                               setup["clients"], FederatedConfig(),
                               exec_mode="vmap")
    with pytest.raises(ValueError, match="no client optimizer"):
        protocol.FedAvgTrainer(setup["loss"], setup["init"],
                               setup["clients"], FederatedConfig(),
                               optimizer=opt.adam(2e-3))


def test_federated_equals_centralized_gradient(setup):
    """The paper's central claim (twin of tests/test_protocol.py:45): the
    Eq. (2) average of the client gradients equals the gradient of the
    centralized loss on the concatenated minibatch — through the plain
    host average and through the engine's combine (B2's plain version)."""
    tr = protocol.FederatedTrainer(setup["loss"], setup["init"],
                                   setup["clients"],
                                   FederatedConfig(num_clients=3,
                                                   learning_rate=1e-2),
                                   batch_size=24)
    grads, weights, batches = [], [], []
    for l, c in enumerate(tr.clients):
        _, g, n = tr._client_grad(l, c, 7)
        grads.append(g)
        weights.append(n)
        idx = prng.choice(prng.fold_in(prng.PRNGKey(7), l), c.num_docs,
                          min(24, c.num_docs))
        batches.append(c.data["bow"][idx])
    g_cent = torch.func.grad(setup["loss"])(
        setup["init"], {"bow": torch.cat(batches)})
    for g_fed in (aggregate_host(grads, weights),
                  combine_arrivals([(0, g, n) for g, n in
                                    zip(grads, weights)], 0.5)):
        for k in g_cent:
            np.testing.assert_allclose(g_fed[k].numpy(),
                                       g_cent[k].numpy(),
                                       atol=5e-5, rtol=1e-4)


def test_federated_training_loss_decreases_and_stops():
    """Twins of tests/test_protocol.py:88 and :124 at their sizes (the
    reduced prodlda-synthetic config, 120 documents a node, batch 64):
    the loss falls over 30 rounds, and a near-zero learning rate stops at
    once on rel_tol."""
    syn = generate_lda_corpus(vocab_size=512, num_topics=10, num_nodes=3,
                              shared_topics=4, docs_per_node=120,
                              val_docs_per_node=20, seed=0)
    cfg = ModelConfig(name="r", kind=NTM, vocab_size=512, num_topics=10,
                      ntm_hidden=(32, 32))
    init = _host(jprodlda.init_params(
        jax.random.PRNGKey(0),
        JModelConfig(name="r", kind=NTM, vocab_size=512, num_topics=10,
                     ntm_hidden=(32, 32))))
    clients = [ClientState(data={"bow": torch.from_numpy(b)},
                           num_docs=len(b)) for b in syn.node_bows]
    loss = lambda p, b: prodlda.elbo_loss(p, cfg, b, train=False)  # noqa: E731,E501
    tr = protocol.FederatedTrainer(
        loss, init, clients,
        FederatedConfig(num_clients=3, learning_rate=5e-3, max_rounds=30,
                        rel_tol=0.0), batch_size=64)
    tr.fit(seed=0)
    assert len(tr.history) == 30
    assert np.mean([h["loss"] for h in tr.history[-5:]]) \
        < np.mean([h["loss"] for h in tr.history[:5]])
    stop = protocol.FederatedTrainer(
        loss, init, clients,
        FederatedConfig(num_clients=3, learning_rate=1e-9, max_rounds=50,
                        rel_tol=1e-6), batch_size=32)
    stop.fit(seed=0)
    assert len(stop.history) == 1


def test_round_engine_degenerate_equals_federated_trainer(setup):
    """K = L, E = 1, no stragglers, FedAvg(server_lr=1) retraces the
    Algorithm-1 trainer with sgd (twin of tests/test_rounds.py:46)."""
    fed = FederatedConfig(num_clients=3, learning_rate=2e-3, max_rounds=3,
                          rel_tol=0.0)
    a = RoundEngine(setup["loss"], setup["init"], setup["clients"], fed,
                    batch_size=BATCH)
    b = protocol.FederatedTrainer(setup["loss"], setup["init"],
                                  setup["clients"], fed, batch_size=BATCH)
    a.fit(seed=4)
    b.fit(seed=4)
    assert max_param_dev(a.params, b.params) <= TOL


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_federated_trainer_loop_equals_vmap(setup, optimizer):
    """The port's two paths for Algorithm 1: grad messages stepped one
    client at a time and stacked in one batched call, 3 rounds."""
    fed = FederatedConfig(num_clients=3, learning_rate=2e-3, max_rounds=3,
                          rel_tol=0.0)
    runs = []
    for mode in ("loop", "vmap"):
        tr = protocol.FederatedTrainer(
            setup["loss"], setup["init"], setup["clients"], fed,
            optimizer=opt.get_optimizer(optimizer, 2e-3), batch_size=BATCH,
            exec_mode=mode,
            loss_sum_fn=lambda p, b: prodlda.elbo_loss_sum(
                p, setup["cfg"], b, train=False))
        tr.fit(seed=5)
        runs.append(tr)
    dev = max_param_dev(runs[0].params, runs[1].params)
    print(f"FederatedTrainer {optimizer} loop vs vmap: {dev:.3e}")
    assert dev <= TOL
    for a, b in zip(*(r.history for r in runs)):
        assert abs(a["loss"] - b["loss"]) <= TOL * abs(a["loss"])


def test_federated_trainer_transforms_by_exec_mode(setup):
    """dp/topk/secure/precision knobs become grad transforms, in the
    reference's order, under both exec modes, and the two agree within
    1e-5 (topk error memory included); the mesh protocol step equals
    Eq. (2) over the clients' gradients."""
    fed = FederatedConfig(num_clients=3, learning_rate=2e-3,
                          compression_topk=0.25, secure_aggregation=True)
    trs = [protocol.FederatedTrainer(
        setup["loss"], setup["init"], setup["clients"], fed,
        batch_size=BATCH, exec_mode=mode,
        loss_sum_fn=lambda p, b: prodlda.elbo_loss_sum(p, setup["cfg"], b,
                                                       train=False))
        for mode in ("loop", "vmap")]
    for tr in trs:
        assert [n for n, _ in tr._transforms] == ["topk", "secure"]
        for r in range(3):
            rec = tr.round(seed=r)
            assert rec["arrived"] == 3 and np.isfinite(rec["loss"])
    assert max_param_dev(trs[0].params, trs[1].params) <= TOL
    assert float(torch.max(torch.abs(trs[0]._tstate["topk"]
                                     - trs[1]._tstate["topk"]))) <= TOL
    # the mesh protocol step runs: one CPU shard a client, Eq. (2) over
    # the shards, one SGD step from the init
    step = protocol.make_federated_train_step(
        lambda p, b: prodlda.elbo_loss_sum(p, setup["cfg"], b, train=False),
        opt.sgd(1e-2), fed_mesh(3, "cpu"))
    new, _, _ = step(setup["init"], {}, {"bow": torch.cat(
        [c.data["bow"] for c in setup["clients"]])}, 0, prng.PRNGKey(1))
    grads = [torch.func.grad(setup["loss"])(setup["init"], c.data)
             for c in setup["clients"]]
    gbar = aggregate_host(grads, [c.num_docs for c in setup["clients"]])
    assert max_param_dev(new, {k: v - 1e-2 * gbar[k] for k, v in
                               setup["init"].items()}) <= TOL
    with pytest.raises(ValueError, match="explicit server stage"):
        protocol.FederationEngine(setup["loss"], setup["init"],
                                  setup["clients"], FederatedConfig(),
                                  message="grad")


# ---------------------------------------------------------------------------
# the paper's baselines and the two-stage protocol
# ---------------------------------------------------------------------------
def test_train_centralized_tracks_reference(setup):
    """Scenario 2 on the concatenated corpus with whole-corpus draws and
    sgd: the trajectories agree within 1e-5 after 5 steps."""
    data = np.concatenate(setup["syn"].node_bows)
    want = jprotocol.train_centralized(
        setup["jloss"], setup["jinit"], {"bow": data},
        optimizer=jopt.sgd(2e-3), batch_size=len(data), steps=5, seed=3)
    got = protocol.train_centralized(
        setup["loss"], setup["init"], {"bow": torch.from_numpy(data)},
        optimizer=opt.sgd(2e-3), batch_size=len(data), steps=5, seed=3)
    assert max_param_dev(_host(want), got) <= TOL


def test_train_non_collaborative_one_model_per_node(setup):
    cfg = setup["cfg"]
    models = protocol.train_non_collaborative(
        setup["loss"],
        lambda key: prodlda.init_params(key, cfg),
        [{"bow": c.data["bow"]} for c in setup["clients"]],
        optimizer_factory=lambda: opt.adam(2e-3), batch_size=16, steps=3,
        seed=1)
    assert len(models) == 3
    assert max_param_dev(models[0], models[1]) > 0
    assert all(torch.isfinite(v).all() for m in models for v in m.values())


def test_two_stage_protocol_with_heterogeneous_vocabularies():
    """Twin of tests/test_system.py:59: stage 1 merges two clients'
    different vocabularies, stage 2 trains Algorithm 1 with adam on the
    re-indexed BoWs; shapes line up and the loss falls."""
    rng = np.random.default_rng(0)
    terms_a = [f"w{i}" for i in range(60)]
    terms_b = [f"w{i}" for i in range(40, 110)]
    bow_a = rng.poisson(0.8, (80, len(terms_a))).astype(np.float32)
    bow_b = rng.poisson(0.8, (90, len(terms_b))).astype(np.float32)
    v = vocab.merge_vocabularies([vocab.Vocabulary.from_bow(bow_a, terms_a),
                                  vocab.Vocabulary.from_bow(bow_b, terms_b)])
    ga = vocab.reindex_bow(bow_a, terms_a, v)
    gb = vocab.reindex_bow(bow_b, terms_b, v)
    assert ga.shape[1] == gb.shape[1] == len(v) == 110
    cfg = ModelConfig(name="hetvocab", kind=NTM, vocab_size=len(v),
                      num_topics=6, ntm_hidden=(32, 32))
    jcfg = JModelConfig(name="hetvocab", kind=NTM, vocab_size=len(v),
                        num_topics=6, ntm_hidden=(32, 32))
    init = _host(jprodlda.init_params(jax.random.PRNGKey(0), jcfg))
    clients = [ClientState(data={"bow": torch.from_numpy(g)},
                           num_docs=len(g)) for g in (ga, gb)]
    tr = protocol.FederatedTrainer(
        lambda p, b: prodlda.elbo_loss(p, cfg, b, train=False), init,
        clients,
        FederatedConfig(learning_rate=2e-3, max_rounds=25, rel_tol=0.0),
        optimizer=opt.adam(2e-3), batch_size=32)
    tr.fit(seed=0)
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]
    assert prodlda.get_topics(tr.params).shape == (6, len(v))
