"""Message transforms on the port's host loop (Algorithm 1) and in its
buffered-async service, against the JAX package's loop runs.

Both packages run each registry scenario with ``exec_mode="loop"`` from
the same corpus and the reference's init weights (the
``tests/test_torch_loop.py`` harness); ``batch_size`` is the whole
pooled corpus (the partition cells re-split it, so one client may hold
more than ``docs_per_node`` documents), which makes every draw the whole
client corpus, so ``topk``, ``precision``, ``secure`` and ``dp`` runs
differ only in fp32 summation order and, for ``dp``, the few-ulp
rounding of the noise's ``erfinv``: every round's parameters agree
within 1e-5 and the round records' integers are equal.  Both packages
draw the secure masks (bitwise) and the dp noise from the reference's
threefry keys, so the reference's own ``dp`` entry runs here.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import Federation as JFederation
from repro.api import FederationSpec as JSpec
from repro.api import spec_replace as jspec_replace
from repro.api.registry import scenario_spec as jscenario
from repro.serve import FederationService as JService
from repro.serve import run_traffic as jrun_traffic
from repro_torch.api import (Federation, FederationSpec, max_param_dev,
                             scenario_spec, spec_replace)
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import protocol
from repro_torch.core import prng
from repro_torch.core import transforms as ttr
from repro_torch.core.engine import ClientState
from repro_torch.core.ntm import prodlda
from repro_torch.core.ntm.prodlda import params_from_reference
from repro_torch.kernels import ops
from repro_torch.serve import FederationService, run_traffic

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

TOL = 1e-5
ROUNDS = 6
INTS = ("round", "participants", "arrived", "superseded", "in_flight")
_SMALL = {"model": {"vocab": 64, "topics": 4, "hidden": 16},
          "data": {"num_clients": 3, "docs_per_node": 40,
                   "val_docs_per_node": 8},
          "schedule": {"rounds": ROUNDS},
          "execution": {"batch_size": 120, "learning_rate": 2e-4}}
TRANSFORM_CELLS = ("topk-transform", "precision-transform",
                   "secure-transform", "dp-transform", "dp-straggler")
PARTITION_CELLS = ("dirichlet-noniid", "quantity-skew", "dropout-join")


def _host(tree):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, tree))


def _pair(name, overrides=None):
    js = jscenario(name, JSpec.from_dict(_SMALL))
    if overrides:
        js = jspec_replace(js, overrides)
    jf = JFederation.from_spec(js)
    tf = Federation.from_spec(FederationSpec.from_dict(js.to_dict()),
                              device="cpu", init_params=_host(jf.params))
    return jf, tf


@pytest.fixture(scope="module")
def runs():
    """Each cell run once in both packages, round by round: parameter
    deviations, both records, and both pending lists after each round."""
    out = {}
    for name in TRANSFORM_CELLS + PARTITION_CELLS:
        jf, tf = _pair(name)
        devs, recs, pend = [], [], []
        for _ in range(ROUNDS):
            recs.append((jf.step(), tf.step()))
            devs.append(max_param_dev(_host(jf.params), tf.params))
            pend.append(tuple(
                [(p.client, p.issued_round, p.due_round, p.weight)
                 for p in f.engine.pending] for f in (jf, tf)))
        out[name] = (jf, tf, devs, recs, pend)
    return out


@pytest.mark.parametrize("name", TRANSFORM_CELLS + PARTITION_CELLS)
def test_loop_trajectory_tracks_reference(runs, name):
    jf, tf, devs, recs, pend = runs[name]
    print(f"{name}: max_param_dev per round "
          + ", ".join(f"{d:.3e}" for d in devs))
    assert tf.engine.exec_mode == jf.engine.exec_mode == "loop"
    assert max(devs) <= TOL
    for a, b in recs:
        assert {k: a[k] for k in INTS} == {k: b[k] for k in INTS}
        assert abs(a["loss"] - b["loss"]) <= TOL * abs(a["loss"])
        assert (a["rel_change"] > 0) == (b["rel_change"] > 0)
    for want, got in pend:
        assert want == got


def test_cells_exercise_what_they_name(runs):
    """dp-straggler delays and delivers transformed messages; the
    partition cells re-split the corpus; dropout-join drops a client."""
    strag = [b for _, b in runs["dp-straggler"][3]]
    assert any(r["in_flight"] for r in strag)
    assert sum(r["arrived"] for r in strag) \
        != sum(r["participants"] for r in strag)
    for name in ("dirichlet-noniid", "quantity-skew"):
        sizes = [c.num_docs for c in runs[name][1].engine.clients]
        assert sum(sizes) == 120 and sizes != [40, 40, 40]
    assert [b["participants"] for _, b in runs["dropout-join"][3]] \
        == [2, 2, 3, 3, 3, 2]
    # dp moved the trajectory away from the plain one
    dp, sec = runs["dp-transform"][1], runs["secure-transform"][1]
    assert max_param_dev(dp.params, sec.params) > 1e-4


def test_topk_error_memory_tracks_reference(runs):
    """The (L, D) error memory, one row per client, equals the
    reference's per-client memory in the port's flat layout."""
    jf, tf, _, _, _ = runs["topk-transform"]
    got = tf.engine._tstate["topk"]
    for l, c in enumerate(jf.engine.clients):
        want = _host(c.error_memory)
        flat = torch.cat([want[name].reshape(-1)
                          for name, _, _, _ in tf.engine.layout])
        dev = float(torch.max(torch.abs(got[l] - flat)))
        assert dev <= TOL and float(torch.max(torch.abs(got[l]))) > 0


@pytest.mark.parametrize("name", ["dp-transform", "topk-transform",
                                  "secure-transform", "precision-transform"])
def test_loop_equals_vmap_in_the_port(name):
    base = FederationSpec.from_dict(_SMALL)
    feds, init = [], None
    for mode in ("loop", "vmap"):
        spec = spec_replace(scenario_spec(name, base),
                            {"execution.exec_mode": mode,
                             "schedule.rounds": 3})
        f = Federation.from_spec(spec, device="cpu", init_params=init)
        init = dict(f.params)
        f.run()
        feds.append(f)
    dev = max_param_dev(feds[0].params, feds[1].params)
    print(f"{name}: loop vs vmap max_param_dev {dev:.3e}")
    assert dev <= TOL
    for a, b in zip(feds[0].history, feds[1].history):
        assert {k: a[k] for k in INTS} == {k: b[k] for k in INTS}
    if name == "topk-transform":
        assert torch.equal(feds[0].engine._tstate["topk"],
                           feds[1].engine._tstate["topk"])
    if name == "secure-transform":
        for r in range(3):
            total = ttr.pairwise_mask_stack(r, feds[0].engine.layout, 3,
                                            "cpu").sum(dim=0)
            assert torch.equal(total.view(torch.int32),
                               torch.zeros_like(total).view(torch.int32))


@pytest.mark.parametrize("name,overrides,rows", [
    ("dp-transform", None, 3), ("secure-transform", None, 3),
    ("topk-transform", None, 3),
    ("topk-transform", {"schedule.clients_per_round": 2}, 2),
    ("dp-straggler", None, 3)])
def test_one_kernel_call_per_transformed_round(monkeypatch, name, overrides,
                                               rows):
    """The stage takes the round's (n, D) slab in one call: one B3 call
    for dp or secure, one B4 call for topk, each round, never one per
    client."""
    calls = []
    for fn in ("fed_dp_secure_apply", "fed_topk_ef"):
        real = getattr(ops, fn)

        def counted(msgs, *a, _real=real, _fn=fn, **kw):
            calls.append((_fn, tuple(msgs.shape)))
            return _real(msgs, *a, **kw)
        monkeypatch.setattr(ops, fn, counted)
    spec = scenario_spec(name, FederationSpec.from_dict(_SMALL))
    if overrides:
        spec = spec_replace(spec, overrides)
    fed = Federation.from_spec(spec, device="cpu")
    kernel = "fed_topk_ef" if "topk" in name else "fed_dp_secure_apply"
    d = fed.engine.layout[-1][2] + fed.engine.layout[-1][3]
    for _ in range(4):
        before = len(calls)
        fed.step()
        assert calls[before:] == [(kernel, (rows, d))]


def test_trainer_grad_transforms_under_loop():
    """Twin of the reference's grad-transform test under loop mode:
    secure aggregation leaves the trajectory where plain training puts
    it, DP noise does not (lr 5e-4: at V=64 from the reference's init
    plain SGD at 1e-3 and above diverges by the third round, and then
    every trajectory differs)."""
    from repro_torch.configs.base import NTM, ModelConfig
    from repro_torch.data.synthetic_lda import generate_lda_corpus
    syn = generate_lda_corpus(vocab_size=64, num_topics=4, num_nodes=3,
                              shared_topics=1, docs_per_node=40,
                              val_docs_per_node=8, seed=0)
    cfg = ModelConfig(name="t", kind=NTM, vocab_size=64, num_topics=4,
                      ntm_hidden=(16, 16))
    init = prodlda.init_params(prng.PRNGKey(0), cfg)
    clients = [ClientState(data={"bow": torch.from_numpy(b)},
                           num_docs=len(b)) for b in syn.node_bows]
    loss = lambda p, b: prodlda.elbo_loss(p, cfg, b)  # noqa: E731
    runs = {}
    for label, kw in (("plain", {}), ("secure", {"secure_aggregation": True}),
                      ("dp", {"dp_noise_multiplier": 0.5})):
        fed = FederatedConfig(num_clients=3, learning_rate=5e-4,
                              max_rounds=4, rel_tol=0.0, **kw)
        tr = protocol.FederatedTrainer(loss, init, clients, fed,
                                       batch_size=32)
        assert tr.exec_mode == "loop"
        tr.fit(seed=3)
        assert all(h["loss"] < 1e4 for h in tr.history)     # no blow-up
        runs[label] = tr.params
    assert max_param_dev(runs["plain"], runs["secure"]) < 1e-4
    assert max_param_dev(runs["plain"], runs["dp"]) > 1e-4


# ---------------------------------------------------------------------------
# the buffered-async service: one (1, D) stage call per upload
# ---------------------------------------------------------------------------
_SERVICE = {"model": {"vocab": 64, "topics": 4, "hidden": 16},
            "data": {"num_clients": 3, "docs_per_node": 40,
                     "val_docs_per_node": 8},
            "schedule": {"rounds": 3, "mode": "buffered_async"},
            "execution": {"batch_size": 64, "learning_rate": 2e-4}}
SERVICE_TRANSFORMS = {
    "topk": {"transforms.names": ("topk",),
             "transforms.compression_topk": 0.25},
    "precision": {"transforms.names": ("precision",),
                  "transforms.precision": "bf16"},
    "dp": {"transforms.names": ("dp",),
           "transforms.dp_noise_multiplier": 0.3,
           "transforms.dp_clip_norm": 0.05},
}


@pytest.mark.parametrize("which", sorted(SERVICE_TRANSFORMS))
def test_service_transforms_track_reference(monkeypatch, which):
    """The ``buffered_async`` preset with transformed uploads, both
    services over the same traffic (held and duplicated uploads): the
    same events and rejections, parameters within 1e-5, and one kernel
    call on a (1, D) slab per computed upload."""
    js = jspec_replace(jscenario("buffered_async",
                                 JSpec.from_dict(_SERVICE)),
                       SERVICE_TRANSFORMS[which])
    jsvc = JService.from_spec(js)
    tsvc = FederationService.from_spec(
        FederationSpec.from_dict(js.to_dict()), device="cpu",
        init_params=_host(jsvc._live[1]))
    calls = []
    for fn in ("fed_dp_secure_apply", "fed_topk_ef"):
        real = getattr(ops, fn)

        def counted(msgs, *a, _real=real, **kw):
            calls.append(tuple(msgs.shape))
            return _real(msgs, *a, **kw)
        monkeypatch.setattr(ops, fn, counted)
    kw = dict(sweeps=4, order_seed=3, hold_prob=0.3, duplicate_prob=0.3,
              infer_every=2, infer_batch=4)
    jstats, tstats = jrun_traffic(jsvc, **kw), run_traffic(tsvc, **kw)
    jsvc.shutdown()
    tsvc.shutdown()
    events = [{k: v for k, v in s.items()
               if "latency" not in k and "throughput" not in k}
              for s in (jstats, tstats)]
    assert events[0] == events[1] and tstats["aggregations"] >= 3
    assert tsvc.rejections == jsvc.rejections
    assert tsvc.history == jsvc.history
    dev = max_param_dev(_host(jsvc._live[1]), tsvc._live[1])
    print(f"service {which}: {tstats['aggregations']} aggregations, "
          f"max_param_dev {dev:.3e}")
    assert dev <= TOL
    d = tsvc._fed.engine.layout[-1][2] + tsvc._fed.engine.layout[-1][3]
    # one client_update (one computed upload) per traffic step
    n_kernel = 0 if which == "precision" else tstats["steps"]
    assert calls == [(1, d)] * n_kernel


def test_bench_scenarios_run_under_the_default_loop_base():
    """The reference's scenario sweep, all 19 cells: every cell's spec is
    the reference's dict and runs two rounds on the port, the transform
    and partition cells on the host loop under the default base, the
    ``mesh-*`` cells on the batched path over a one-shard mesh under the
    vmap base (L = 3 clients: ``_mesh_overrides`` resolves data to 1)."""
    from repro.api.registry import BENCH_SCENARIOS as JBENCH
    from repro_torch.api.registry import BENCH_SCENARIOS
    assert BENCH_SCENARIOS == tuple(JBENCH)
    jbase = JSpec.from_dict(_SMALL)
    jvbase = jspec_replace(jbase, {"execution.exec_mode": "vmap"})
    for name in BENCH_SCENARIOS:
        jb = jvbase if name.startswith("mesh-") else jbase
        spec = scenario_spec(name, FederationSpec.from_dict(jb.to_dict()))
        assert spec.to_dict() == jscenario(name, jb).to_dict()
        fed = Federation.from_spec(spec, device="cpu")
        fed.run(rounds=2)
        assert fed.round_index == 2 and np.isfinite(fed.history[0]["loss"])
        want = "vmap" if name.startswith(("pallas-", "mesh-")) else "loop"
        assert fed.engine.exec_mode == want, name
        assert fed.mesh_shape == ({"data": 1} if name.startswith("mesh-")
                                  else None), name


def test_federate_serve_cli_takes_transform_flags(tmp_path):
    from repro_torch.launch import federate_serve
    res = federate_serve.main([
        "--vocab", "64", "--topics", "4", "--hidden", "16",
        "--num-clients", "3", "--docs-per-node", "20", "--val-docs", "4",
        "--buffer-size", "2", "--sweeps", "2", "--lr", "2e-4",
        "--transforms", "topk", "--topk", "0.25", "--device", "cpu",
        "--out", str(tmp_path / "serve.json")])
    assert res["spec"]["transforms"]["names"] == ["topk"]
    assert res["spec"]["transforms"]["compression_topk"] == 0.25
    assert res["traffic"]["aggregations"] >= 1
    assert np.isfinite(res["heldout_elbo_per_token"])
    with pytest.raises(ValueError, match="buffered_async"):
        federate_serve.main(["--transforms", "secure", "--device", "cpu"])
