"""The port's synchronous batched cohort path against the JAX package.

The JAX ``Federation`` runs each scenario with ``exec_mode="vmap"`` and
``kernel_backend="pallas"`` (the Pallas kernels in interpret mode on the
CPU); the port's runs with ``device="cpu"`` (the kernels' plain
versions), from the same corpus (bitwise equal,
tests/test_torch_data.py) and the reference's init weights.  ``batch_size >= docs_per_node`` makes every
draw the whole client corpus, so the two differ only in fp32 summation
order, and every round's parameters must agree within 1e-5.  The secure
masks differ in value (threefry against CPU generators) but cancel
exactly in both, so secure runs agree too.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import Federation as JFederation
from repro.api import FederationSpec as JSpec
from repro.api import spec_replace as jspec_replace
from repro.api.registry import scenario_spec as jscenario
from repro.data.federated_split import \
    stacked_round_batches as jstacked_round_batches
from repro_torch.api import (Federation, FederationSpec, max_param_dev,
                             scenario_names, scenario_spec, spec_replace)
from repro_torch.core.ntm.prodlda import params_from_reference
from repro_torch.data.federated_split import stacked_round_batches

TOL = 1e-5
ROUNDS = 3
_SMALL = {"model": {"vocab": 64, "topics": 4, "hidden": 16},
          "data": {"num_clients": 3, "docs_per_node": 40,
                   "val_docs_per_node": 8},
          "schedule": {"rounds": ROUNDS},
          "execution": {"batch_size": 64, "learning_rate": 2e-4,
                        "exec_mode": "vmap"}}
ADDED = ("sync", "dp-transform", "topk-transform", "secure-transform",
         "precision-transform", "hetero-epochs", "pallas-aggregate",
         "pallas-topk", "pallas-secure", "dirichlet-noniid",
         "quantity-skew", "dropout-join", "dirichlet_niid", "private_vmap")


def _host(tree):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, tree))


def _pair(name, overrides=None):
    """The named scenario over the small vmap base, in both packages."""
    js = jscenario(name, JSpec.from_dict(_SMALL))
    if overrides:
        js = jspec_replace(js, overrides)
    jf = JFederation.from_spec(js)
    tf = Federation.from_spec(FederationSpec.from_dict(js.to_dict()),
                              device="cpu", init_params=_host(jf.params))
    return jf, tf


def _run(name, overrides=None):
    jf, tf = _pair(name, overrides)
    devs, recs = [], []
    for _ in range(ROUNDS):
        recs.append((jf.step(), tf.step()))
        devs.append(max_param_dev(_host(jf.params), tf.params))
    return jf, tf, devs, recs


@pytest.fixture(scope="module")
def runs():
    """Each parity scenario run once in both packages (the JAX runs
    compile their fused graphs, so they are shared across tests)."""
    cells = {name: _run(name) for name in
             ("pallas-aggregate", "pallas-topk", "pallas-secure")}
    cells["hetero-epochs"] = _run("hetero-epochs",
                                  {"execution.exec_mode": "vmap"})
    cells["pallas-topk-partial"] = _run("pallas-topk",
                                        {"schedule.clients_per_round": 2})
    return cells


@pytest.mark.parametrize("cell", ["pallas-aggregate", "pallas-topk",
                                  "pallas-secure", "hetero-epochs",
                                  "pallas-topk-partial"])
def test_trajectory_tracks_reference(runs, cell):
    jf, tf, devs, recs = runs[cell]
    print(f"{cell}: max_param_dev per round "
          + ", ".join(f"{d:.3e}" for d in devs))
    assert max(devs) <= TOL
    for a, b in recs:
        for key in ("round", "participants", "arrived", "superseded",
                    "in_flight"):
            assert a[key] == b[key], key
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(a["loss"])
        assert b["rel_change"] > 0


def test_topk_error_memory_tracks_reference(runs):
    """The (L, D) error memory, gathered/scattered by client id, equals
    the reference's (L, ...) tree in the port's flat layout."""
    for cell in ("pallas-topk", "pallas-topk-partial"):
        jf, tf, _, _ = runs[cell]
        want = _host(jf.engine._tstate["topk"])
        got = tf.engine._tstate["topk"]
        assert got.shape == (3, sum(v[0].numel() for v in want.values()))
        flat = torch.cat([v.reshape(3, -1) for v in want.values()], dim=1)
        dev = float(torch.max(torch.abs(got - flat)))
        print(f"{cell}: error memory dev {dev:.3e}")
        assert dev <= TOL and float(torch.max(torch.abs(got))) > 0


def test_partial_participation_cohorts_match(runs):
    """clients_per_round=2 with pad_cohorts: the numpy scheduler draws the
    reference's cohorts bit for bit."""
    jf, tf, _, _ = runs["pallas-topk-partial"]
    assert tf.engine.scheduler.clients_per_round == 2
    for r in range(6):
        assert np.array_equal(jf.engine.scheduler.select(r),
                              tf.engine.scheduler.select(r))
    assert [h["participants"] for h in tf.history] == [2] * ROUNDS


@pytest.mark.parametrize("mode", ["uniform", "weighted", "deterministic"])
@pytest.mark.parametrize("churn", [False, True])
def test_round_scheduler_matches_reference(mode, churn):
    """numpy-only cohort sampling: the reference's cohorts bit for bit,
    with and without mid-training join/leave."""
    from repro.core.engine import RoundScheduler as JScheduler
    from repro_torch.core.engine import RoundScheduler
    kw = dict(mode=mode, seed=7, weights=[40, 10, 25, 5, 20] if
              mode == "weighted" else None)
    if churn:
        kw.update(join_rounds=(0, 2, 0, 1), leave_rounds=(0, 0, 5))
    want, got = JScheduler(5, 2, **kw), RoundScheduler(5, 2, **kw)
    for r in range(10):
        assert np.array_equal(want.active(r), got.active(r))
        assert np.array_equal(want.select(r), got.select(r))


def test_all_padded_round_is_a_bitwise_noop():
    """Nobody has joined in round 0: params and the fedavgm momentum stay
    bitwise as they were (mirrors tests/test_transforms_vmap.py:227);
    later rounds still track the reference."""
    jf, tf = _pair("pallas-aggregate",
                   {"schedule.client_join_round": (1, 1, 2),
                    "server_opt.name": "fedavgm",
                    "server_opt.momentum": 0.5})
    init = {k: v.clone() for k, v in tf.params.items()}
    jrec, rec = jf.step(), tf.step()
    assert rec == {**jrec, "loss": rec["loss"]} and np.isnan(rec["loss"])
    assert all(torch.equal(init[k], tf.params[k]) for k in init)
    assert all(not m.any() for m in tf.engine.server_state["m"].values())
    assert rec["rel_change"] == 0.0 and rec["participants"] == 0
    for _ in range(2):
        a, b = jf.step(), tf.step()
        assert a["participants"] == b["participants"] > 0
        assert max_param_dev(_host(jf.params), tf.params) <= TOL


def test_stacked_round_batches_pad_to_contract(rng):
    """Padded rows are all zero (data, mask, counts) and the real rows
    equal the unpadded call (mirrors tests/test_transforms_vmap.py:292)."""
    datas = [{"bow": torch.from_numpy(
        rng.poisson(0.5, (n, 16)).astype(np.float32))} for n in (20, 9)]
    plain, counts = stacked_round_batches(datas, [20, 9], 11, [0, 1],
                                          batch_size=8, local_epochs=2)
    padded, pcounts = stacked_round_batches(datas, [20, 9], 11, [0, 1],
                                            batch_size=8, local_epochs=2,
                                            pad_to=5)
    assert set(plain) == {"bow", "doc_mask"}
    for k in plain:
        assert padded[k].shape[0] == 5
        assert torch.equal(padded[k][:2], plain[k])
        assert not padded[k][2:].any()
    assert np.array_equal(pcounts[:2], counts) and not pcounts[2:].any()
    assert counts.tolist() == [[8, 8], [8, 8]]
    assert plain["doc_mask"].sum().item() == 32
    with pytest.raises(ValueError, match="pad_to"):
        stacked_round_batches(datas, [20, 9], 11, [0, 1], batch_size=8,
                              pad_to=1)
    # the same contract in the reference, shape for shape
    jdatas = [{"bow": d["bow"].numpy()} for d in datas]
    jst, jcounts = jstacked_round_batches(
        jdatas, [20, 9], jax.random.PRNGKey(11), [0, 1], batch_size=8,
        local_epochs=2, pad_to=5)
    assert np.array_equal(jcounts, pcounts)
    assert jst["doc_mask"].shape == tuple(padded["doc_mask"].shape)
    assert np.array_equal(jst["doc_mask"], padded["doc_mask"].numpy())


@pytest.mark.parametrize("name", ADDED)
def test_added_registry_entries_round_trip(name):
    jbase = JSpec.from_dict(_SMALL)
    tbase = FederationSpec.from_dict(jbase.to_dict())
    want = jscenario(name, jbase).to_dict()
    got = scenario_spec(name, tbase)
    assert got.to_dict() == want
    assert FederationSpec.from_dict(want) == got
    assert set(ADDED) <= set(scenario_names())


@pytest.mark.parametrize("overrides,item", [
    ({"execution.exec_mode": "loop"}, None),
    ({"schedule.straggler_prob": 0.3, "schedule.max_staleness": 2}, "A10"),
    # the former A9 refusal, now a running path (its id kept)
    pytest.param({"execution.exec_mode": "loop",
                  "transforms.names": ("topk",),
                  "transforms.compression_topk": 0.25}, None,
                 id="overrides2-A9"),
])
def test_paths_outside_the_slice_raise(overrides, item):
    """Stragglers on the batched path (A10) are refused at spec time; a
    loop-mode spec (Algorithm 1's host loop) steps, with a transform
    stage too (the per-client application)."""
    spec = FederationSpec.from_dict(_SMALL)
    if item is None:
        fed = Federation.from_spec(spec_replace(spec, overrides),
                                   device="cpu")
        rec = fed.step()
        assert fed.round_index == 1 and fed.history == [rec]
        assert rec["arrived"] == 3 and rec["rel_change"] > 0
    else:
        with pytest.raises(NotImplementedError, match=item):
            spec_replace(spec, overrides)


def test_run_hooks_and_stopping():
    spec = FederationSpec.from_dict(_SMALL)
    fed = Federation.from_spec(spec, device="cpu")
    seen = []
    fed.on_round_end(seen.append)
    fed.run(rounds=2)
    assert fed.round_index == 2 and seen == fed.history
    assert [h["round"] for h in seen] == [0, 1]
    fed.run()
    assert fed.round_index == ROUNDS
    stop = Federation.from_spec(spec_replace(spec,
                                             {"execution.rel_tol": 1.0}),
                                device="cpu")
    stop.run()
    assert stop.round_index == 1           # rel_change < 1 stops at once
    if not torch.cuda.is_available():       # the default device is cuda
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Federation.from_spec(spec)
