"""The port's loop-mode rounds (Algorithm 1's host loop, the host
pending list of stragglers) against the JAX package's loop
``Federation``, loop against batched in the port, and the
``launch.simulate`` CLI.

Both packages run each registry scenario with ``exec_mode="loop"`` from
the same corpus and the reference's init weights; ``batch_size >=
docs_per_node`` makes every draw the whole client corpus, so the two
differ only in fp32 summation order: every round's parameters agree
within 1e-5 and the round records' integers (participants, arrived,
superseded, in flight) are equal.  The straggler delays are numpy draws,
the reference's bit for bit.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.api import Federation as JFederation
from repro.api import FederationSpec as JSpec
from repro.api import spec_replace as jspec_replace
from repro.api.registry import scenario_spec as jscenario
from repro.launch import simulate as jsimulate
from repro_torch.api import (Federation, FederationSpec, max_param_dev,
                             scenario_spec, spec_replace)
from repro_torch.core.ntm.prodlda import params_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import simulate

TOL = 1e-5
INTS = ("round", "participants", "arrived", "superseded", "in_flight")
_SMALL = {"model": {"vocab": 64, "topics": 4, "hidden": 16},
          "data": {"num_clients": 3, "docs_per_node": 40,
                   "val_docs_per_node": 8},
          "schedule": {"rounds": 6},
          "execution": {"batch_size": 64, "learning_rate": 2e-4}}
CELLS = {
    "paper": ("paper", None),
    "partial": ("paper", {"schedule.clients_per_round": 2}),
    "hetero-epochs": ("hetero-epochs", None),
    "straggler": ("straggler", None),
    "straggler-heavy": ("straggler-heavy", None),
}


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
    for cell, (name, overrides) in CELLS.items():
        jf, tf = _pair(name, overrides)
        devs, recs, pend = [], [], []
        for _ in range(_SMALL["schedule"]["rounds"]):
            recs.append((jf.step(), tf.step()))
            devs.append(max_param_dev(_host(jf.params), tf.params))
            pend.append(tuple(
                [(p.client, p.issued_round, p.due_round, p.weight)
                 for p in f.engine.pending] for f in (jf, tf)))
        out[cell] = (jf, tf, devs, recs, pend)
    return out


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_loop_trajectory_tracks_reference(runs, cell):
    jf, tf, devs, recs, pend = runs[cell]
    print(f"{cell}: max_param_dev per round "
          + ", ".join(f"{d:.3e}" for d in devs)
          + "; (arrived, superseded, in_flight) "
          + ", ".join(str((b["arrived"], b["superseded"], b["in_flight"]))
                      for _, b in recs))
    assert tf.engine.exec_mode == "loop"
    assert max(devs) <= TOL
    for a, b in recs:
        assert {k: a[k] for k in INTS} == {k: b[k] for k in INTS}
        assert abs(a["loss"] - b["loss"]) <= TOL * abs(a["loss"])
        assert (a["rel_change"] > 0) == (b["rel_change"] > 0)
    for want, got in pend:
        assert want == got


def test_straggler_cells_exercise_the_pending_list(runs):
    """The straggler cells delay, deliver late and supersede: not a
    synchronous run in disguise."""
    for cell in ("straggler", "straggler-heavy"):
        recs = [b for _, b in runs[cell][3]]
        assert any(r["in_flight"] for r in recs)
        assert sum(r["arrived"] for r in recs) \
            != sum(r["participants"] for r in recs)
    heavy = [b for _, b in runs["straggler-heavy"][3]]
    assert sum(r["superseded"] for r in heavy) > 0
    assert [b["participants"] for _, b in runs["partial"][3]] == [2] * 6


def test_one_combine_per_round_with_an_arrival(monkeypatch):
    """Every round with an arrival makes exactly one
    ``ops.fed_weighted_combine`` call (one B2 launch on the card); a
    round where every message straggles makes none."""
    calls = []
    real = ops.fed_weighted_combine

    def counted(stacked, weights):
        calls.append(tuple(stacked.shape))
        return real(stacked, weights)
    monkeypatch.setattr(ops, "fed_weighted_combine", counted)
    spec = spec_replace(scenario_spec("straggler-heavy",
                                      FederationSpec.from_dict(_SMALL)),
                        {"schedule.rounds": 8})
    fed = Federation.from_spec(spec, device="cpu")
    n_arrivals = []
    for _ in range(8):
        before = len(calls)
        rec = fed.step()
        assert len(calls) - before == (1 if rec["arrived"] else 0)
        if rec["arrived"]:
            n_arrivals.append(rec["arrived"])
    assert [c[0] for c in calls] == n_arrivals
    # the slab rows come from one reused (L, D) buffer
    assert fed.engine._slab.shape == (3, calls[0][1])


@pytest.mark.parametrize("name,overrides", [
    ("sync", None), ("paper", {"schedule.clients_per_round": 2}),
    ("hetero-epochs", None)])
def test_loop_equals_vmap_in_the_port(name, overrides):
    base = FederationSpec.from_dict(_SMALL)
    feds, init = [], None
    for mode in ("loop", "vmap"):
        spec = spec_replace(scenario_spec(name, base),
                            {**(overrides or {}),
                             "execution.exec_mode": mode,
                             "schedule.rounds": 3})
        f = Federation.from_spec(spec, device="cpu", init_params=init)
        init = dict(f.params)
        f.run()
        feds.append(f)
    dev = max_param_dev(feds[0].params, feds[1].params)
    print(f"{name} {overrides}: loop vs vmap max_param_dev {dev:.3e}")
    assert dev <= TOL
    for a, b in zip(feds[0].history, feds[1].history):
        assert {k: a[k] for k in INTS} == {k: b[k] for k in INTS}


def test_default_spec_runs_algorithm_1_on_the_cpu():
    spec = FederationSpec.from_dict(_SMALL)
    assert spec.execution.exec_mode == "loop"
    fed = Federation.from_spec(spec, device="cpu")
    fed.run(rounds=3)
    assert fed.round_index == 3
    assert [h["arrived"] for h in fed.history] == [3, 3, 3]
    assert fed.history[-1]["loss"] < fed.history[0]["loss"]
    assert np.isfinite(fed.evaluate()["heldout_elbo_per_token"])
    with pytest.raises(NotImplementedError, match="A10"):
        spec_replace(scenario_spec("straggler", spec),
                     {"execution.exec_mode": "vmap"})
    topk = Federation.from_spec(
        spec_replace(spec, {"transforms.names": ("topk",),
                            "transforms.compression_topk": 0.25}),
        device="cpu")
    rec = topk.step()
    assert topk.engine.exec_mode == "loop" and rec["arrived"] == 3
    assert float(topk.engine._tstate["topk"].abs().max()) > 0


@pytest.mark.parametrize("name", ["straggler", "straggler-heavy", "paper",
                                  "dp-straggler", "dirichlet-noniid",
                                  "quantity-skew", "dropout-join",
                                  "dirichlet_niid"])
def test_straggler_registry_entries_round_trip(name):
    jbase = JSpec.from_dict(_SMALL)
    want = jscenario(name, jbase).to_dict()
    got = scenario_spec(name, FederationSpec.from_dict(jbase.to_dict()))
    assert got.to_dict() == want


def test_simulate_cli_matches_reference_keys(tmp_path, capsys):
    """``python -m repro_torch.launch.simulate --device cpu`` runs the
    paper regime, and its JSON has the reference launcher's keys."""
    flags = ["--rounds", "2", "--vocab", "64", "--topics", "4",
             "--hidden", "16", "--num-clients", "3", "--docs-per-node",
             "40", "--val-docs", "8", "--lr", "2e-4"]
    got = simulate.main(flags + ["--device", "cpu", "--out",
                                 str(tmp_path / "t.json")])
    want = jsimulate.main(flags + ["--out", str(tmp_path / "j.json")])
    on_disk = json.loads((tmp_path / "t.json").read_text())
    assert set(on_disk) == set(got) == set(want)
    assert set(got["config"]) == set(want["config"])
    assert got["spec"] == want["spec"]
    assert got["rounds_run"] == 2 and got["config"]["exec_mode"] == "loop"
    assert [{k: h[k] for k in INTS} for h in got["history"]] == \
        [{k: h[k] for k in INTS} for h in want["history"]]
    spec_file = tmp_path / "s.json"
    dumped = simulate.main(["--scenario", "straggler", "--device", "cpu",
                            "--dump-spec", str(spec_file)])
    assert FederationSpec.load(str(spec_file)).to_dict() == dumped["spec"]
    assert json.loads(spec_file.read_text()) == \
        jscenario("straggler").to_dict()
    with pytest.raises(ValueError, match="silently ignored"):
        simulate.main(["--scenario", "paper", "--rounds", "3"])
    with pytest.raises(NotImplementedError, match="A17"):
        simulate.main(flags + ["--mesh", "data=2", "--device", "cpu"])
    topk = ["--transforms", "topk", "--topk", "0.25", "--partition",
            "dirichlet(0.3)"]
    got = simulate.main(flags + topk + ["--device", "cpu"])
    want = jsimulate.main(flags + topk)
    assert got["spec"] == want["spec"]
    assert got["config"]["transforms"] == ["topk"]
    assert [{k: h[k] for k in INTS} for h in got["history"]] == \
        [{k: h[k] for k in INTS} for h in want["history"]]
    if not torch.cuda.is_available():       # the default device is cuda
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulate.main(flags)
