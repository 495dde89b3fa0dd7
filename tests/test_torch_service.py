"""The port's buffered-async service against the JAX reference service.

The slice as a whole: the JAX ``FederationService`` runs with
``execution.kernel_backend="pallas"`` (interpret mode on the CPU), the
port's with ``device="cpu"`` (the plain kernel versions), from the same
corpus and the same carried init weights.  ``batch_size >=
docs_per_node`` makes every draw the whole client corpus, so the two
differ only in fp32 summation order, and every trajectory must agree
within 1e-5.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.api import FederationSpec as JSpec
from repro.api import spec_replace as jspec_replace
from repro.api.registry import scenario_spec as jscenario
from repro.metrics import npmi_coherence as jnpmi
from repro.metrics import tss as jtss
from repro.serve import FederationService as JService
from repro.serve import run_traffic as jrun_traffic
from repro_torch.api import FederationSpec, max_param_dev, scenario_names, \
    scenario_spec, spec_replace
from repro_torch.core.ntm.prodlda import params_from_reference
from repro_torch.launch import federate_serve
from repro_torch.metrics import npmi_coherence, tss
from repro_torch.serve import (REJECT_REASONS, FederationService,
                               UploadTimeout, run_traffic)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

_SMALL = {"model": {"vocab": 64, "topics": 4, "hidden": 16},
          "data": {"num_clients": 3, "docs_per_node": 40,
                   "val_docs_per_node": 8},
          "schedule": {"rounds": 3, "mode": "buffered_async"},
          "execution": {"batch_size": 64, "learning_rate": 2e-4,
                        "kernel_backend": "pallas"}}


def _specs(overrides=None):
    """The same spec in both packages (the reference's dict form)."""
    j = JSpec.from_dict(_SMALL)
    if overrides:
        j = jspec_replace(j, overrides)
    return j, FederationSpec.from_dict(j.to_dict())


def _pair(overrides=None):
    js, ts = _specs(overrides)
    jsvc = JService.from_spec(js)
    init = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jsvc._live[1]))
    return jsvc, FederationService.from_spec(ts, device="cpu",
                                             init_params=init)


def _dev(jsvc, tsvc) -> float:
    ref = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jsvc._live[1]))
    return max_param_dev(ref, tsvc._live[1])


def _events(stats):
    return {k: v for k, v in stats.items()
            if "latency" not in k and "throughput" not in k}


# ---------------------------------------------------------------------------
# the slice against the reference
# ---------------------------------------------------------------------------
def test_sync_equivalence_anchor_matches_reference():
    """M=K, max_staleness=0, 3x3 in-order uploads (the reference's
    tests/test_serve_service.py anchor), both services side by side."""
    jsvc, tsvc = _pair({"schedule.max_staleness": 0})
    for _ in range(3):
        for c in range(3):
            assert jsvc.upload(c)["accepted"]
            assert tsvc.upload(c)["accepted"]
    assert (tsvc.version, tsvc.agg_index) == (jsvc.version,
                                             jsvc.agg_index) == (3, 3)
    assert tsvc.rejections == [] == jsvc.rejections
    dev = _dev(jsvc, tsvc)
    print(f"anchor (M=K, staleness 0, 3x3 uploads): max_param_dev {dev:.3e}")
    assert dev <= 1e-5


@pytest.fixture(scope="module")
def traffic_pair():
    """Both services after one ``buffered_async`` (M=2, staleness 2,
    polynomial) traffic schedule with held and duplicated uploads."""
    js, _ = _specs()
    preset = jscenario("buffered_async", js)
    jsvc = JService.from_spec(preset)
    init = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jsvc._live[1]))
    tsvc = FederationService.from_spec(
        FederationSpec.from_dict(preset.to_dict()), device="cpu",
        init_params=init)
    kw = dict(sweeps=5, order_seed=3, hold_prob=0.3, duplicate_prob=0.3,
              infer_every=2, infer_batch=4)
    stats = (jrun_traffic(jsvc, **kw), run_traffic(tsvc, **kw))
    drained = (jsvc.shutdown(), tsvc.shutdown())
    return jsvc, tsvc, stats, drained


def test_traffic_schedule_replays_reference(traffic_pair):
    jsvc, tsvc, (jstats, tstats), (jdrain, tdrain) = traffic_pair
    assert _events(tstats) == _events(jstats)
    assert tstats["aggregations"] >= 3 and tstats["held"] >= 1
    assert set(jstats["rejections"]) & {"stale", "superseded"}
    assert tsvc.rejections == jsvc.rejections        # reason for reason
    assert tsvc.history == jsvc.history
    assert tdrain == jdrain
    dev = _dev(jsvc, tsvc)
    print(f"run_traffic ({tstats['aggregations']} aggregations, "
          f"rejections {tstats['rejections']}): max_param_dev {dev:.3e}")
    assert dev <= 1e-5


def test_infer_matches_reference(traffic_pair):
    jsvc, tsvc, _, _ = traffic_pair
    bow = np.random.default_rng(4).poisson(1.0, (6, 64)).astype(np.float32)
    want = np.asarray(jsvc.infer(bow))
    got = tsvc.infer(bow)
    assert got.shape == (6, 4) and got.device.type == "cpu"
    print(f"infer: max |theta diff| {np.max(np.abs(got.numpy() - want)):.3e}")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_evaluate_matches_reference(traffic_pair):
    jsvc, tsvc, _, _ = traffic_pair
    want, got = jsvc.evaluate(), tsvc.evaluate()
    assert set(got) == set(want)
    rel = abs(got["heldout_elbo_per_token"]
              - want["heldout_elbo_per_token"]) \
        / abs(want["heldout_elbo_per_token"])
    print(f"evaluate: heldout_elbo_per_token rel diff {rel:.3e}")
    assert rel <= 1e-5
    assert np.isfinite(got["tss"]) and np.isfinite(got["npmi_coherence"])


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_on_identical_inputs(seed):
    """tss and npmi_coherence on the same beta and bows (top-word ties may
    reorder after training, so the trained metrics are not compared)."""
    rng = np.random.default_rng(seed)
    beta_true = rng.dirichlet(np.full(64, 0.1), size=4).astype(np.float32)
    beta = rng.dirichlet(np.full(64, 0.5), size=4).astype(np.float32)
    bows = rng.poisson(0.5, (30, 64)).astype(np.float32)
    d_tss = abs(tss(beta_true, beta) - jtss(beta_true, beta))
    d_npmi = abs(npmi_coherence(beta, bows) - jnpmi(beta, bows))
    print(f"metrics: |tss diff| {d_tss:.3e}, |npmi diff| {d_npmi:.3e}")
    assert d_tss <= 1e-6 and d_npmi <= 1e-6


# ---------------------------------------------------------------------------
# the service's own contract (the reference's pins, on the port)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus():
    from repro_torch.api import build_corpus
    return build_corpus(_specs()[1])


def _svc(corpus, **overrides):
    spec = _specs()[1]
    if overrides:
        spec = spec_replace(spec, overrides)
    return FederationService.from_spec(spec, device="cpu", corpus=corpus)


def test_rejection_ledger(corpus):
    svc = _svc(corpus, **{"schedule.buffer_size": 2})       # staleness 0
    bv, delta, w = svc.client_update(0)
    for c in (1, 2):
        svc.upload(c)
    assert svc.version == 1
    assert svc.submit(0, delta, w, base_version=bv)["reason"] == "stale"
    assert svc.submit(9, delta, w, base_version=1)["reason"] \
        == "unknown_client"
    assert svc.submit(0, delta, 0.0, base_version=1)["reason"] \
        == "zero_weight"
    assert svc.submit(0, delta, w, base_version=99)["reason"] \
        == "bad_version"
    assert svc.rejections[0] == {"client": 0, "base_version": 0,
                                 "at_version": 1, "reason": "stale"}
    assert set(svc.rejection_counts) <= set(REJECT_REASONS)
    with pytest.raises(ValueError, match="clients 0..2"):
        svc.client_update(7)


def test_supersede_overwrites_in_place(corpus):
    svc = _svc(corpus, **{"schedule.buffer_size": 3,
                          "schedule.max_staleness": 2})
    bv, d1, w1 = svc.client_update(0)
    assert svc.submit(0, d1, w1, base_version=bv)["accepted"]
    bv2, d2, w2 = svc.client_update(0)
    r = svc.submit(0, d2, w2, base_version=bv2)
    assert r["accepted"] and r["superseded_previous"] and r["slot"] == 0
    assert svc.buffer.count == 1
    assert svc.rejection_counts == {"superseded": 1}
    got = {k: v[0] for k, v in svc.buffer.leaves.items()}
    assert max_param_dev(got, d2) == 0.0


def test_upload_retry_backoff_drain_and_draining(corpus):
    svc = _svc(corpus, **{"schedule.buffer_size": 3,
                          "schedule.max_staleness": 1})
    sleeps, fails = [], {"n": 2}

    def flaky(client, attempt):
        if fails["n"]:
            fails["n"] -= 1
            raise UploadTimeout("wire dropped")

    assert svc.upload(0, backoff_s=0.01, transport=flaky,
                      sleep_fn=sleeps.append)["accepted"]
    assert sleeps == [0.01, 0.02]

    def dead(client, attempt):
        raise UploadTimeout("wire gone")

    r = svc.upload(1, max_retries=0, transport=dead, sleep_fn=sleeps.append)
    assert r["reason"] == "upload_failed" and sleeps == [0.01, 0.02]
    before = svc._live[1]
    assert svc.shutdown()["flushed"] == 1 and svc.version == 1
    assert max_param_dev(before, svc._live[1]) > 0.0
    assert svc.upload(2)["reason"] == "draining"


def test_stale_delta_is_discounted(corpus):
    moved = {}
    for policy in ("exponential", "polynomial"):
        svc = _svc(corpus, **{"schedule.buffer_size": 1,
                              "schedule.max_staleness": 3,
                              "schedule.staleness_policy": policy})
        bv, delta, w = svc.client_update(0)
        svc.upload(1)
        svc.upload(2)
        anchor = svc._live[1]
        assert svc.submit(0, delta, w, base_version=bv)["accepted"]
        assert svc.history[-1] == {"agg": 2, "version": 3, "arrivals": 1,
                                   "mean_age": 2.0, "max_age": 2}
        moved[policy] = max_param_dev(anchor, svc._live[1])
    assert moved["polynomial"] > 1.5 * moved["exponential"] > 0.0


@pytest.mark.parametrize("opt", ["fedavgm", "fedadam"])
def test_server_optimizers_match_reference(opt):
    jsvc, tsvc = _pair({"schedule.buffer_size": 2,
                        "schedule.max_staleness": 1,
                        "server_opt.name": opt, "server_opt.lr": 0.05})
    for svc in (jsvc, tsvc):
        for c in (0, 1, 2, 0):
            svc.upload(c)
    assert jsvc.version == tsvc.version == 2
    dev = _dev(jsvc, tsvc)
    print(f"{opt}: max_param_dev {dev:.3e}")
    assert dev <= 1e-5
    for k, v in tsvc.server_state.items():
        assert all(t.dtype == torch.float32 for t in v.values()), k


# ---------------------------------------------------------------------------
# spec surface, refusals, device rule, launcher, import guard
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["paper", "buffered_async",
                                  "buffered_async_eq"])
def test_registry_specs_round_trip_to_the_reference_dict(name):
    js, _ = _specs()
    for base_j in (None, js):
        base_t = None if base_j is None else \
            FederationSpec.from_dict(base_j.to_dict())
        want = jscenario(name, base_j).to_dict()
        got = scenario_spec(name, base_t)
        assert got.to_dict() == want
        assert FederationSpec.from_dict(want) == got
    assert {"paper", "buffered_async", "buffered_async_eq"} \
        <= set(scenario_names())


# the former A9 and A2 refusals are running paths now (their ids kept)
@pytest.mark.parametrize("overrides,item", [
    pytest.param({"transforms.names": ("dp",),
                  "transforms.dp_noise_multiplier": 0.3}, None,
                 id="overrides0-A9"),
    ({"execution.exec_mode": "vmap", "schedule.mode": "sync",
      "schedule.straggler_prob": 0.3, "schedule.max_staleness": 2}, "A10"),
    ({"execution.mesh": {"data": 2}}, "A17"),
    # an LM arch whose layers the port lacks (LM federation runs since
    # the seventh slice; the rest of the zoo is A16b)
    ({"model.family": "lm", "model.arch": "granite-34b",
      "model.topics": 10, "model.hidden": 64}, "A16"),
    ({"serving": {"host": "127.0.0.1", "port": 0}}, "A14"),
    pytest.param({"data.partition": "dirichlet(0.3)"}, None,
                 id="overrides5-A2"),
    # the train-mode ELBO runs since the eighth slice
    pytest.param({"execution.stochastic_loss": True}, None,
                 id="overrides6-A4"),
])
def test_sections_outside_the_slice_raise(overrides, item):
    """The sections of later slices raise naming their ROADMAP item;
    upload transforms and non-``topic`` partitions now run (item None):
    the service builds and accepts an upload."""
    if item is None:
        svc = FederationService.from_spec(
            spec_replace(_specs()[1], overrides), device="cpu")
        assert svc.upload(0)["accepted"] and svc.buffer.count == 1
        return
    with pytest.raises(NotImplementedError, match=item):
        spec_replace(_specs()[1], overrides)


def test_later_slice_surfaces_raise(corpus):
    svc = _svc(corpus)
    for call, item in ((lambda: svc.state_dict(), "A11"),
                       (lambda: svc.save_checkpoint("x.pkl"), "A11")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    # infer(contextual=...) runs (A3): the spec-built model reads the BoW
    bow = corpus.node_val_bows[0][:3]
    assert torch.equal(svc.infer(bow, contextual=np.ones((3, 8))),
                       svc.infer(bow))
    # generate is the LM family's surface, refused on an NTM service
    # with the reference's ValueError
    with pytest.raises(ValueError, match="infer"):
        svc.generate(np.zeros((1, 2)))


def test_from_spec_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederationService.from_spec(_specs()[1])


def test_launcher_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "serve.json"
    res = federate_serve.main([
        "--vocab", "64", "--topics", "4", "--hidden", "16",
        "--num-clients", "3", "--docs-per-node", "20", "--val-docs", "4",
        "--buffer-size", "2", "--sweeps", "2", "--lr", "2e-4",
        "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "serving buffered-async federation: M=2/3 clients" in text
    assert "aggregations -> version" in text and out.exists()
    assert res["device"] == "cpu" and res["traffic"]["aggregations"] >= 1
    assert np.isfinite(res["heldout_elbo_per_token"])
    with pytest.raises(NotImplementedError, match="A11"):
        federate_serve.main(["--checkpoint", "x.pkl", "--device", "cpu"])


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
