"""The mesh-sharded batched cohort path (``execution.mesh``) against the
JAX package.

The reference's own small federation (``tests/test_mesh_federation.py``:
V=128, 4 topics, hidden 16, 8 clients x 40 docs, batch 16, 3 rounds)
runs in the port over a ``("data",)`` mesh of CPU shards: the
stacked ``(K, ...)`` cohort, the ``(L, ...)`` top-k error memory and the
straggler ring split into row blocks, B2/B3/B4's plain versions once per
shard, every cross-row sum per-shard partials plus the port's ``psum``.
This process sees one JAX device, so the reference's sharded runs at
``data > 1`` cannot run here; the port's are held to the reference's
unsharded vmap run of the same spec (the reference's own contract,
``test_sharded_matches_unsharded``: within 1e-5) and to its own unsharded
run.  ``data=1`` is held to the reference's one-device mesh run, and is
bitwise the port's unsharded run: one shard computes what the unsharded
path computes, in the same order.  Bounds: 1e-5 on every parameter, the
history's integers equal, and bitwise where the reference proves bitwise
(mask cancellation, the per-row B3 apply, resume).

The client lr is 2e-4, not the reference file's 1e-3: from the seed's
init (the reference's threefry draws in both packages) that federation
diverges by its second round at 1e-3 and 5e-4 in the reference itself
(losses 887 -> 8.2e5 -> inf), and a diverging run turns the absolute
1e-5 bound into noise (ROADMAP.md §C: pick the lr, not the seed).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import Federation as JFederation
from repro.api import FederationSpec as JSpec
from repro.api import build_corpus as jbuild_corpus
from repro.api import spec_replace as jspec_replace
from repro.api.registry import BENCH_SCENARIOS as JBENCH
from repro.api.registry import scenario_spec as jscenario
from repro_torch.api import (BENCH_SCENARIOS, Federation, FederationSpec,
                             MeshSpec, build_corpus, max_param_dev,
                             scenario_spec, spec_replace)
from repro_torch.core.engine import flat_layout
from repro_torch.core.ntm import prodlda as tp
from repro_torch.core.transforms import pairwise_mask_stack
from repro_torch.data.federated_split import stacked_round_batches
from repro_torch.kernels import ops
from repro_torch.parallel import fed_mesh

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

TOL = 1e-5
INTS = ("round", "participants", "arrived", "superseded", "in_flight")
_BASE = {"model": {"vocab": 128, "topics": 4, "hidden": 16},
         "data": {"num_clients": 8, "docs_per_node": 40,
                  "val_docs_per_node": 8},
         "schedule": {"rounds": 3},
         "execution": {"exec_mode": "vmap", "batch_size": 16,
                       "learning_rate": 2e-4}}
# the reference's regimes (tests/test_mesh_federation.py _REGIMES)
REGIMES = {
    "sync": {},
    "dp-straggler": {"transforms.names": ("dp",),
                     "transforms.dp_noise_multiplier": 0.3,
                     "transforms.dp_clip_norm": 0.05,
                     "schedule.straggler_prob": 0.4,
                     "schedule.max_staleness": 2,
                     "schedule.staleness_decay": 0.5},
    "topk": {"transforms.names": ("topk",),
             "transforms.compression_topk": 0.25},
    "secure": {"transforms.names": ("secure",)},
    "churn": {"schedule.client_join_round": (0,) * 7 + (2,),
              "schedule.client_leave_round": (0,) * 7 + (3,)},
}
# the L >> K top-k case and the all-padded rounds (reference :194-220)
CASES = {
    **REGIMES,
    "lk-topk": {"data.num_clients": 16, "schedule.clients_per_round": 4,
                "schedule.sampling": "uniform", "schedule.rounds": 4,
                "transforms.names": ("topk",),
                "transforms.compression_topk": 0.25},
    "all-padded": {"schedule.rounds": 4,
                   "schedule.client_join_round": (2,) * 8},
    "pallas": {"execution.kernel_backend": "pallas"},
    "resume": {"schedule.rounds": 4, "schedule.straggler_prob": 0.3,
               "schedule.max_staleness": 2},
}


def _jspec(case: str, mesh=None):
    js = jspec_replace(JSpec.from_dict(_BASE), CASES[case])
    return jspec_replace(js, {"execution.mesh": mesh})


def _tspec(case: str, mesh=None):
    return FederationSpec.from_dict(_jspec(case, mesh).to_dict())


def _ref_params(jf):
    return tp.params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                           jf.params))


def _ints(history):
    return [{k: h[k] for k in INTS} for h in history]


@pytest.fixture(scope="module")
def corpora():
    """Each package's corpus, per client count, built once."""
    out = {}
    for n in (8, 16):
        js = jspec_replace(JSpec.from_dict(_BASE), {"data.num_clients": n})
        out[n] = (jbuild_corpus(js), build_corpus(_tspec("sync") if n == 8
                                                  else _tspec("lk-topk")))
    return out


@pytest.fixture(scope="module")
def runs(corpora):
    """Runs made once: ``runs("ref", case)`` the reference's unsharded vmap
    run, ``runs("ref1", case)`` its one-device mesh run, ``runs(data,
    case)`` the port's (``data`` None: unsharded)."""
    cache = {}

    def get(who, case):
        if (who, case) in cache:
            return cache[who, case]
        n = 16 if case == "lk-topk" else 8
        if who in ("ref", "ref1"):
            f = JFederation.from_spec(
                _jspec(case, {"data": 1} if who == "ref1" else None),
                corpus=corpora[n][0])
        else:
            f = Federation.from_spec(
                _tspec(case, None if who is None else {"data": who}),
                device="cpu", corpus=corpora[n][1])
        f.run()
        cache[who, case] = f
        return f
    return get


# ---------------------------------------------------------------------------
# parity: the sharded port against the reference and its own unsharded run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("data", [2, 4])
def test_sharded_matches_reference_unsharded(runs, regime, data):
    """Every regime at ``data`` CPU shards: within 1e-5 of the reference's
    unsharded vmap run and of the port's unsharded run, the history's
    integers equal."""
    t, j, u = runs(data, regime), runs("ref", regime), runs(None, regime)
    assert t.mesh_shape == {"data": data} and u.mesh_shape is None
    dev_ref = max_param_dev(_ref_params(j), t.params)
    dev_own = max_param_dev(u.params, t.params)
    print(f"{regime} data={data}: vs reference {dev_ref:.3e}, vs port "
          f"unsharded {dev_own:.3e}")
    assert dev_ref <= TOL and dev_own <= TOL
    assert _ints(t.history) == _ints(j.history) == _ints(u.history)
    for a, b in zip(t.history, j.history):
        assert abs(a["loss"] - b["loss"]) <= TOL * max(1.0, abs(b["loss"]))


@pytest.mark.parametrize("regime", ["sync", "topk", "dp-straggler"])
def test_data1_bitwise_unsharded_and_near_reference_mesh(runs, regime):
    """``data=1`` is the sharded code path on one shard: bitwise the
    port's unsharded run (one shard, the same operations in the same
    order), within 1e-5 of the reference's unsharded vmap run, and for
    ``sync`` within 1e-5 of the reference's one-device mesh run (whose
    trace count is not asserted: ROADMAP.md §C)."""
    t, u = runs(1, regime), runs(None, regime)
    assert t.mesh_shape == {"data": 1}
    for k, v in u.params.items():
        assert torch.equal(v, t.params[k]), k
    assert t.history == u.history
    assert max_param_dev(_ref_params(runs("ref", regime)), t.params) <= TOL
    if regime == "sync":
        j = runs("ref1", regime)
        assert j.mesh_shape == {"data": 1}
        assert max_param_dev(_ref_params(j), t.params) <= TOL
        assert _ints(t.history) == _ints(j.history)


@pytest.mark.parametrize("data", [2, 8])
def test_mesh_pallas(runs, corpora, data):
    """``mesh-pallas`` (the kernel cell over the mesh) at 2 and 8 shards
    against the reference's unsharded kernel-backend run."""
    base = FederationSpec.from_dict(_BASE)
    spec = scenario_spec("mesh-pallas", base)
    assert spec.execution.mesh == MeshSpec(data=2)
    spec = spec_replace(spec, {"execution.mesh.data": data})
    t = Federation.from_spec(spec, device="cpu", corpus=corpora[8][1])
    t.run()
    assert t.mesh_shape == {"data": data}
    assert max_param_dev(_ref_params(runs("ref", "pallas")), t.params) <= TOL
    assert _ints(t.history) == _ints(runs("ref", "pallas").history)


@pytest.mark.parametrize("case", ["lk-topk", "all-padded"])
def test_lk_topk_and_all_padded_rounds(runs, case):
    """L=16 clients, K=4 a round, 4 shards: each round's cohort rows meet
    their clients' error-memory rows across the shards (gathered and
    scattered by global id).  And rounds where every client joins late
    (rounds 0-1 all padded), then the whole cohort: both within 1e-5 of
    the reference's unsharded run."""
    t, j = runs(4, case), runs("ref", case)
    assert max_param_dev(_ref_params(j), t.params) <= TOL
    assert _ints(t.history) == _ints(j.history)
    if case == "all-padded":
        assert [h["participants"] for h in t.history] == [0, 0, 8, 8]
    else:
        # the memory holds rows of more clients than one cohort
        mem = torch.cat(t.engine._tstate["topk"])
        assert int((mem.abs().sum(dim=1) > 0).sum()) > 4


# ---------------------------------------------------------------------------
# resume and snapshots
# ---------------------------------------------------------------------------
def test_resume_bitwise_under_mesh(runs, corpora):
    """Under ``data=4`` with stragglers: snapshot after 2 of 4 rounds,
    resume in a fresh federation — bitwise the uninterrupted run, history
    equal.  The snapshot is the reference's unsharded form, so it also
    continues an unsharded port run bitwise and the reference's
    ``Federation`` within 1e-5."""
    spec = _tspec("resume", {"data": 4})
    a = Federation.from_spec(spec, device="cpu", corpus=corpora[8][1])
    a.run(rounds=2)
    snap = a.state_dict()
    assert a.engine._ring is not None and isinstance(
        a.engine._ring["delta"], list)
    a.run()
    b = Federation.from_spec(spec, device="cpu", corpus=corpora[8][1])
    b.load_state_dict(snap)
    b.run()
    assert max_param_dev(a.params, b.params) == 0.0
    assert a.history == b.history
    want = runs(None, "resume")
    u = Federation.from_spec(_tspec("resume"), device="cpu",
                             corpus=corpora[8][1])
    u.engine.load_state_dict(snap["engine"])
    u.run()
    assert max_param_dev(u.params, want.params) <= TOL
    assert _ints(u.history) == _ints(want.history)
    j = JFederation.from_spec(_jspec("resume"), corpus=corpora[8][0])
    j.load_state_dict({"engine": snap["engine"]})
    j.run()
    assert max_param_dev(_ref_params(j), a.params) <= TOL
    assert _ints(j.history) == _ints(a.history)


def test_topk_snapshot_round_trips_under_mesh(runs):
    """The row-sharded top-k memory goes out whole in global row order and
    comes back into the shards."""
    t = runs(4, "topk")
    snap = t.engine.state_dict()
    before = torch.cat(t.engine._tstate["topk"]).clone()
    assert before.abs().max() > 0
    for s in t.engine._tstate["topk"]:
        s.zero_()
    t.engine.load_state_dict(snap)
    assert torch.equal(torch.cat(t.engine._tstate["topk"]), before)


# ---------------------------------------------------------------------------
# the ops over a mesh: bitwise where the reference proves bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("data", [2, 4, 8])
def test_mask_cancellation_bitwise_through_sharded_sum(data):
    """The dyadic-grid argument across shards: each shard's partial sum of
    the pairwise masks is an exact grid integer, so the port's ``psum``
    is exact and the masks cancel to exactly 0.0."""
    layout = flat_layout({"w": torch.zeros((13, 7)),
                          "b": torch.zeros((11,))})
    mesh = fed_mesh(data, "cpu")
    for num_clients in (data, 2 * data, 3 * data):
        stack = pairwise_mask_stack(0, layout, num_clients, "cpu")
        assert stack.abs().max() > 0
        total = ops.fed_weighted_sum(stack, torch.ones(num_clients),
                                     mesh=mesh)
        assert float(total.abs().max()) == 0.0, (num_clients, data)


@pytest.mark.parametrize("data", [2, 4])
def test_dp_secure_apply_per_shard_is_bitwise(data):
    """B3's mesh path is strictly per row: its shards, merged, are the
    unsharded call's rows bit for bit (dp and secure operand sets)."""
    rng = np.random.default_rng(0)
    k, d = 8, 37
    x, noise, masks = (torch.from_numpy(rng.standard_normal((k, d))
                                        .astype(np.float32))
                       for _ in range(3))
    coef = torch.from_numpy(rng.random(k).astype(np.float32))
    w = torch.from_numpy(rng.integers(0, 40, k).astype(np.float32))
    mesh = fed_mesh(data, "cpu")
    for kw in ({"noise": noise, "clip_coef": coef, "noise_scale": 0.015},
               {"masks": masks, "weights": w}):
        want = ops.fed_dp_secure_apply(x, **kw)
        got = ops.fed_dp_secure_apply(x, mesh=mesh, **kw)
        assert len(got) == data
        assert torch.equal(mesh.merge(got), want)


def test_topk_ef_gathers_error_rows_across_shards():
    """B4 over a mesh with the cohort's error rows in other shards: the
    merged result is the unsharded call's, bit for bit."""
    rng = np.random.default_rng(1)
    msgs = torch.from_numpy(rng.standard_normal((4, 20)).astype(np.float32))
    err = torch.from_numpy(rng.standard_normal((8, 20)).astype(np.float32))
    ids = torch.tensor([7, 0, 5, 2], dtype=torch.int32)
    segs = [(0, 12), (12, 8)]
    want = ops.fed_topk_ef(msgs, err, ids, frac=0.25, segments=segs)
    mesh = fed_mesh(2, "cpu")
    got = ops.fed_topk_ef(msgs, err, ids, frac=0.25, segments=segs,
                          mesh=mesh)
    for g, w in zip(got, want):
        assert torch.equal(mesh.merge(g), w)


# ---------------------------------------------------------------------------
# refusals, with the reference's classes and messages
# ---------------------------------------------------------------------------
def test_divisibility_refused_at_spec_construction():
    for ov in ({"data.num_clients": 5},
               {"schedule.clients_per_round": 3},
               {"data.num_clients": 5, "execution.exec_mode": "loop"}):
        ov = {**ov, "execution.mesh": {"data": 2}}
        with pytest.raises(ValueError,
                           match="never silently repartitioned") as te:
            spec_replace(FederationSpec.from_dict(_BASE), ov)
        with pytest.raises(ValueError) as je:
            jspec_replace(JSpec.from_dict(_BASE), ov)
        assert str(te.value) == str(je.value)


def test_runtime_shard_multiple_refusal():
    rng = np.random.default_rng(0)
    datas = [{"bow": torch.from_numpy(rng.random((6, 8), dtype=np.float32))}
             for _ in range(3)]
    with pytest.raises(ValueError, match="pad_cohorts"):
        stacked_round_batches(datas, [6, 6, 6], torch.tensor([0, 0]),
                              [0, 1, 2], batch_size=2, shard_multiple=2)
    stacked, _ = stacked_round_batches(datas, [6, 6, 6],
                                       torch.tensor([0, 0]), [0, 1, 2],
                                       batch_size=2, pad_to=4,
                                       shard_multiple=2)
    assert stacked["bow"].shape[0] == 4


def test_too_few_cuda_devices_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError,
                       match="data=2 needs 2 devices but only 1 are visible"):
        fed_mesh(2, "cuda")
    with pytest.raises(ValueError, match="data >= 1"):
        fed_mesh(0, "cpu")


def test_buffered_async_mesh_refused_as_reference():
    ov = {"schedule.mode": "buffered_async", "execution.mesh": {"data": 2}}
    with pytest.raises(ValueError, match="drop the mesh") as te:
        spec_replace(FederationSpec.from_dict(_BASE), {
            **ov, "execution.exec_mode": "loop"})
    with pytest.raises(ValueError) as je:
        jspec_replace(JSpec.from_dict(_BASE), {
            **ov, "execution.exec_mode": "loop"})
    assert str(te.value) == str(je.value)


def test_mesh_inert_under_loop_mode(corpora):
    fed = Federation.from_spec(
        spec_replace(_tspec("sync", {"data": 8}),
                     {"execution.exec_mode": "loop"}),
        device="cpu", corpus=corpora[8][1])
    fed.run(rounds=1)
    assert fed.mesh_shape is None and fed.engine._mesh is None


# ---------------------------------------------------------------------------
# spec, registry, CLI
# ---------------------------------------------------------------------------
def test_mesh_spec_roundtrip_round_config_and_overrides():
    s = spec_replace(FederationSpec.from_dict(_BASE),
                     {"execution.mesh": "data=4"})
    assert s.execution.mesh == MeshSpec(data=4)
    assert FederationSpec.from_json(s.to_json()) == s
    assert s.to_round_config().mesh_data == 4
    assert FederationSpec().to_round_config().mesh_data == 0
    js = jspec_replace(JSpec.from_dict(_BASE), {"execution.mesh": "data=4"})
    assert s.to_dict() == js.to_dict()
    for ov in ({"execution.mesh.data": 2},
               {"execution.mesh": None, "execution.mesh.data": 8},
               {"execution.mesh": {"data": 2}}):
        got = spec_replace(s, ov)
        assert got.to_dict() == jspec_replace(js, ov).to_dict()
    assert spec_replace(FederationSpec.from_dict(_BASE), {
        "execution.mesh.data": 2}).execution.mesh == MeshSpec(data=2)
    with pytest.raises(ValueError, match="unknown key 'model'"):
        spec_replace(s, {"execution.mesh.model": 2})
    with pytest.raises(ValueError, match="'data=N'"):
        MeshSpec.from_value("model=2")
    with pytest.raises(ValueError, match="unknown key"):
        MeshSpec.from_value({"data": 2, "model": 2})


@pytest.mark.parametrize("name", ["mesh-sync", "mesh-straggler",
                                  "mesh-topk", "mesh-pallas"])
def test_mesh_registry_entries_equal_the_reference(name):
    for base in (_BASE, {}):
        jbase = JSpec.from_dict(base)
        got = scenario_spec(name, FederationSpec.from_dict(jbase.to_dict()))
        assert got.to_dict() == jscenario(name, jbase).to_dict()
    assert BENCH_SCENARIOS == tuple(JBENCH)
