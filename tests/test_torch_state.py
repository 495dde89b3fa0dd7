"""The straggler ring of the batched path, snapshots, checkpoints and
resume, against the JAX package.

* The ring (the reference's fused ``ring_deliver``/``fused_stale``/
  ``deliver_only``): ``straggler_ring``, ``straggler-heavy`` and
  ``dp-straggler`` under ``exec_mode="vmap"`` from the seed track the
  reference's vmap runs within 1e-5 every round with the records'
  integers equal, equal the port's loop runs (the host pending list),
  call B2 at most twice a round, deliver on empty cohorts, and fill to
  their capacity ``K * max_staleness`` and no further.
* Resume: a snapshot taken mid-run continues bitwise in a fresh
  ``Federation`` or service built from the same spec; a reference
  snapshot continues in the port within 1e-5, and the reverse.
* npz checkpoints load bitwise across packages; the format and spec
  refusals raise the reference's messages; ``--checkpoint`` and
  ``--checkpoint-dir`` write what the reference's flags write; every
  ``examples/specs/*.json`` round-trips in both packages and runs.
"""
import glob
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.api import Federation as JFederation
from repro.api import FederationSpec as JSpec
from repro.api import spec_replace as jspec_replace
from repro.api.registry import scenario_spec as jscenario
from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.launch import federate_serve as jfederate_serve
from repro.serve import FederationService as JService
from repro_torch.api import (Federation, FederationSpec, max_param_dev,
                             spec_replace)
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.ntm import prodlda as tp
from repro_torch.kernels import ops
from repro_torch.launch import federate_serve
from repro_torch.serve import FederationService

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

TOL = 1e-5
ROUNDS = 8
INTS = ("round", "participants", "arrived", "superseded", "in_flight")
_SMALL = {"model": {"vocab": 64, "topics": 4, "hidden": 16},
          "data": {"num_clients": 3, "docs_per_node": 40,
                   "val_docs_per_node": 8},
          "schedule": {"rounds": ROUNDS},
          "execution": {"batch_size": 64, "learning_rate": 2e-4,
                        "exec_mode": "vmap"}}
RING_CELLS = ["straggler_ring", "straggler-heavy", "dp-straggler"]
SPEC_FILES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "examples", "specs", "*.json")))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_params(jf):
    return tp.params_from_reference(_np(jf.params))


def _ints(history):
    return [{k: h[k] for k in INTS} for h in history]


def _jspec(name, overrides=None):
    js = jscenario(name, JSpec.from_dict(_SMALL))
    return jspec_replace(js, overrides) if overrides else js


def _tspec(js):
    return FederationSpec.from_dict(js.to_dict())


# ---------------------------------------------------------------------------
# the straggler ring
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ring_runs():
    """Each cell from the seed in the reference (vmap), the port (vmap)
    and the port's loop, round by round, counting B2 calls a round."""
    out = {}
    for name in RING_CELLS:
        js = _jspec(name)
        jf = JFederation.from_spec(js)
        tf = Federation.from_spec(_tspec(js), device="cpu")
        loop = Federation.from_spec(spec_replace(
            _tspec(js), {"execution.exec_mode": "loop"}), device="cpu")
        devs, loop_devs, recs, calls = [], [], [], []
        real = ops.fed_weighted_sum
        for _ in range(ROUNDS):
            seen = []

            def counted(x, c, _seen=seen, **kw):
                _seen.append(tuple(x.shape))
                return real(x, c, **kw)
            ops.fed_weighted_sum = counted
            try:
                b = tf.step()
            finally:
                ops.fed_weighted_sum = real
            a, c = jf.step(), loop.step()
            recs.append((a, b, c))
            calls.append(seen)
            devs.append(max_param_dev(_ref_params(jf), tf.params))
            loop_devs.append(max_param_dev(loop.params, tf.params))
        out[name] = dict(jf=jf, tf=tf, devs=devs, loop_devs=loop_devs,
                         recs=recs, calls=calls)
    return out


@pytest.mark.parametrize("name", RING_CELLS)
def test_ring_tracks_reference_under_vmap(ring_runs, name):
    r = ring_runs[name]
    print(f"{name}: max_param_dev per round "
          + ", ".join(f"{d:.2e}" for d in r["devs"]))
    assert r["tf"].engine.exec_mode == "vmap"
    assert max(r["devs"]) <= TOL
    for a, b, _ in r["recs"]:
        assert {k: a[k] for k in INTS} == {k: b[k] for k in INTS}
        assert abs(a["loss"] - b["loss"]) <= TOL * abs(a["loss"])
        assert (a["rel_change"] > 0) == (b["rel_change"] > 0)
    # the cells exercise the ring: slots wait, deliver and supersede
    recs = [b for _, b, _ in r["recs"]]
    assert any(h["in_flight"] for h in recs)
    assert any(h["arrived"] > h["participants"] - h["in_flight"]
               for h in recs[1:]) or any(h["superseded"] for h in recs)
    ring = r["tf"].engine._ring
    jring = r["jf"].engine._ring
    for k in ("weight", "client", "due", "age"):
        assert np.array_equal(ring[k], np.asarray(jring[k]))


@pytest.mark.parametrize("name", RING_CELLS)
def test_ring_equals_the_ports_loop(ring_runs, name):
    r = ring_runs[name]
    print(f"{name}: port vmap vs loop "
          + ", ".join(f"{d:.2e}" for d in r["loop_devs"]))
    assert max(r["loop_devs"]) <= TOL
    assert _ints([b for _, b, _ in r["recs"]]) == \
        _ints([c for _, _, c in r["recs"]])


@pytest.mark.parametrize("name", RING_CELLS)
def test_ring_b2_calls_a_round(ring_runs, name):
    """At most two B2 calls a round, each over a whole slab: the ring's
    ``(C, D)`` when a slot delivers, the fresh ``(K, D)`` when a fresh
    row arrives.  With K = L a due slot is superseded whenever its
    client sends afresh, so the ring delivers only for a client that
    straggles again (``straggler-heavy``, p = 0.6, does)."""
    r = ring_runs[name]
    eng = r["tf"].engine
    d = eng.layout[-1][2] + eng.layout[-1][3]
    c = len(eng._ring["weight"])
    assert c == 3 * 3
    for seen, (_, b, _) in zip(r["calls"], r["recs"]):
        assert len(seen) <= 2 and len(set(seen)) == len(seen)
        assert set(seen) <= {(c, d), (3, d)}
        assert bool(seen) == bool(b["arrived"])
    if name == "straggler-heavy":
        assert any(len(s) == 2 for s in r["calls"])


@pytest.mark.parametrize("pad", [True, False])
def test_ring_delivers_on_empty_cohorts(pad):
    """Every client leaves after round 2: the later rounds' cohorts are
    empty, and the ring still delivers (``deliver_only``, or the
    all-padded round under ``pad_cohorts``)."""
    js = _jspec("straggler-heavy", {
        "schedule.client_leave_round": (2, 2, 2),
        "execution.pad_cohorts": pad})
    jf = JFederation.from_spec(js)
    tf = Federation.from_spec(_tspec(js), device="cpu")
    for _ in range(6):
        a, b = jf.step(), tf.step()
        assert {k: a[k] for k in INTS} == {k: b[k] for k in INTS}
        assert max_param_dev(_ref_params(jf), tf.params) <= TOL
    late = tf.history[2:]
    assert all(h["participants"] == 0 for h in late)
    assert sum(h["arrived"] for h in late) > 0
    assert late[-1]["in_flight"] == 0


def test_ring_capacity_at_its_edge():
    """``max_staleness=1`` and every client a straggler: the ring of
    ``C = K`` slots is full after every round and never overflows; one
    more straggler than free slots raises."""
    js = _jspec("straggler", {"schedule.straggler_prob": 1.0,
                              "schedule.max_staleness": 1})
    jf = JFederation.from_spec(js)
    tf = Federation.from_spec(_tspec(js), device="cpu")
    for _ in range(4):
        a, b = jf.step(), tf.step()
        assert {k: a[k] for k in INTS} == {k: b[k] for k in INTS}
        assert b["in_flight"] == len(tf.engine._ring["weight"]) == 3
    assert max_param_dev(_ref_params(jf), tf.params) <= TOL
    eng = tf.engine
    msgs = torch.zeros((4, eng.layout[-1][2] + eng.layout[-1][3]))
    with pytest.raises(RuntimeError, match="overflow"):
        eng._ring_insert(9, msgs, np.ones(4, np.float32),
                         np.ones(4, np.int32), np.arange(4))


# ---------------------------------------------------------------------------
# snapshots and resume
# ---------------------------------------------------------------------------
_RESUME = {"schedule.straggler_prob": 0.4, "schedule.max_staleness": 3,
           "transforms.names": ("topk",), "transforms.compression_topk": 0.25,
           "server_opt.name": "fedavgm"}


def _resume_spec(mode):
    return jspec_replace(JSpec.from_dict(_SMALL),
                         {**_RESUME, "execution.exec_mode": mode})


@pytest.mark.parametrize("mode", ["vmap", "loop"])
def test_resume_bitwise_in_package(mode, tmp_path):
    """A straggler + top-k + server-momentum run, snapshotted after three
    rounds through ``save_state``, continues bitwise in a fresh
    ``Federation``."""
    spec = _tspec(_resume_spec(mode))
    a = Federation.from_spec(spec, device="cpu")
    a.run(rounds=3)
    path = a.save_state(str(tmp_path / "snap.pkl"))
    a.run(rounds=4)
    b = Federation.from_spec(spec, device="cpu")
    b.load_state(path)
    b.run(rounds=4)
    assert a.history == b.history
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    assert torch.equal(a.engine._tstate["topk"], b.engine._tstate["topk"])
    for k, v in a.engine.server_state["m"].items():
        assert torch.equal(v, b.engine.server_state["m"][k])
    if mode == "vmap":
        assert torch.equal(a.engine._ring["delta"], b.engine._ring["delta"])
    else:
        assert [p.client for p in a.engine.pending] == \
            [p.client for p in b.engine.pending]


@pytest.mark.parametrize("mode", ["vmap", "loop"])
def test_snapshots_cross_packages(mode):
    """A reference snapshot continues in the port within 1e-5, and a
    port snapshot in the reference; the snapshot holds numpy leaves and
    primitives only, in the reference's tree form."""
    js = _resume_spec(mode)
    spec = _tspec(js)
    jf = JFederation.from_spec(js)
    jf.run(rounds=3)
    jsnap = pickle.loads(pickle.dumps(jf.state_dict()))
    jf.run(rounds=4)
    tf = Federation.from_spec(spec, device="cpu")
    tf.load_state_dict(jsnap)
    tf.run(rounds=4)
    dev = max_param_dev(_ref_params(jf), tf.params)
    print(f"[{mode}] reference snapshot continued by the port: {dev:.2e}")
    assert dev <= TOL and _ints(tf.history) == _ints(jf.history)

    tsnap = tf.state_dict()

    def leaves_ok(x):
        if isinstance(x, dict):
            return all(leaves_ok(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return all(leaves_ok(v) for v in x)
        return x is None or isinstance(x, (np.ndarray, int, float, str,
                                           bool, np.generic))
    assert leaves_ok(tsnap)
    assert set(tsnap["engine"]) == set(jsnap["engine"])
    assert jax.tree_util.tree_structure(tsnap["engine"]["params"]) == \
        jax.tree_util.tree_structure(jsnap["engine"]["params"])
    back = JFederation.from_spec(js)
    back.load_state_dict(pickle.loads(pickle.dumps(tsnap)))
    back.run(rounds=2)
    tf.run(rounds=2)
    dev = max_param_dev(_ref_params(back), tf.params)
    print(f"[{mode}] port snapshot continued by the reference: {dev:.2e}")
    assert dev <= TOL and _ints(back.history) == _ints(tf.history)


def _service_spec(overrides):
    return jspec_replace(
        jscenario("buffered_async", JSpec.from_dict(
            {**_SMALL, "schedule": {"rounds": 3, "mode": "buffered_async"},
             "execution": {"batch_size": 64, "learning_rate": 2e-4}})),
        overrides)


@pytest.mark.parametrize("transform", ["topk", "dp"])
def test_service_resume_bitwise_and_across_packages(tmp_path, transform):
    """Bitwise in-package with either upload transform (the port's
    snapshot also carries the uploads' top-k error memory); across
    packages with dp, whose draws are pure functions of the upload
    counter (the reference's service snapshot has no error memory, so a
    top-k service of the reference resumes with an empty one)."""
    spec = _service_spec(
        {"transforms.names": ("topk",), "transforms.compression_topk": 0.25}
        if transform == "topk" else
        {"transforms.names": ("dp",), "transforms.dp_noise_multiplier": 0.3,
         "transforms.dp_clip_norm": 0.05})
    first, then = [0, 1, 2, 1, 0, 2, 2], [1, 0, 2, 0, 1, 1, 2, 0]
    a = FederationService.from_spec(_tspec(spec), device="cpu")
    for c in first:
        a.upload(c)
    path = a.save_state(str(tmp_path / "svc.pkl"))
    snap = a.state_dict()
    for c in then:
        a.upload(c)
    b = FederationService.from_spec(_tspec(spec), device="cpu")
    b.load_state(path)
    for c in then:
        b.upload(c)
    assert a.history == b.history and a.rejections == b.rejections
    for k, v in a._live[1].items():
        assert torch.equal(v, b._live[1][k]), k
    if transform == "topk":
        assert torch.equal(a._fed.engine._tstate["topk"],
                           b._fed.engine._tstate["topk"])
        return
    j = JService.from_spec(spec)
    j.load_state_dict(pickle.loads(pickle.dumps(snap)))
    for c in then:
        j.upload(c)
    assert j.history == a.history
    assert max_param_dev(tp.params_from_reference(_np(j._live[1])),
                         a._live[1]) <= TOL
    # the exported sync snapshot opens in a sync Federation
    fed = Federation.from_spec(_tspec(spec).__class__.from_dict(
        a.export_federation_state()["spec"]), device="cpu")
    fed.load_state_dict(a.export_federation_state())
    assert fed.round_index == a.agg_index


def test_npz_checkpoints_cross_packages(tmp_path):
    js = _resume_spec("vmap")
    jf = JFederation.from_spec(js)
    tf = Federation.from_spec(_tspec(js), device="cpu")
    tree = tf.engine._export(tf.params)
    save_checkpoint(str(tmp_path / "t"), 5, tree)
    got, step = jload_checkpoint(str(tmp_path / "t"), jf.params)
    assert step == 5
    for x, y in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(tree)):
        assert np.array_equal(np.asarray(x).view(np.int32),
                              np.asarray(y).view(np.int32))
    jtree = _np(jax.tree_util.tree_map(lambda p: p * 3.0 + 1.0, jf.params))
    jsave_checkpoint(str(tmp_path / "j"), 7, jtree)
    template = tp.params_to_reference(tf.params)
    template = jax.tree_util.tree_map(torch.from_numpy, template)
    back, step = load_checkpoint(str(tmp_path / "j"), template)
    assert step == 7
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        assert isinstance(x, torch.Tensor)
        assert np.array_equal(x.numpy().view(np.int32), y.view(np.int32))
    with np.load(str(tmp_path / "t" / "ckpt_00000005.npz")) as a, \
            np.load(str(tmp_path / "j" / "ckpt_00000007.npz")) as b:
        assert sorted(a.files) == sorted(b.files)


@pytest.mark.parametrize("which", ["format", "exec_mode", "clients",
                                   "spec", "service_format",
                                   "service_spec"])
def test_refusals_match_reference(which):
    js = _resume_spec("vmap")
    jf = JFederation.from_spec(js)
    tf = Federation.from_spec(_tspec(js), device="cpu")
    jsnap, tsnap = jf.state_dict(), tf.state_dict()
    jtarget, ttarget = jf, tf
    if which == "format":
        jsnap["engine"]["format"] = tsnap["engine"]["format"] = 1
    elif which == "exec_mode":
        jsnap["engine"]["exec_mode"] = tsnap["engine"]["exec_mode"] = "loop"
    elif which == "clients":
        for s in (jsnap, tsnap):
            s["engine"]["client_error_memory"] = [None]
    elif which == "spec":
        for s in (jsnap, tsnap):
            s["spec"] = dict(s["spec"], name="other")
    else:
        sspec = jscenario("buffered_async", JSpec.from_dict(
            {**_SMALL, "schedule": {"rounds": 3, "mode": "buffered_async"},
             "execution": {"batch_size": 64, "learning_rate": 2e-4}}))
        jtarget = JService.from_spec(sspec)
        ttarget = FederationService.from_spec(_tspec(sspec), device="cpu")
        jsnap, tsnap = jtarget.state_dict(), ttarget.state_dict()
        for s in (jsnap, tsnap):
            if which == "service_format":
                s["format"] = 1
            else:
                s["spec"] = dict(s["spec"], name="other")
    if which in ("format", "exec_mode", "clients"):
        jtarget, ttarget = jf.engine, tf.engine
        jsnap, tsnap = jsnap["engine"], tsnap["engine"]
    with pytest.raises(ValueError) as want:
        jtarget.load_state_dict(jsnap)
    with pytest.raises(ValueError) as got:
        ttarget.load_state_dict(tsnap)
    assert str(got.value) == str(want.value)


def test_federate_serve_checkpoint_flag(tmp_path):
    """``--checkpoint`` writes the drained service's model as a sync
    ``Federation`` snapshot, as the reference's flag does: the same keys,
    the same tree, the same model within 1e-5."""
    flags = ["--vocab", "64", "--topics", "4", "--hidden", "16",
             "--num-clients", "3", "--docs-per-node", "20", "--val-docs",
             "4", "--buffer-size", "2", "--sweeps", "2", "--lr", "2e-4"]
    jfederate_serve.main(flags + ["--checkpoint", str(tmp_path / "j.pkl")])
    federate_serve.main(flags + ["--device", "cpu", "--checkpoint",
                                 str(tmp_path / "t.pkl")])
    with open(tmp_path / "j.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "t.pkl", "rb") as f:
        got = pickle.load(f)
    assert set(got) == set(want) and got["spec"] == want["spec"]
    assert set(got["engine"]) == set(want["engine"])
    assert got["engine"]["round"] == want["engine"]["round"]
    dev = max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
              for x, y in zip(jax.tree_util.tree_leaves(
                  got["engine"]["params"]), jax.tree_util.tree_leaves(
                  want["engine"]["params"])))
    assert dev <= TOL


# ---------------------------------------------------------------------------
# the spec files
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", SPEC_FILES,
                         ids=[os.path.basename(p) for p in SPEC_FILES])
def test_spec_files_round_trip_and_run(path):
    import json
    with open(path) as f:
        raw = json.load(f)
    jspec, tspec = JSpec.load(path), FederationSpec.load(path)
    assert tspec.to_dict() == jspec.to_dict()
    assert FederationSpec.from_dict(tspec.to_dict()).to_dict() == \
        tspec.to_dict()

    def within(part, full):
        if isinstance(part, dict):
            return all(within(v, full[k]) for k, v in part.items())
        return part == full
    assert within(raw, tspec.to_dict())      # the file's keys, as written
    fed = Federation.from_spec(tspec, device="cpu")
    fed.run(rounds=3)
    assert fed.round_index == 3
    assert all(np.isfinite(h["loss"]) for h in fed.history)
    assert fed.engine.exec_mode == raw["execution"]["exec_mode"]


def test_example_twins_run_on_the_cpu():
    """``examples/torch_quickstart.py`` (Algorithm 1, DSS/TSS, federated
    == centralized), ``examples/torch_resume_demo.py`` (bitwise resume of
    a straggler + top-k run on the batched path) and, at a reduced size,
    ``examples/torch_privacy_features.py`` (the four clients' pairwise
    masks cancel; every variant trains to a finite loss; secure
    aggregation lands on the baseline's losses)."""
    import importlib.util
    here = os.path.join(os.path.dirname(__file__), "..", "examples")
    out = {}
    for name, argv in (("torch_quickstart", ["--rounds", "20"]),
                       ("torch_resume_demo", []),
                       ("torch_privacy_features", ["--rounds", "2",
                                                   "--docs", "40"])):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(here, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.main(argv + ["--device", "cpu"])
    assert out["torch_quickstart"]["fed_vs_central"] <= TOL
    assert out["torch_resume_demo"]["resume_dev"] == 0.0
    assert any(out["torch_resume_demo"]["in_flight"])
    priv = out["torch_privacy_features"]
    assert priv["mask_sum"] <= 1e-4 < priv["mask_magnitude"]
    assert len(priv["loss"]) == 5
    base = priv["loss"]["baseline SyncOpt (paper)"]
    sec = priv["loss"]["secure aggregation"]
    assert abs(sec[1] - base[1]) <= TOL * abs(base[1])
