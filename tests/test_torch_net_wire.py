"""The port's wire end to end, against the reference on the CPU.

A real :class:`BackgroundServer` on a real localhost socket, driven by
the real :class:`ServiceClient`, every replica and service on
``device="cpu"`` (the plain kernel versions), at the reference tests'
sizes (V=64, K=4, hidden 16, 3 clients).  Pins, each within the repo's
1e-5:

* the sync-equivalence anchor over TCP equals the reference's sync twin
  ``Federation.run()`` from the same seed;
* across packages: a reference ``ServiceClient`` against a port server
  and a port ``ServiceClient`` against a reference server, each against
  the in-process runs; ``GET /v1/model`` answers the reference's bytes;
* ``run_traffic`` over the wire equals the reference's in-process run,
  its rejection ledger reason for reason and its traffic stats;
* the refusal contract of ``tests/test_net_wire.py`` (malformed and
  foreign-version frames, unknown routes and methods, drain, fp32-only
  ``/v1/model``), and an upload whose tree is not the parameters' answers
  as the reference's server answers it;
* a bf16 upload lands as the bf16 round trip of the client's delta,
  bitwise; topk and dp uploads over the wire equal the in-process
  service; an LM service generates over the wire what it generates in
  process; the load driver runs on the CPU.
"""
import asyncio
import json
import os
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.api import Federation as JFederation
from repro.api import FederationSpec as JSpec
from repro.api import build_corpus as jbuild_corpus
from repro.net import BackgroundServer as JBackgroundServer
from repro.net import ServiceClient as JServiceClient
from repro.serve import FederationService as JService
from repro.serve import run_traffic as jrun_traffic
from repro.serve import sync_twin_spec as jsync_twin_spec
from repro_torch.api import (FederationSpec, build_corpus, max_param_dev,
                             scenario_spec, spec_replace)
from repro_torch.core.ntm.prodlda import params_from_reference
from repro_torch.launch import federate_load
from repro_torch.net import BackgroundServer, HttpClient, ServiceClient
from repro_torch.net.codec import decode_message, encode_message
from repro_torch.serve import (REJECT_REASONS, FederationService,
                               run_traffic, sync_twin_spec)

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

TOL = 1e-5
_BINARY = "application/x-repro-wire"
_WIRE = {"model": {"vocab": 64, "topics": 4, "hidden": 16},
         "data": {"num_clients": 3, "docs_per_node": 40,
                  "val_docs_per_node": 8},
         "schedule": {"rounds": 3, "mode": "buffered_async"},
         "execution": {"batch_size": 16, "learning_rate": 2e-4,
                       "exec_mode": "loop"},
         "serving": {"host": "127.0.0.1", "port": 0,
                     "wire_precision": "fp32"}}
_ANCHOR = {"schedule.max_staleness": 0}
_TRAFFIC = {"schedule.buffer_size": 2, "schedule.max_staleness": 0,
            "schedule.staleness_policy": "polynomial"}


def _specs(overrides=None):
    """The same spec in both packages (the reference's dict form)."""
    t = FederationSpec.from_dict(_WIRE)
    if overrides:
        t = spec_replace(t, overrides)
    return JSpec.from_dict(t.to_dict()), t


def _ref(tree):
    """A reference parameter tree as the port engine's flat dict."""
    return params_from_reference(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def corpora():
    js, ts = _specs()
    return jbuild_corpus(jsync_twin_spec(js)), build_corpus(
        sync_twin_spec(ts))


@pytest.fixture(scope="module")
def anchor_twin(corpora):
    """The reference's sync twin of the anchor spec, run 3 rounds."""
    js, _ = _specs(_ANCHOR)
    twin = JFederation.from_spec(jsync_twin_spec(js), corpus=corpora[0])
    twin.run()
    return _ref(twin.engine.params)


def _svc(corpus, overrides=None):
    return FederationService.from_spec(_specs(overrides)[1], device="cpu",
                                       corpus=corpus)


def _client(bg, corpus, overrides=None, **kw):
    return ServiceClient(_specs(overrides)[1], bg.host, bg.port,
                         corpus=corpus, device="cpu", **kw)


def _payload_bytes(frame: bytes) -> int:
    """The array bytes of a frame: all but the prefix and the header."""
    return len(frame) - 9 - int.from_bytes(frame[5:9], "big")


def _anchor_uploads(cl):
    for _ in range(3):
        for c in range(3):
            assert cl.upload(c)["accepted"]


# ---------------------------------------------------------------------------
# the anchor, in-package and across packages
# ---------------------------------------------------------------------------
def test_wire_anchor_matches_the_reference_twin(corpora, anchor_twin):
    """M=K, staleness 0, in-order uploads through encode -> TCP ->
    decode reproduce the reference's sync twin from the same seed."""
    svc = _svc(corpora[1], _ANCHOR)
    with BackgroundServer(svc) as bg:
        cl = _client(bg, corpora[1], _ANCHOR)
        _anchor_uploads(cl)
        version, wire_params = cl.fetch_model()
        assert version == 3 and cl.agg_index == 3
        assert cl.rejection_counts == {} and cl.history == svc.history
        assert all(v.device.type == "cpu" for v in wire_params.values())
        cl.close()
    dev = max_param_dev(anchor_twin, wire_params)
    print(f"wire anchor vs the reference twin: {dev:.3e}")
    assert dev <= TOL
    assert max_param_dev(svc._live[1], wire_params) == 0.0


def test_reference_client_against_port_server(corpora, anchor_twin):
    js, _ = _specs(_ANCHOR)
    svc = _svc(corpora[1], _ANCHOR)
    with BackgroundServer(svc) as bg:
        cl = JServiceClient(js, bg.host, bg.port, corpus=corpora[0])
        for _ in range(3):
            for c in range(3):
                assert cl.upload(c)["accepted"]
        version, wire_params = cl.fetch_model()
        assert version == 3 and cl.rejection_counts == {}
        cl.close()
    dev = max_param_dev(anchor_twin, svc._live[1])
    print(f"reference client -> port server vs the twin: {dev:.3e}")
    assert dev <= TOL
    assert max_param_dev(_ref(wire_params), svc._live[1]) == 0.0


def test_port_client_against_reference_server(corpora, anchor_twin):
    js, _ = _specs(_ANCHOR)
    jsvc = JService.from_spec(js, corpus=corpora[0])
    with JBackgroundServer(jsvc) as bg:
        cl = _client(bg, corpora[1], _ANCHOR)
        _anchor_uploads(cl)
        version, wire_params = cl.fetch_model()
        assert version == 3 and cl.rejection_counts == {}
        cl.close()
    dev = max_param_dev(anchor_twin, wire_params)
    print(f"port client -> reference server vs the twin: {dev:.3e}")
    assert dev <= TOL
    assert max_param_dev(_ref(jsvc._live[1]), wire_params) == 0.0


def test_model_frame_is_the_references_bytes(corpora):
    """From the same weights, ``GET /v1/model`` of the two servers
    answers the same bytes: the reference's skeleton (sorted keys, lists)
    and its fp32 payload."""
    js, ts = _specs()
    jsvc = JService.from_spec(js, corpus=corpora[0])
    svc = FederationService.from_spec(ts, device="cpu", corpus=corpora[1],
                                      init_params=_ref(jsvc._live[1]))
    frames = []
    for server, s in ((JBackgroundServer, jsvc), (BackgroundServer, svc)):
        with server(s) as bg:
            http = HttpClient(bg.host, bg.port)
            status, body = http.request("GET", "/v1/model")
            assert status == 200
            frames.append(body)
            http.close()
    assert frames[0] == frames[1]


# ---------------------------------------------------------------------------
# run_traffic over the wire against the reference in process
# ---------------------------------------------------------------------------
def test_run_traffic_over_the_wire_matches_the_reference(corpora):
    """Holds, duplicates, interleaved inference and staleness pressure
    (``max_staleness=0`` under holds: genuine ``stale`` AND
    ``superseded`` rejections), driven through the port's wire and
    through the reference's service in process."""
    js, ts = _specs(_TRAFFIC)
    knobs = dict(sweeps=3, order_seed=7, hold_prob=0.5,
                 duplicate_prob=0.5, infer_every=3, infer_batch=4)
    jsvc = JService.from_spec(js, corpus=corpora[0])
    jstats = jrun_traffic(jsvc, **knobs)
    svc = _svc(corpora[1], _TRAFFIC)
    with BackgroundServer(svc) as bg:
        cl = _client(bg, corpora[1], _TRAFFIC)
        stats = run_traffic(cl, **knobs)
        _, wire_params = cl.fetch_model()
        cl.close()
    assert set(jstats["rejections"]) == {"stale", "superseded"}
    assert stats["rejections"] == jstats["rejections"]
    assert [r["reason"] for r in svc.rejections] == \
        [r["reason"] for r in jsvc.rejections]
    assert svc.rejections == jsvc.rejections
    for k in ("steps", "uploads", "accepted", "held", "duplicates",
              "aggregations", "version", "infer_calls", "mean_staleness",
              "max_staleness_seen"):
        assert stats[k] == jstats[k], k
    assert max_param_dev(svc._live[1], wire_params) == 0.0
    dev = max_param_dev(_ref(jsvc._live[1]), wire_params)
    print(f"run_traffic over the wire vs the reference: {dev:.3e}")
    assert dev <= TOL


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def test_malformed_and_foreign_version_frames(corpora):
    svc = _svc(corpora[1])
    with BackgroundServer(svc) as bg:
        http = HttpClient(bg.host, bg.port)
        status, resp = http.request("POST", "/v1/upload",
                                    b"not a frame at all",
                                    content_type=_BINARY)
        receipt = json.loads(resp)
        assert status == 400 and not receipt["accepted"]
        assert receipt["reason"] == "malformed" and receipt["client"] == -1

        cl = _client(bg, corpora[1])
        _, delta, w = cl.client_update(0)
        good = cl.encode_upload(0, delta, w, base_version=0)
        foreign = good[:4] + bytes([99]) + good[5:]
        status, resp = http.request("POST", "/v1/upload", foreign,
                                    content_type=_BINARY)
        receipt = json.loads(resp)
        assert status == 400 and receipt["reason"] == "wire_version"
        assert receipt["client"] == -1 and "wire version 99" in \
            receipt["error"]

        # a frame with a non-upload kind is malformed ON THIS ROUTE
        status, resp = http.request(
            "POST", "/v1/upload",
            encode_message("status", {"client": 0, "base_version": 0,
                                      "weight": 1.0},
                           tree=decode_message(good)["tree"]),
            content_type=_BINARY)
        assert status == 400 and json.loads(resp)["reason"] == "malformed"

        st = cl.status()
        assert st["rejections"] == {"malformed": 2, "wire_version": 1}
        assert st["rejection_records"] == 3
        cl.close()
        http.close()
    assert all(r["client"] == -1 for r in svc.rejections)
    assert [r["reason"] for r in svc.rejections] == \
        ["malformed", "wire_version", "malformed"]


def _bad_trees(delta):
    """Uploads whose tree is not the parameters': a leaf missing, one
    extra, one mis-shaped, a tuple for the encoder's list."""
    missing = dict(delta)
    del missing["beta"]
    extra = dict(delta, zzz=np.zeros(3, np.float32))
    shaped = dict(delta, beta=np.zeros((3, 64), np.float32))
    tupled = dict(delta, encoder=tuple(delta["encoder"]))
    return {"missing": missing, "extra": extra, "misshaped": shaped,
            "tuple": tupled}


def test_bad_delta_trees_answer_as_the_reference_server(corpora):
    """Each bad tree gets the reference server's answer: a 400 carrying
    only an error (no receipt), no ledger entry, the buffer untouched;
    then a good upload from the same client is accepted by both."""
    js, ts = _specs()
    jsvc = JService.from_spec(js, corpus=corpora[0])
    svc = FederationService.from_spec(ts, device="cpu", corpus=corpora[1])
    _, delta, w = jsvc.client_update(1)
    host_delta = jax.tree_util.tree_map(np.asarray, delta)
    answers = {}
    for name, server, s in (("ref", JBackgroundServer, jsvc),
                            ("port", BackgroundServer, svc)):
        with server(s) as bg:
            http = HttpClient(bg.host, bg.port)
            got = {}
            for case, tree in _bad_trees(host_delta).items():
                frame = encode_message(
                    "upload", {"client": 1, "base_version": 0,
                               "weight": w}, tree=tree)
                status, resp = http.request("POST", "/v1/upload", frame,
                                            content_type=_BINARY)
                got[case] = (status, sorted(json.loads(resp)),
                             list(s.rejections), s.buffer.count)
            frame = encode_message(
                "upload", {"client": 1, "base_version": 0, "weight": w},
                tree=host_delta)
            status, resp = http.request("POST", "/v1/upload", frame,
                                        content_type=_BINARY)
            got["good"] = (status, json.loads(resp)["accepted"],
                           s.buffer.count)
            answers[name] = got
            http.close()
    print(answers["port"])
    assert answers["port"] == answers["ref"]
    assert answers["port"]["misshaped"] == (400, ["error"], [], 0)
    assert answers["port"]["good"] == (200, True, 1)


def test_http_surface_refusals_and_status(corpora):
    svc = _svc(corpora[1])
    with BackgroundServer(svc) as bg:
        http = HttpClient(bg.host, bg.port)
        status, resp = http.request("GET", "/v1/nope")
        assert status == 404
        assert "unknown endpoint" in json.loads(resp)["error"]
        status, _ = http.request("GET", "/v1/upload")
        assert status == 405
        status, _ = http.request("POST", "/v1/infer", b"{}")
        assert status == 400          # missing "bow"
        status, _ = http.request("POST", "/v1/generate",
                                 b'{"prompts": [[1, 2]]}')
        assert status == 400          # an NTM service does not generate
        status, _ = http.request("POST", "/v1/shutdown?drain=maybe")
        assert status == 400
        status, resp = http.request("GET", "/v1/status")
        st = json.loads(resp)
        assert status == 200
        assert st == dict(svc.status(), wire_precision="fp32")
        assert st["rejection_ledger_cap"] >= 1 and st["model_family"] == \
            "ntm"
        assert st["version"] == 0 and st["draining"] is False
        http.close()


def test_model_endpoint_always_serves_fp32(corpora):
    """wire_precision quantizes UPLOADS; the model clients train against
    is always the fp32 snapshot."""
    ov = {"serving.wire_precision": "bf16"}
    svc = _svc(corpora[1], ov)
    with BackgroundServer(svc) as bg:
        http = HttpClient(bg.host, bg.port)
        status, resp = http.request("GET", "/v1/model")
        assert status == 200
        msg = decode_message(resp)
        assert msg["kind"] == "model" and msg["meta"]["version"] == 0
        for leaf in jax.tree_util.tree_leaves(msg["tree"]):
            assert leaf.dtype == np.float32
        cl = _client(bg, corpora[1], ov)
        assert cl.wire_precision == "bf16"
        assert cl.upload(0)["accepted"]
        http.close()
        cl.close()


def test_bf16_upload_lands_as_the_round_trip_bitwise(corpora):
    """The delta the server buffers is bitwise the bf16 round trip of the
    one the client computed, and the frame's payload half the fp32 one."""
    ov = {"serving.wire_precision": "bf16"}
    svc = _svc(corpora[1], ov)
    with BackgroundServer(svc) as bg:
        cl = _client(bg, corpora[1], ov)
        bv, delta, w = cl.client_update(0)
        assert cl.submit(0, delta, w, base_version=bv)["accepted"]
        half = cl.encode_upload(0, delta, w, base_version=bv)
        cl.wire_precision = "fp32"
        full = cl.encode_upload(0, delta, w, base_version=bv)
        cl.close()
    d = sum(v.numel() for v in delta.values())
    assert (_payload_bytes(full), _payload_bytes(half)) == (4 * d, 2 * d)
    slot = svc.buffer.slot_of(0)
    for name, view in svc.buffer.leaves.items():
        want = delta[name].to(torch.bfloat16).to(torch.float32)
        assert torch.equal(view[slot], want), name


def test_draining_receipts_cross_the_wire(corpora):
    ov = {"schedule.buffer_size": 3, "schedule.max_staleness": 1}
    svc = _svc(corpora[1], ov)
    with BackgroundServer(svc) as bg:
        cl = _client(bg, corpora[1], ov)
        assert cl.upload(0)["accepted"]
        svc.shutdown(drain=True)
        r = cl.upload(1)
        assert not r["accepted"] and r["reason"] == "draining"
        assert cl.rejection_counts == {"draining": 1} and cl.draining
        cl.close()
    assert svc.version == 1 and svc.draining


def test_wire_shutdown_drains_and_stops_serving(corpora):
    ov = {"schedule.buffer_size": 3, "schedule.max_staleness": 1}
    svc = _svc(corpora[1], ov)
    bg = BackgroundServer(svc).start()
    cl = _client(bg, corpora[1], ov)
    assert cl.upload(0)["accepted"]
    summary = cl.shutdown(drain=True)
    assert summary["flushed"] == 1
    cl.close()
    bg.stop()
    assert not bg._thread.is_alive()
    assert svc.version == 1 and svc.draining
    fresh = HttpClient(bg.host, bg.port, timeout=5)
    with pytest.raises(OSError):
        fresh.request("GET", "/v1/status")


def test_infer_over_the_wire_matches_in_process(corpora):
    svc = _svc(corpora[1])
    bow = np.random.default_rng(0).poisson(1.0, (4, 64)).astype(np.float32)
    with BackgroundServer(svc) as bg:
        cl = _client(bg, corpora[1])
        theta = cl.infer(bow)
        cl.close()
    assert isinstance(theta, torch.Tensor) and theta.device.type == "cpu"
    torch.testing.assert_close(theta, svc.infer(bow), rtol=0, atol=1e-6)
    np.testing.assert_allclose(theta.sum(1).numpy(), 1.0, atol=1e-5)


def test_service_client_refuses_sync_specs(corpora):
    with pytest.raises(ValueError, match="buffered_async"):
        ServiceClient(sync_twin_spec(_specs()[1]), "127.0.0.1", 1,
                      device="cpu")


# ---------------------------------------------------------------------------
# transforms, bf16, an LM, the load driver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("transforms", [
    {"transforms.names": ("topk",), "transforms.compression_topk": 0.25},
    {"transforms.names": ("dp",), "transforms.dp_noise_multiplier": 0.3,
     "transforms.dp_clip_norm": 0.05}], ids=["topk", "dp"])
def test_transformed_uploads_over_the_wire_match_in_process(corpora,
                                                            transforms):
    """The client's replica runs the transform stage with the service's
    seed schedule (top-k error memory, dp noise), so 2 sweeps over the
    wire equal 2 sweeps in process."""
    ov = dict(transforms, **{"schedule.buffer_size": 2,
                             "schedule.max_staleness": 2})
    local = _svc(corpora[1], ov)
    svc = _svc(corpora[1], ov)
    with BackgroundServer(svc) as bg:
        cl = _client(bg, corpora[1], ov)
        for _ in range(2):
            for c in range(3):
                assert cl.upload(c)["accepted"] == \
                    local.upload(c)["accepted"]
        cl.close()
    assert svc.version == local.version == 3
    assert svc.rejections == local.rejections
    dev = max_param_dev(local._live[1], svc._live[1])
    print(f"{transforms['transforms.names']} over the wire: {dev:.3e}")
    assert dev <= TOL


def test_lm_generate_over_the_wire():
    """Reduced hymba-1.5b (attention and SSD layers) behind the wire:
    one aggregation from wire uploads, then ``/v1/generate`` answers the
    tokens the service generates in process."""
    spec = spec_replace(scenario_spec("lm_fedavg"), {
        "model.arch": "hymba-1.5b", "model.vocab": 128,
        "model.seq_len": 16, "data.num_clients": 2,
        "data.docs_per_node": 8, "data.val_docs_per_node": 4,
        "execution.batch_size": 8, "schedule.mode": "buffered_async",
        "schedule.max_staleness": 0, "execution.exec_mode": "loop",
        "serving.port": 0})
    svc = FederationService.from_spec(spec, device="cpu")
    prompts = np.random.default_rng(0).integers(0, 128, (2, 8)) \
        .astype(np.int32)
    with BackgroundServer(svc) as bg:
        cl = ServiceClient(spec, bg.host, bg.port, device="cpu",
                           corpus=svc._fed.corpus)
        for c in range(2):
            assert cl.upload(c)["accepted"]
        assert cl.version == 1
        tokens = cl.generate(prompts, max_new=4)
        with pytest.raises(Exception, match="NTM surface"):
            cl.infer(np.zeros((1, 128), np.float32))
        cl.close()
    assert tokens.shape == (2, 4) and tokens.dtype == np.int32
    np.testing.assert_array_equal(tokens, svc.generate(prompts, max_new=4))


def test_load_driver_runs_on_the_cpu(tmp_path, capsys):
    """The one test that spawns processes: the anchor cell over a
    server process, then 2 client processes against another."""
    out = tmp_path / "load.json"
    res = federate_load.main([
        "--device", "cpu", "--procs", "2", "--sweeps", "1",
        "--anchor-sweeps", "1", "--num-clients", "4",
        "--docs-per-node", "20", "--infer-every", "2",
        "--out", str(out)])
    anchor, load = res["load_results"]
    assert anchor["final_param_dev"] <= TOL
    assert anchor["accepted"] == anchor["uploads"] == 4
    assert load["uploads"] == 4 and load["device"] == "cpu"
    assert load["aggregations"] >= 1 and load["infer_calls"] == 2
    assert set(load["rejections"]) <= set(REJECT_REASONS)
    assert "upload_p99_s" in load and out.exists()
    assert "[load] 2 procs on cpu" in capsys.readouterr().out


def test_load_driver_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        federate_load.main(["--procs", "1", "--anchor-sweeps", "0"])


@pytest.mark.parametrize("exc", [KeyboardInterrupt, asyncio.CancelledError])
def test_background_server_surfaces_base_exceptions_at_once(monkeypatch,
                                                            exc):
    """A ``BaseException`` raised while the server binds (an interrupt, a
    cancelled start) comes out of ``BackgroundServer.start()`` at once,
    as the reference's does, not after the 60 s wait for the server."""
    from repro_torch.net import server as tserver

    async def interrupted(self):
        raise exc("bind interrupted")
    monkeypatch.setattr(tserver.NetServer, "start", interrupted)
    bg = BackgroundServer(types.SimpleNamespace(
        spec=types.SimpleNamespace(serving=None)))
    t0 = time.perf_counter()
    with pytest.raises(exc, match="bind interrupted"):
        bg.start()
    assert time.perf_counter() - t0 < 2.0
    bg._thread.join(5)
    assert not bg._thread.is_alive()
