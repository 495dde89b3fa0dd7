"""The port's federated LM training (``model.family="lm"``) against the
JAX reference, and the ``vmap`` rules that carry the batched cohort path
through kernels B5 and B6.  This module holds the phi3 E=2 dirichlet
parity case and the spec, corpus, service and ``vmap`` tests; the top-k
and churn cases are in ``test_torch_lm_federation_topk.py``, the SSM and
hybrid families in ``test_torch_lm_federation_ssm.py`` (shared set-up:
``torch_lm_federation_common.py``).

Twins of ``tests/test_federated_lm.py`` on the reduced phi3-mini-3.8b
(attention: B5), mamba2-1.3b (SSM: B6) and hymba-1.5b (both).  Each
parity pair starts from the reference's init (carried through
``transformer.params_from_reference``) and draws whole client corpora
(``batch_size`` >= every client's documents); the port's threefry draws
are the reference's in any case (``tests/test_torch_prng.py``), so the
runs differ only in fp32 summation order.  Bounds:
every parameter within 2e-4 of the reference's after the rounds (the LM
bound of the training slice), each round's loss within 1e-5, and the
port's loop and batched paths within 1e-5 of each other (mamba2 and
hymba are held to the reference on the batched path and through it on
the loop).  The top-k case
is held to the reference's run in the same mode only: the reference's
own loop and vmap top-k runs differ by 3.2e-4 (ROADMAP.md §C), and a
few of its entries flip in or out of the kept set between the frameworks
too (the test says how they are held).  On the CPU the kernels' plain
versions run; the vmap rules and the batching
rules of the backward operators run here as on the card.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.api.federation import Federation as JFederation
from repro.api.federation import build_lm_clients as jbuild_lm_clients
from repro.api.federation import build_lm_corpus as jbuild_lm_corpus
from repro.api.federation import heldout_xent_per_token as jxent
from repro.api.registry import scenario_spec as jscenario
from repro.api.spec import FederationSpec as JSpec
from repro.api.spec import spec_replace as jspec_replace
from repro.serve import FederationService as JService
from repro_torch.api import (Federation, FederationSpec, build_lm_clients,
                             build_lm_corpus, heldout_xent_per_token,
                             max_param_dev, scenario_spec, spec_replace)
from repro_torch.core import prng
from repro_torch.data.lm_data import generate_lm_corpus
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import build_model
from repro_torch.serve import FederationService, run_traffic
from torch_lm_federation_common import (  # noqa: F401
    _BASE, _REF_MODES, _WHOLE, _dev_to_ref, _lm_spec, _specs,
    check_port_loop_equals_port_vmap, check_port_matches_reference, runs)

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))


# ---------------------------------------------------------------------------
# the port against the reference, same exec mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,mode", [
    pytest.param(c, m, id=f"{c}-{m}") for c in ("phi3-epochs-dirichlet",)
    for m in _REF_MODES[c]])
def test_port_matches_reference(runs, case, mode):
    """Every parameter within 2e-4 and every round's loss within 1e-5
    (top-k: as ``check_port_matches_reference`` says)."""
    check_port_matches_reference(runs, case, mode)


@pytest.mark.parametrize("case", ["phi3-epochs-dirichlet"])
def test_port_loop_equals_port_vmap(runs, case):
    """The port's two execution paths agree, delta messages."""
    check_port_loop_equals_port_vmap(runs, case)


def test_ragged_vmap_needs_a_mask_aware_loss():
    """The batched path pads ragged clients: a loss override without its
    ``(sum, count)`` form is refused there, as in the reference."""
    spec = _lm_spec(**{"data.partition": "dirichlet(5.0)",
                       "execution.batch_size": 64,
                       "execution.exec_mode": "vmap"})
    bundle = build_model(spec.to_model_config(), dtype=torch.float32)
    with pytest.raises(ValueError, match="mask-aware"):
        Federation.from_spec(spec, device="cpu", loss_fn=bundle.loss)
    Federation.from_spec(spec, device="cpu", loss_fn=bundle.loss,
                         loss_sum_fn=bundle.loss_sum)


def test_overrides_clients_and_losses_equal_the_defaults():
    """``clients=``, ``loss_fn=``/``loss_sum_fn=`` and ``init_params=``
    reproduce the synthetic wiring when given what it builds."""
    spec = _lm_spec(**{"execution.exec_mode": "vmap", **_WHOLE})
    cfg = spec.to_model_config()
    bundle = build_model(cfg, dtype=torch.float32)
    init = bundle.init(prng.PRNGKey(0))
    clients = build_lm_clients(build_lm_corpus(spec), 3, "topic",
                               device="cpu")
    a = Federation.from_spec(spec, device="cpu", init_params=init)
    b = Federation.from_spec(spec, device="cpu", clients=clients,
                             loss_fn=bundle.loss,
                             loss_sum_fn=bundle.loss_sum, init_params=init)
    a.run()
    b.run()
    assert max_param_dev(a.params, b.params) == 0.0
    with pytest.raises(ValueError, match="injected clients"):
        b.evaluate()


# ---------------------------------------------------------------------------
# the spec surface and the registry
# ---------------------------------------------------------------------------
def test_lm_spec_validation_refusals():
    with pytest.raises(ValueError, match="not a registered architecture"):
        _lm_spec(**{"model.arch": "gpt-unknown"})
    for arch in ("qwen2-vl-7b", "hubert-xlarge", "prodlda-synthetic"):
        with pytest.raises(ValueError, match="has kind"):
            _lm_spec(**{"model.arch": arch})
    with pytest.raises(ValueError, match="LM-only"):
        spec_replace(FederationSpec(), {"model.arch": "phi3-mini-3.8b"})
    with pytest.raises(ValueError, match="NTM-only"):
        _lm_spec(**{"model.topics": 5})
    with pytest.raises(ValueError, match="stochastic_loss"):
        _lm_spec(**{"execution.stochastic_loss": True})
    with pytest.raises(ValueError, match="multiple of 64"):
        _lm_spec(**{"model.width": 100})
    with pytest.raises(ValueError, match=">= 2"):
        _lm_spec(**{"model.seq_len": 1})
    # the two MoE archs, refused until the MoE slice, size their model
    # as the reference's spec does
    for arch in ("llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b"):
        got = _lm_spec(**{"model.arch": arch}).to_model_config()
        want = jspec_replace(jspec_replace(JSpec(), _BASE),
                             {"model.arch": arch}).to_model_config()
        assert got.kind == "moe" and got.num_params() == want.num_params()
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
        assert (got.num_layers, got.d_model, got.vocab_size) \
            == (want.num_layers, want.d_model, want.vocab_size)
    # the NTM family runs the stochastic loss (the train-mode ELBO)
    ntm = spec_replace(FederationSpec(), {"execution.stochastic_loss": True})
    assert ntm.execution.stochastic_loss and ntm.model.family == "ntm"


def test_lm_spec_roundtrips_and_sizes_model():
    spec = _lm_spec(**{"model.layers": 1, "model.width": 64})
    assert FederationSpec.from_dict(spec.to_dict()) == spec
    cfg = spec.to_model_config()
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (1, 64, 128)
    assert cfg.max_seq_len >= spec.resolved_seq_len + 1
    js = JSpec.from_dict(spec.to_dict())
    jcfg = js.to_model_config()
    for f in ("num_layers", "d_model", "d_ff", "num_heads", "num_kv_heads",
              "head_dim", "vocab_size", "max_seq_len", "name", "dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("arch", ["granite-34b", "qwen1.5-110b",
                                  "minicpm3-4b"])
@pytest.mark.parametrize("sizes", [{}, {"model.layers": 1,
                                        "model.width": 128}])
def test_lm_spec_sizes_the_zoo_archs_as_the_reference(arch, sizes):
    """The dense zoo ids the port now has: the spec accepts them and
    sizes their ``reduced()`` config as the reference's
    ``FederationSpec`` does, field for field, and the bundle builds."""
    spec = _lm_spec(**{"model.arch": arch, **sizes})
    assert FederationSpec.from_dict(spec.to_dict()) == spec
    cfg = spec.to_model_config()
    jcfg = JSpec.from_dict(spec.to_dict()).to_model_config()
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(want):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert cfg.num_params() == jcfg.num_params()
    bundle = build_model(cfg)
    assert bundle.cfg is cfg


@pytest.mark.parametrize("name", ["lm_fedavg", "lm_dirichlet_topk"])
def test_registry_lm_entries_equal_the_reference(name):
    assert scenario_spec(name).to_dict() == jscenario(name).to_dict()
    base = {"model.vocab": 64, "data.num_clients": 5}
    got = scenario_spec(name, spec_replace(FederationSpec(), base))
    want = jscenario(name, jspec_replace(JSpec(), base))
    assert got.to_dict() == want.to_dict()


def test_injected_corpus_mismatch_refused():
    corpus = build_lm_corpus(_lm_spec())
    with pytest.raises(ValueError, match="num_clients"):
        Federation.from_spec(_lm_spec(**{"data.num_clients": 5}),
                             device="cpu", corpus=corpus)
    with pytest.raises(ValueError, match=r"\(vocab, seq_len\)"):
        Federation.from_spec(_lm_spec(**{"model.vocab": 256}),
                             device="cpu", corpus=corpus)
    with pytest.raises(ValueError, match="LMCorpus"):
        Federation.from_spec(_lm_spec(), device="cpu", corpus=object())


def test_dirichlet_partition_reshapes_clients():
    """The label-skew re-partition moves documents, every document
    survives it, and each client holds the reference's documents."""
    spec = _lm_spec()
    corpus = build_lm_corpus(spec)
    jcorpus = jbuild_lm_corpus(JSpec.from_dict(spec.to_dict()))
    for a, b in zip(corpus.node_tokens + [corpus.val_tokens],
                    jcorpus.node_tokens + [jcorpus.val_tokens]):
        np.testing.assert_array_equal(a, b)
    natural = build_lm_clients(corpus, 3, "topic", device="cpu")
    skewed = build_lm_clients(corpus, 3, "dirichlet(0.3)", device="cpu",
                              seed=0)
    assert sum(c.num_docs for c in skewed) == \
        sum(c.num_docs for c in natural)
    assert [c.num_docs for c in skewed] != [c.num_docs for c in natural]
    for mine, theirs in zip(skewed, jbuild_lm_clients(jcorpus, 3,
                                                      "dirichlet(0.3)",
                                                      seed=0)):
        assert mine.num_docs == theirs.num_docs
        for key in ("tokens", "labels", "loss_mask"):
            np.testing.assert_array_equal(mine.data[key].numpy(),
                                          np.asarray(theirs.data[key]))
        assert mine.data["tokens"].dtype == torch.int32


def test_registry_lm_scenarios_train_and_evaluate():
    tiny = {"model.vocab": 128, "model.seq_len": 16,
            "data.num_clients": 3, "data.docs_per_node": 24,
            "data.val_docs_per_node": 8, "schedule.rounds": 3}
    for name in ("lm_fedavg", "lm_dirichlet_topk"):
        fed = Federation.from_spec(spec_replace(scenario_spec(name), tiny),
                                   device="cpu")
        fed.run()
        losses = [h["loss"] for h in fed.history]
        assert np.isfinite(losses).all()
        assert min(losses[1:]) < losses[0]
        m = fed.evaluate()
        assert set(m) == {"heldout_xent_per_token", "heldout_perplexity"}
        assert np.isfinite(m["heldout_xent_per_token"])
        assert m["heldout_perplexity"] == pytest.approx(
            np.exp(m["heldout_xent_per_token"]))


def test_ssm_family_federates_on_vmap():
    spec = dataclasses.replace(
        _lm_spec(**{"model.arch": "mamba2-1.3b",
                    "execution.exec_mode": "vmap"}), name="fed-mamba2")
    fed = Federation.from_spec(spec, device="cpu")
    fed.run()
    assert np.isfinite([h["loss"] for h in fed.history]).all()
    assert fed.params["layers"][0]["mixer"]["A_log"].shape == (
        fed.model_cfg.ssm.expand * fed.model_cfg.d_model
        // fed.model_cfg.ssm.head_dim,)


def test_corpus_windows_are_non_iid():
    c = generate_lm_corpus(vocab_size=128, num_nodes=4, docs_per_node=16,
                           seq_len=16, seed=0)
    mins = [t.min() for t in c.node_tokens]
    assert mins == sorted(mins) and mins[0] < mins[-1]


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mamba2-1.3b",
                                  "hymba-1.5b"])
def test_heldout_xent_matches_reference(arch):
    """From the same weights: within 1e-5 in fp32 activations; in the
    spec's bf16 activations (what ``evaluate`` runs) within 1e-3, since
    the two frameworks round bf16 at different points (1.8e-4 measured
    at most)."""
    spec = _lm_spec(**{"model.arch": arch})
    jf = JFederation.from_spec(JSpec.from_dict(spec.to_dict()))
    jp = jax.tree_util.tree_map(np.asarray, jf.engine.params)
    cfg = spec.to_model_config()
    tp = tfm.params_from_reference(jp, cfg)
    val = jf.corpus.val_tokens
    for dtype, bound in (("float32", 1e-5), ("bfloat16", 1e-3)):
        want = jxent(jp, dataclasses.replace(jf.model_cfg, dtype=dtype),
                     val)
        got = heldout_xent_per_token(tp, dataclasses.replace(cfg,
                                                             dtype=dtype),
                                     torch.from_numpy(val), batch=7)
        print(f"{arch} {dtype}: {got} vs {want}")
        assert abs(got - want) <= bound


# ---------------------------------------------------------------------------
# the buffered-async service with an LM
# ---------------------------------------------------------------------------
def _async_overrides():
    return {"schedule.mode": "buffered_async",
            "schedule.max_staleness": 0, "schedule.rounds": 3,
            "execution.exec_mode": "loop", **_WHOLE}


def test_lm_service_generates_like_the_reference():
    """Three uploads (one aggregation at M = K = 3), then greedy tokens
    from the live model: equal to the reference service's, from the
    same init; ``infer`` refused with the reference's message."""
    js, ts = _specs(_async_overrides())
    jsvc = JService.from_spec(js)
    init = tfm.params_from_reference(
        jax.tree_util.tree_map(np.asarray, jsvc._live[1]),
        jsvc._fed.model_cfg)
    tsvc = FederationService.from_spec(ts, device="cpu", init_params=init)
    for c in range(3):
        assert jsvc.upload(c)["accepted"] and tsvc.upload(c)["accepted"]
    assert tsvc.version == jsvc.version == 1
    assert _dev_to_ref(jsvc._live[1], tsvc._live[1]) <= 2e-4
    prompts = np.random.default_rng(0).integers(0, 128, (2, 8)) \
        .astype(np.int32)
    out = tsvc.generate(prompts, max_new=4)
    assert out.shape == (2, 4) and out.dtype == np.int32
    np.testing.assert_array_equal(out, jsvc.generate(prompts, max_new=4))
    np.testing.assert_array_equal(out, tsvc.generate(prompts, max_new=4))
    with pytest.raises(ValueError, match="generate"):
        tsvc.infer(np.zeros((1, 128), np.float32))


def test_lm_service_traffic_calls_generate():
    svc = FederationService.from_spec(
        spec_replace(_lm_spec(), _async_overrides()), device="cpu")
    calls = []
    real = svc.generate
    svc.generate = lambda p, max_new: calls.append(p.shape) or real(
        p, max_new=max_new)
    out = run_traffic(svc, sweeps=2, infer_every=2, infer_batch=3,
                      max_new=2)
    assert out["aggregations"] == 2 and out["infer_calls"] == 3
    assert calls == [(3, 8)] * 3
    assert np.isfinite(out["infer_latency_p50_s"])
    m = svc.evaluate()
    assert np.isfinite(m["heldout_xent_per_token"])


# ---------------------------------------------------------------------------
# the vmap rules of B5 and B6 and of their backward operators
# ---------------------------------------------------------------------------
def _counting(monkeypatch, name):
    calls = []
    real = getattr(ref, name)

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(ref, name, counted)
    return calls


def test_vmap_grad_through_flash_attention(monkeypatch):
    """``vmap(grad)`` through ``ops.flash_attention`` with an unbatched
    ``v`` equals a loop of per-client ``torch.func.grad`` within 1e-6;
    the forward and the backward each run once for the whole cohort
    (clients folded into the batch axis)."""
    g = np.random.default_rng(0)
    kc, b, s, h, hkv, d = 3, 2, 24, 4, 2, 32

    def t(*shape):
        return torch.tensor(g.standard_normal(shape), dtype=torch.float32)
    q, k, v, w = t(kc, b, s, h, d), t(kc, b, s, hkv, d), t(b, s, hkv, d), \
        t(kc, b, s, h, d)

    def f(q, k, v, w):
        return torch.sum(ops.flash_attention(q, k, v, causal=True,
                                             window=8) * w)
    fwd = _counting(monkeypatch, "flash_attention_fwd_ref")
    bwd = _counting(monkeypatch, "flash_attention_bwd_ref")
    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)),
                          in_dims=(0, 0, None, 0))(q, k, v, w)
    assert fwd == [(kc * b, s, h, d)] and bwd == [(kc * b, s, h, d)]
    for i in range(kc):
        want = torch.func.grad(f, argnums=(0, 1, 2))(q[i], k[i], v, w[i])
        for a, e in zip(got, want):
            assert float((a[i] - e).abs().max()) <= 1e-6


def test_vmap_grad_through_ssd_scan(monkeypatch):
    """``vmap(grad)`` through ``ops.ssd_scan`` with a batched ``a`` (each
    client's own decay) and an unbatched ``b``, and a cotangent on
    h_last, equals a loop of per-client ``torch.func.grad`` within 1e-6;
    forward and backward run once per client."""
    g = np.random.default_rng(1)
    kc, b, s, h, p, n = 3, 2, 24, 3, 16, 8

    def t(*shape, lo=None, hi=None):
        x = g.standard_normal(shape) if lo is None \
            else g.uniform(lo, hi, shape)
        return torch.tensor(x, dtype=torch.float32)
    x, dt, a = t(kc, b, s, h, p), t(kc, b, s, h, lo=0.01, hi=0.2), \
        t(kc, h, lo=-2.0, hi=-0.5)
    bb, cc = t(b, s, n), t(kc, b, s, n)
    wy, wh = t(kc, b, s, h, p), t(kc, b, h, p, n)

    def f(x, dt, a, b, c, wy, wh):
        y, h_last = ops.ssd_scan(x, dt, a, b, c, chunk=8)
        return torch.sum(y * wy) + torch.sum(h_last * wh)
    bwd = _counting(monkeypatch, "ssd_scan_bwd_ref")
    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2, 3, 4)),
                          in_dims=(0, 0, 0, None, 0, 0, 0))(
        x, dt, a, bb, cc, wy, wh)
    assert bwd == [(b, s, h, p)] * kc
    for i in range(kc):
        want = torch.func.grad(f, argnums=(0, 1, 2, 3, 4))(
            x[i], dt[i], a[i], bb, cc[i], wy[i], wh[i])
        for u, e in zip(got, want):
            assert float((u[i] - e).abs().max()) <= 1e-6


def test_backward_operators_batch_like_a_loop():
    """The batching rules of ``repro_torch::flash_attention_bwd`` and
    ``repro_torch::ssd_scan_bwd``, called under ``torch.func.vmap``
    directly (an unbatched operand included), equal a loop of calls."""
    g = np.random.default_rng(2)

    def t(*shape):
        return torch.tensor(g.standard_normal(shape), dtype=torch.float32)
    kc, b, s, h, hkv, d = 2, 1, 16, 2, 1, 32
    q, k, v, dout = t(kc, b, s, h, d), t(kc, b, s, hkv, d), \
        t(b, s, hkv, d), t(kc, b, s, h, d)
    outs = [ref.flash_attention_fwd_ref(q[i], k[i], v, causal=True,
                                        window=0) for i in range(kc)]
    out = torch.stack([o for o, _ in outs])
    lse = torch.stack([x for _, x in outs])
    op = torch.ops.repro_torch.flash_attention_bwd
    got = torch.func.vmap(lambda *a: op(*a, True, 0, d ** -0.5),
                          in_dims=(0, 0, None, 0, 0, 0))(
        q, k, v, out, lse, dout)
    for i in range(kc):
        want = op(q[i], k[i], v, out[i], lse[i], dout[i], True, 0,
                  d ** -0.5)
        for a, e in zip(got, want):
            assert torch.equal(a[i], e)
    p, n, hs = 16, 8, 2
    x, dy = t(kc, b, s, hs, p), t(kc, b, s, hs, p)
    dt = torch.rand((kc, b, s, hs), generator=torch.Generator()
                    .manual_seed(0)) * 0.1
    a = -torch.rand((hs,), generator=torch.Generator().manual_seed(1))
    bc, cc, dh = t(kc, b, s, n), t(b, s, n), t(kc, b, hs, p, n)
    op = torch.ops.repro_torch.ssd_scan_bwd
    empty = torch.zeros((kc, 0))
    got = torch.func.vmap(lambda *z: op(*z, 8),
                          in_dims=(0, 0, None, 0, None, 0, 0, 0))(
        x, dt, a, bc, cc, dy, empty, dh)
    for i in range(kc):
        want = op(x[i], dt[i], a, bc[i], cc, dy[i], empty[i], dh[i], 8)
        for u, e in zip(got, want):
            assert torch.equal(u[i], e)
