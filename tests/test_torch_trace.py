"""The port's spans and host-read counter (``repro_torch/trace.py``).

A tiny LM federation runs its rounds under ``torch.profiler`` (CPU
activity) on the batched path and on the host loop, with and without
``topk``: each span the path runs appears, ``repro_torch.forward`` sits
inside ``repro_torch.grad``, every span sits inside exactly one
``repro_torch.round``, ``host_reads`` counts the round's device -> host
reads, and the rounds are bitwise those of the same federation run with
no profiler.  With no profiler, a span is one shared no-op context and
nothing is recorded.
"""
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.api import Federation, scenario_spec, spec_replace

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

TINY = {"model.vocab": 64, "model.seq_len": 8, "model.layers": 1,
        "model.width": 64, "data.num_clients": 3, "data.docs_per_node": 8,
        "data.val_docs_per_node": 4, "execution.batch_size": 4}
ROUNDS = 2
# (scenario, exec mode) -> the spans its round runs, and its reads a round
CASES = {
    ("lm_fedavg", "vmap"): (set(trace.SPANS) - {trace.TRANSFORMS}, 2),
    ("lm_dirichlet_topk", "vmap"): (set(trace.SPANS), 2),
    ("lm_fedavg", "loop"): (set(trace.SPANS) - {trace.TRANSFORMS}, 1),
    ("lm_dirichlet_topk", "loop"): (set(trace.SPANS), 1),
}
IDS = [f"{s}-{m}" for s, m in CASES]


def _fed(scenario, mode):
    spec = spec_replace(scenario_spec(scenario),
                        {**TINY, "execution.exec_mode": mode})
    return Federation.from_spec(spec, device="cpu")


@pytest.fixture(scope="module", params=list(CASES), ids=IDS)
def case(request):
    """One warm round, then ``ROUNDS`` rounds under the profiler; the
    same federation built again runs its rounds with none."""
    scenario, mode = request.param
    fed = _fed(scenario, mode)
    fed.step()
    reads0 = trace.host_reads
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recs = [fed.step() for _ in range(ROUNDS)]
    reads = trace.host_reads - reads0
    spans = _spans(prof)
    plain = _fed(scenario, mode)
    plain_recs = [plain.step() for _ in range(ROUNDS + 1)][1:]
    names, want_reads = CASES[request.param]
    return dict(fed=fed, plain=plain, recs=recs, plain_recs=plain_recs,
                spans=spans, reads=reads, names=names, want_reads=want_reads)


def _spans(prof):
    """The program's spans ``(name, start, end)`` in the profiler's raw
    events (parsing them into ``prof.events()`` costs ~1 s here)."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("repro_torch.")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_each_span_the_path_runs_appears(case):
    assert {s[0] for s in case["spans"]} == case["names"]


def test_forward_sits_inside_grad(case):
    grads = [s for s in case["spans"] if s[0] == trace.GRAD]
    forwards = [s for s in case["spans"] if s[0] == trace.FORWARD]
    assert forwards and len(forwards) == len(grads)
    for f in forwards:
        assert sum(_inside(f, g) for g in grads) == 1


def test_every_span_sits_inside_exactly_one_round(case):
    rounds = [s for s in case["spans"] if s[0] == trace.ROUND]
    assert len(rounds) == ROUNDS
    for s in case["spans"]:
        if s[0] != trace.ROUND:
            assert sum(_inside(s, r) for r in rounds) == 1, s


def test_host_reads_counts_the_rounds_reads(case):
    assert case["reads"] == case["want_reads"] * ROUNDS
    host_reads = [s for s in case["spans"] if s[0] == trace.HOST_READ]
    assert len(host_reads) == case["reads"]


def test_profiled_rounds_are_bitwise_the_plain_ones(case):
    assert case["recs"] == case["plain_recs"]
    a, b = case["fed"].engine.params, case["plain"].engine.params
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_with_no_profiler_a_span_is_one_shared_noop(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span(trace.ROUND) is trace.span(trace.GRAD)
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    with trace.span(trace.ROUND):
        pass
    fed = _fed("lm_fedavg", "loop")
    reads0 = trace.host_reads
    fed.step()
    assert entered == []
    assert trace.host_reads - reads0 == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span(trace.ROUND):
            pass
    assert entered == [trace.ROUND]


def test_spanned_keeps_the_functions_result_and_name():
    def objective(x, *, scale):
        return x * scale
    f = trace.spanned(trace.FORWARD, objective)
    assert f.__name__ == "objective"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert f(torch.tensor(2.0), scale=3.0).item() == 6.0
    assert [s[0] for s in _spans(prof)] == [trace.FORWARD]
