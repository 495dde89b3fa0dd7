"""The program's spans read from the trace (``fedbench/spans.py``): device
operations given to the span around their launch, on any thread; idle
gaps named by the innermost span; the readers silent where the window
holds no program span or their span never ran; the accepted metrics
reading the same with and without the program's spans and their
device-side annotations; and the program's own spans and counter read
from a real profiled window of a tiny cell."""
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

import run
from fedbench import cells, spans as sp
from fedbench.trace import STEP, SYNC, WINDOW, Trace, kernel_families

HARNESS = [(WINDOW, 0.0, 10.0), (STEP, 0.0, 4.0), (SYNC, 4.0, 5.0),
           (STEP, 5.0, 9.0), (SYNC, 9.0, 10.0)]
PROGRAM = [(sp.ROUND, 0.1, 3.9), (sp.BATCHES, 0.1, 0.5),
           (sp.GRAD, 0.5, 2.5), (sp.FORWARD, 0.6, 1.2),
           (sp.UPDATE, 2.5, 2.8), (sp.TRANSFORMS, 2.8, 3.0),
           (sp.COMBINE, 3.0, 3.2), (sp.SERVER_STEP, 3.2, 3.4),
           (sp.HOST_READ, 3.4, 3.9),
           (sp.ROUND, 5.1, 8.9), (sp.GRAD, 5.2, 8.0),
           (sp.FORWARD, 5.3, 6.0), (sp.COMBINE, 8.0, 8.5)]
# (name, start, end, launch)
OPS = [("gemm_fwd", 0.7, 1.1, 0.65),        # inside forward
       ("gemm_bwd", 1.3, 2.4, 1.25),        # autograd thread, inside grad
       ("add", 2.5, 2.7, 2.55),             # update
       ("key_pass_kernel", 2.8, 3.0, 2.85),  # transforms
       ("weighted_sum_kernel", 3.05, 3.15, 3.0),  # launched by combine itself
       ("mul", 3.25, 3.3, 3.21),            # server step
       ("Memcpy DtoH", 3.6, 3.7, 3.45),     # host read
       ("unlinked", 4.5, 4.6, None),        # no host event linked
       ("gemm_fwd", 5.4, 5.9, 5.35),
       ("gemm_bwd", 6.0, 7.9, 6.1),
       ("weighted_sum_kernel", 8.1, 8.4, 8.05),
       ("index_put", 8.6, 8.7, 8.55)]       # the round's own


def _prog(spans=PROGRAM):
    return sp.ProgramTrace(spans, OPS, HARNESS)


def _ctx(prog, rounds=2, host_reads=4):
    return SimpleNamespace(program=prog, rounds=rounds,
                           host_reads=host_reads)


def test_operations_belong_to_the_span_around_their_launch():
    by = _prog().device_s()
    assert by[sp.FORWARD] == pytest.approx(0.4 + 0.5)
    assert by[sp.GRAD] == pytest.approx(1.1 + 1.9)
    assert by[sp.UPDATE] == pytest.approx(0.2)
    assert by[sp.TRANSFORMS] == pytest.approx(0.2)
    assert by[sp.COMBINE] == pytest.approx(0.1 + 0.3)
    assert by[sp.SERVER_STEP] == pytest.approx(0.05)
    assert by[sp.HOST_READ] == pytest.approx(0.1)
    assert by[sp.ROUND] == pytest.approx(0.1)
    assert by[sp.OUTSIDE] == pytest.approx(0.1)
    assert sum(by.values()) == pytest.approx(
        sum(b - a for _, a, b, _ in OPS))


def test_the_readers_per_round():
    got = {k: r(_ctx(_prog())) for k, (_, r) in sp.READERS.items()}
    assert got["forward_ms_per_round"] == pytest.approx(450.0)
    assert got["backward_ms_per_round"] == pytest.approx(1500.0)
    assert got["update_ms_per_round"] == pytest.approx(100.0)
    assert got["transform_ms_per_round"] == pytest.approx(100.0)
    assert got["aggregate_ms_per_round"] == pytest.approx(225.0)
    assert got["engine_host_reads_per_round"] == 2.0
    # round 1: 3.8 s less 0.4 + 1.1 + 0.2 + 0.2 + 0.1 + 0.05 + 0.1 busy;
    # round 2: 3.8 s less 0.5 + 1.9 + 0.3 + 0.1
    assert got["engine_idle_ms_per_round"] == pytest.approx(
        1e3 * ((3.8 - 2.15) + (3.8 - 2.8)) / 2)


def test_gaps_are_named_by_the_innermost_span():
    got = sorted((name, round(t, 9)) for name, t in _prog().idle_gaps())
    assert got == sorted([
        (sp.BATCHES, 0.7),          # 0-0.7, its middle in the draws
        (sp.GRAD, 0.2), (sp.GRAD, 0.1), (sp.UPDATE, 0.1),
        (sp.COMBINE, 0.05),         # 3.0-3.05: the combine's own start
        (sp.SERVER_STEP, 0.1), (sp.HOST_READ, 0.3),
        (SYNC, 0.8), (STEP, 0.8),   # 4.6-5.4, before the second round
        (sp.FORWARD, 0.1), (sp.COMBINE, 0.2),
        (sp.ROUND, 0.2),            # 8.4-8.6, in no child of the round
        (SYNC, 1.3)])
    assert _prog().idle_s()[sp.GRAD] == pytest.approx(0.3)


def test_every_reader_is_silent_without_program_spans():
    for name, (_, read) in sp.READERS.items():
        assert read(_ctx(_prog([]))) is None, name
        assert read(_ctx(None)) is None, name
        assert read(SimpleNamespace(rounds=2)) is None, name


def test_a_reader_is_silent_where_its_span_never_ran():
    no_topk = [s for s in PROGRAM if s[0] != sp.TRANSFORMS]
    assert sp.transform_ms_per_round(_ctx(_prog(no_topk))) is None
    assert sp.aggregate_ms_per_round(_ctx(_prog(no_topk))) is not None
    assert sp.engine_host_reads_per_round(_ctx(_prog(), host_reads=None)) \
        is None


class _Raw:
    """A raw profiler event (``prof.profiler.kineto_results.events()``),
    its times in nanoseconds from 10 s before the trace's start."""

    def __init__(self, name, start, end, device=DeviceType.CPU, id=0,
                 link=0, annotation=False):
        self._f = dict(name=name, start_ns=int(1e9 * (start + 10)),
                       end_ns=int(1e9 * (end + 10)), device_type=device,
                       correlation_id=id, linked_correlation_id=link,
                       is_user_annotation=annotation)

    def __getattr__(self, key):
        return lambda: self._f[key]


def _raw(program_spans=True):
    """Harness spans, program spans with their device-side annotations,
    host operations on two threads, runtime calls and device kernels."""
    ev = [_Raw(n, a, b, id=i + 1, annotation=True)
          for i, (n, a, b) in enumerate(HARNESS)]
    ev += [_Raw(WINDOW, 0.0, 10.0, DeviceType.CUDA, id=1, link=1,
                annotation=True)]
    if program_spans:
        ev += [_Raw(n, a, b, id=100 + i, annotation=True)
               for i, (n, a, b) in enumerate(PROGRAM)]
        ev += [_Raw(sp.GRAD, 0.65, 2.45, DeviceType.CUDA, id=102, link=102,
                    annotation=True)]
    ev += [_Raw("aten::mm", 0.65, 0.7, id=200),
           # the autograd engine's thread, while the caller is in grad
           _Raw("autograd::engine::evaluate_function: MmBackward0",
                1.2, 2.45, id=201),
           _Raw("aten::mm", 1.25, 1.3, id=202),
           _Raw("cudaLaunchKernel", 1.26, 1.27, id=9, link=202),
           # its runtime call is not in the trace: found through its link
           _Raw("gemm_fwd", 0.7, 1.1, DeviceType.CUDA, id=8, link=200),
           _Raw("gemm_bwd", 1.3, 2.4, DeviceType.CUDA, id=9, link=202),
           # launched by a ctypes call directly under the combine span: no
           # link, and a runtime call whose id is also aten::mm's above
           _Raw("cudaLaunchKernel", 3.0, 3.01, id=200),
           _Raw("weighted_sum_kernel", 3.05, 3.15, DeviceType.CUDA,
                id=200),
           _Raw("unlinked", 4.5, 4.6, DeviceType.CUDA, id=11)]
    return ev


def _profiler(raw):
    """A profiler whose parsed events (``prof.events()``, times in
    microseconds from the trace's start) and raw events agree."""
    def parsed():
        return [SimpleNamespace(
            name=e.name(), id=e.correlation_id(),
            device_type=e.device_type(),
            is_user_annotation=e.is_user_annotation(),
            time_range=SimpleNamespace(start=(e.start_ns() - 10 ** 10) / 1e3,
                                       end=(e.end_ns() - 10 ** 10) / 1e3))
            for e in raw]
    results = SimpleNamespace(events=lambda: raw,
                              trace_start_ns=lambda: 10 ** 10)
    return SimpleNamespace(events=parsed, profiler=SimpleNamespace(
        kineto_results=results))


def test_from_profiler_keeps_program_spans_and_launches():
    prof = _profiler(_raw())
    p = sp.ProgramTrace.from_profiler(prof)
    assert p.window == pytest.approx(Trace.from_profiler(prof).window)
    assert p.window == pytest.approx((0.0, 10.0))
    assert [s[0] for s in p.spans] == [s[0] for s in PROGRAM]
    assert [(o[0], o[3]) for o in p.ops] == pytest.approx(
        [("gemm_fwd", 0.65), ("gemm_bwd", 1.26),
         ("weighted_sum_kernel", 3.0), ("unlinked", None)])
    assert [p.owner(o) for o in p.ops] == [
        sp.FORWARD, sp.GRAD, sp.COMBINE, sp.OUTSIDE]


def test_accepted_metrics_read_the_same_with_program_spans():
    cell = cells.cell("fedlm-hymba-topk-vmap")

    def readings(program_spans):
        trace = Trace.from_profiler(_profiler(_raw(program_spans)))
        assert not any(o[0].startswith(sp.PREFIX) for o in trace.ops)
        ctx = SimpleNamespace(
            trace=trace, rounds=2, rows_per_round=15, cfg=cell["config"],
            traffic=cell["traffic"], peak_bytes=3 * 2 ** 30,
            calls={"fed_weighted_sum": 2, "fed_topk_ef": 2},
            families=kernel_families())
        return trace, run._per_layer(ctx)
    with_spans, without = readings(True), readings(False)
    assert with_spans[0].ops == without[0].ops
    assert with_spans[0].spans == without[0].spans
    assert with_spans[1] == without[1]
    assert set(with_spans[1]) == {
        "mfu_pct", "device_idle_pct", "peak_mem_gib",
        "port_kernel_roofline_pct", "library_ms_per_round",
        "port_calls_per_round"}


def test_the_span_names_are_the_programs_and_the_readers_are_new():
    from repro_torch import trace
    assert sp.SPANS == trace.SPANS
    assert sp.read_trace_counters() == {"host_reads": trace.host_reads}
    units = {k: u for k, (u, _) in sp.READERS.items()}
    assert units == {
        "engine_idle_ms_per_round": "ms",
        "engine_host_reads_per_round": "count",
        "forward_ms_per_round": "ms", "backward_ms_per_round": "ms",
        "update_ms_per_round": "ms", "transform_ms_per_round": "ms",
        "aggregate_ms_per_round": "ms"}
    accepted = {p.stem for p in (run.HERE / "metrics").glob("*.py")}
    assert not set(units) & accepted


@pytest.mark.parametrize("name", ["fedlm-hymba-topk-vmap",
                                  "fedlm-mamba2-fedavg-vmap"])
def test_a_profiled_window_of_a_tiny_cell(name):
    from conftest import tiny_cell
    from torch.profiler import ProfilerActivity, profile
    cell = tiny_cell(name)
    dev = torch.device("cpu")
    st = run.setup(cell, 2 ** 31 + 7, dev)
    reads0 = sp.read_trace_counters()["host_reads"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rounds, _, _ = run._window(st.fed, 0.0, dev, True)
    reads = sp.read_trace_counters()["host_reads"] - reads0
    p = sp.ProgramTrace.from_profiler(prof)
    names = {s[0] for s in p.spans}
    topk = bool(cell["traffic"].get("topk_frac"))
    assert names == set(sp.SPANS) - (set() if topk else {sp.TRANSFORMS})
    assert sum(s[0] == sp.ROUND for s in p.spans) == rounds == 1
    ctx = SimpleNamespace(program=p, rounds=rounds, host_reads=reads)
    assert sp.engine_host_reads_per_round(ctx) == 2.0
    assert p.ops == []
