"""The program's own spans in the profiler's trace: the device time each
holds, the idle time inside each round, and the readers of the per-layer
metrics that read them.

The port names the phases of its federated round with ``record_function``
spans (``repro_torch/trace.py``), which land on the profiler's timeline
while it records.  Their names are copied here and frozen, as ``counts/``
copies kernel names.  A device operation belongs to the innermost program
span around its launch: the start of the CUDA API call that launched it
(``cudaLaunchKernel``, ``cuLaunchKernel``, ...), which shares its
correlation id, on whichever thread made it.  Backward kernels are launched by the autograd engine's thread
while the caller waits inside ``repro_torch.grad``, so they belong to it;
the port's own kernels, launched through ``ctypes`` with no PyTorch
operation around them, belong to the span around that call.  Where the
trace holds no such call, the launch is the start of the host operation
that the device operation links to (``linked_correlation_id``).  The
spans' device-side annotations are not operations.  Idle gaps of the
device are named by the innermost span around their middle, the
harness's or the program's.

``READERS`` maps each metric to ``(unit, read)``; ``read(ctx)`` takes the
traced run's ``ctx`` with ``program`` (a :class:`ProgramTrace`, or None)
and ``host_reads`` (the program's counter over the window, or None) and
returns None where the window holds no program span or the span it reads
never ran.  ``perfbench/spans.py`` prints the readings for one cell.
"""
from __future__ import annotations

import importlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from fedbench.trace import LABELS, WINDOW, covered, gaps

PREFIX = "repro_torch."
ROUND = PREFIX + "round"
BATCHES = PREFIX + "batches"
GRAD = PREFIX + "grad"
FORWARD = PREFIX + "forward"
UPDATE = PREFIX + "update"
TRANSFORMS = PREFIX + "transforms"
COMBINE = PREFIX + "combine"
SERVER_STEP = PREFIX + "server_step"
HOST_READ = PREFIX + "host_read"
SPANS = (ROUND, BATCHES, GRAD, FORWARD, UPDATE, TRANSFORMS, COMBINE,
         SERVER_STEP, HOST_READ)
OUTSIDE = "outside the program's spans"
# a CUDA API call on the host (cudaLaunchKernel, cuLaunchKernel, ...)
RUNTIME = re.compile(r"cu(da)?[A-Z]")

Span = Tuple[str, float, float]


def innermost(t: float, spans: Sequence[Span]) -> Optional[str]:
    """The span that holds ``t`` in ``[start, end)`` and started last (the
    shortest of those that started together): on one thread, the innermost.
    A launch made by a span itself, at its start, is its own."""
    best: Optional[Span] = None
    for s in spans:
        if s[1] <= t < s[2] and (best is None or s[1] > best[1] or (
                s[1] == best[1] and s[2] < best[2])):
            best = s
    return best[0] if best else None


class ProgramTrace:
    """The window's program spans ``(name, start, end)``, its device
    operations ``(name, start, end, launch)`` (``launch`` the start of the
    runtime call, or else of the host operation, that launched it; None
    where the trace holds neither), the harness's spans and the window, in
    seconds on the profiler's clock."""

    def __init__(self, spans: Iterable[Span], ops, harness: Iterable[Span]):
        self.harness = [s for s in harness if s[0] in LABELS]
        win = [s for s in self.harness if s[0] == WINDOW]
        if len(win) != 1:
            raise ValueError(f"the trace holds {len(win)} window spans")
        lo, hi = self.window = (win[0][1], win[0][2])
        self.spans = [s for s in spans
                      if s[0].startswith(PREFIX) and s[2] > lo and s[1] < hi]
        self.ops = [o for o in ops if not o[0].startswith(PREFIX)
                    and o[0] not in LABELS and o[2] > lo and o[1] < hi]

    @classmethod
    def from_profiler(cls, prof) -> "ProgramTrace":
        """From the profiler's raw events, which keep each event's
        correlation ids on every torch version, on the clock of
        ``prof.events()``: seconds from the trace's start."""
        res = prof.profiler.kineto_results
        return cls.from_events(res.events(), res.trace_start_ns())

    @classmethod
    def from_events(cls, events, start_ns: int) -> "ProgramTrace":
        """A runtime call and the device operation it launched share a
        correlation id; a host operation is found by its own correlation
        id, which the device operations it launched hold as their link.
        The two number apart, so each has its own table: a runtime call
        made outside every host operation (a ``ctypes`` launch) may carry
        the number of some host operation."""
        from torch.autograd import DeviceType
        calls: Dict[int, float] = {}
        host: Dict[int, float] = {}
        spans, harness, device = [], [], []
        for e in events:
            rec = (e.name(), (e.start_ns() - start_ns) * 1e-9,
                   (e.end_ns() - start_ns) * 1e-9)
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append((rec, e.correlation_id(),
                                   e.linked_correlation_id()))
            elif e.device_type() == DeviceType.CPU:
                if RUNTIME.match(rec[0]):
                    calls.setdefault(e.correlation_id(), rec[1])
                    continue
                host.setdefault(e.correlation_id(), rec[1])
                if rec[0].startswith(PREFIX):
                    spans.append(rec)
                elif rec[0] in LABELS:
                    harness.append(rec)
        ops = [rec + (calls.get(corr, host.get(link) if link else None),)
               for rec, corr, link in device]
        return cls(spans, ops, harness)

    def ran(self, names: Iterable[str]) -> bool:
        names = set(names)
        return any(s[0] in names for s in self.spans)

    def owner(self, op) -> str:
        """The innermost program span around ``op``'s launch."""
        name = None if op[3] is None else innermost(op[3], self.spans)
        return OUTSIDE if name is None else name

    def device_s(self) -> Dict[str, float]:
        """Device seconds in the window by the span that launched them."""
        lo, hi = self.window
        out: Dict[str, float] = {}
        for op in self.ops:
            t = min(op[2], hi) - max(op[1], lo)
            key = self.owner(op)
            out[key] = out.get(key, 0.0) + t
        return out

    def round_idle_s(self) -> List[float]:
        """For each round span in the window, its length less the device
        time it covers, overlaps once."""
        lo, hi = self.window
        iv = [(o[1], o[2]) for o in self.ops]
        out = []
        for name, a, b in self.spans:
            if name == ROUND:
                a, b = max(a, lo), min(b, hi)
                out.append((b - a) - covered(iv, a, b))
        return out

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """The device's idle gaps in the window, longest first, each named
        by the innermost span around its middle."""
        every = self.harness + self.spans
        holes = gaps(((o[1], o[2]) for o in self.ops), *self.window)
        named = [(innermost(0.5 * (a + b), every) or "outside every span",
                  b - a) for a, b in holes]
        return sorted(named, key=lambda kv: -kv[1])

    def idle_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, t in self.idle_gaps():
            out[name] = out.get(name, 0.0) + t
        return out


def read_trace_counters() -> Optional[Dict[str, int]]:
    """The program's tracing counters, or None where it has no
    ``repro_torch.trace``."""
    try:
        mod = importlib.import_module("repro_torch.trace")
    except ModuleNotFoundError:
        return None
    return {"host_reads": int(mod.host_reads)}


def _program(ctx) -> Optional[ProgramTrace]:
    p = getattr(ctx, "program", None)
    if p is None or not p.spans or not ctx.rounds:
        return None
    return p


def _device_ms(ctx, names) -> Optional[float]:
    p = _program(ctx)
    if p is None or not p.ran(names):
        return None
    by = p.device_s()
    return 1e3 * sum(by.get(n, 0.0) for n in names) / ctx.rounds


def engine_idle_ms_per_round(ctx):
    p = _program(ctx)
    if p is None or not p.ran([ROUND]):
        return None
    idle = p.round_idle_s()
    return 1e3 * sum(idle) / len(idle)


def engine_host_reads_per_round(ctx):
    reads = getattr(ctx, "host_reads", None)
    if _program(ctx) is None or reads is None:
        return None
    return reads / ctx.rounds


def forward_ms_per_round(ctx):
    return _device_ms(ctx, [FORWARD])


def backward_ms_per_round(ctx):
    return _device_ms(ctx, [GRAD])


def update_ms_per_round(ctx):
    return _device_ms(ctx, [UPDATE])


def transform_ms_per_round(ctx):
    return _device_ms(ctx, [TRANSFORMS])


def aggregate_ms_per_round(ctx):
    return _device_ms(ctx, [COMBINE, SERVER_STEP])


READERS = {
    "engine_idle_ms_per_round": ("ms", engine_idle_ms_per_round),
    "engine_host_reads_per_round": ("count", engine_host_reads_per_round),
    "forward_ms_per_round": ("ms", forward_ms_per_round),
    "backward_ms_per_round": ("ms", backward_ms_per_round),
    "update_ms_per_round": ("ms", update_ms_per_round),
    "transform_ms_per_round": ("ms", transform_ms_per_round),
    "aggregate_ms_per_round": ("ms", aggregate_ms_per_round),
}
