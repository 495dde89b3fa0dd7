"""Reading the profiler's trace of the window.

``torch.profiler`` over the window gives the device's operations (kernels,
copies, sets) with their start and end on the host's timeline, and the
harness's own ``record_function`` spans (the window, each
``Federation.step`` and the synchronize after it).  Busy time is the union
of the device intervals inside the window, so operations that overlap
count once; idle gaps are the holes in that union, each named by the
innermost harness span around it.
"""
from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]

WINDOW = "perfbench.window"
STEP = "Federation.step"
SYNC = "torch.cuda.synchronize"
LABELS = (WINDOW, STEP, SYNC)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, merged, non-empty intervals."""
    out: List[List[float]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def covered(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of ``[lo, hi]`` that the intervals cover, overlaps once."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The holes of the intervals' union inside ``[lo, hi]``."""
    out, t = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def label_at(t: float, spans: Sequence[Tuple[str, float, float]]) -> str:
    """The innermost (shortest) span holding ``t``."""
    best: Optional[Tuple[str, float, float]] = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "outside the harness's spans"


def _word(name: str) -> re.Pattern:
    return re.compile(rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])")


def kernel_families() -> Dict[str, Dict[str, object]]:
    """Family -> {"kernels": names, "round_work": fn} from every file of
    ``counts/`` that names kernels."""
    out: Dict[str, Dict[str, object]] = {}
    folder = Path(__file__).resolve().parents[1] / "counts"
    for path in sorted(folder.glob("*.py")):
        mod = importlib.import_module(f"counts.{path.stem}")
        for family, names in getattr(mod, "KERNELS", {}).items():
            out[family] = {"kernels": tuple(names),
                           "round_work": mod.round_work}
    return out


def family_of(name: str, families: Dict[str, Dict[str, object]]
              ) -> Optional[str]:
    for family, spec in families.items():
        if any(_word(k).search(name) for k in spec["kernels"]):
            return family
    return None


class Trace:
    """The window's device operations and harness spans, in seconds on
    one timeline: ``ops`` are ``(name, start, end)``, ``spans`` the
    harness's ``(label, start, end)``, ``window`` the window's span."""

    def __init__(self, ops, spans):
        self.spans = [s for s in spans if s[0] in LABELS]
        win = [s for s in self.spans if s[0] == WINDOW]
        if len(win) != 1:
            raise ValueError(f"the trace holds {len(win)} window spans")
        self.window = (win[0][1], win[0][2])
        self.ops = [o for o in ops if o[0] not in LABELS
                    and o[2] > self.window[0] and o[1] < self.window[1]]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """Device operations are the trace's events on the device that are
        not annotations of the harness's spans."""
        from torch.autograd import DeviceType
        ops, spans = [], []
        for e in prof.events():
            rec = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    ops.append(rec)
            elif e.name in LABELS:
                spans.append(rec)
        return cls(ops, spans)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return covered(((a, b) for _, a, b in self.ops), *self.window)

    def kernels(self):
        """Operations that are kernels (not copies or sets)."""
        return [o for o in self.ops
                if not o[0].startswith(("Memcpy", "Memset"))]

    def by_name(self) -> List[Tuple[str, float]]:
        tot: Dict[str, float] = {}
        for name, a, b in clip_ops(self.ops, *self.window):
            tot[name] = tot.get(name, 0.0) + (b - a)
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def idle_gaps(self) -> List[Tuple[str, float]]:
        holes = gaps(((a, b) for _, a, b in self.ops), *self.window)
        named = [(label_at(0.5 * (a + b), self.spans), b - a)
                 for a, b in holes]
        return sorted(named, key=lambda kv: -kv[1])

    def breakdown(self, n: int = 10):
        return {"device_ops": [[k[:160], v] for k, v in self.by_name()[:n]],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps()[:n]]}


def clip_ops(ops, lo, hi):
    return [(name, max(a, lo), min(b, hi)) for name, a, b in ops
            if min(b, hi) > max(a, lo)]
