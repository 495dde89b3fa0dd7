"""One cell's traced window read by the program's own spans.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s> \
        [--span-cost <calls>] [--out <file.json>]

Set-up is a benchmark run's (``run.setup``).  The window runs under
``torch.profiler`` as a traced run's does, and the one trace is read twice:
by the benchmark's ``fedbench.trace.Trace`` (the accepted per-layer
metrics' readings, to hold them against a run without program spans) and
by ``fedbench.spans.ProgramTrace``: the readers of ``fedbench.spans``,
device milliseconds a round by the program span that launched them, idle
milliseconds a round by the innermost span around each gap, the longest
gaps, the longest operations launched in each span and outside all, and
the device operations the trace holds under a program span's name.
``--span-cost`` times that many calls of the program's ``trace.span``
with no profiler and under one.  The JSON object is the last line of
standard output.  It runs on the card only; the benchmark's own runs
never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from fedbench import cells, program  # noqa: E402
from fedbench.spans import (OUTSIDE, PREFIX, READERS,  # noqa: E402
                            ProgramTrace, read_trace_counters)
from fedbench.trace import Trace, kernel_families  # noqa: E402
from counts.work import rows as rows_of  # noqa: E402

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def span_cost(calls: int) -> dict:
    """Microseconds a call of ``trace.span`` costs, off and under a
    profiler."""
    from repro_torch import trace

    def loop():
        t = time.perf_counter()
        for _ in range(calls):
            with trace.span(trace.ROUND):
                pass
        return (time.perf_counter() - t) / calls
    off = loop()
    with profile(activities=ACTIVITIES):
        on = loop()
    return {"calls": calls, "off_us": 1e6 * off, "on_us": 1e6 * on}


def top_ops(prog: ProgramTrace, rounds: int, n: int = 8):
    """For each program span (and for none), the longest device operations
    launched inside it: ``[name, device ms a round, count]``, by name."""
    lo, hi = prog.window
    out = {}
    for op in prog.ops:
        key = (prog.owner(op), op[0][:100])
        ms, count = out.get(key, (0.0, 0))
        out[key] = (ms + 1e3 * (min(op[2], hi) - max(op[1], lo)) / rounds,
                    count + 1)
    by = {}
    for (owner, name), (ms, count) in sorted(out.items(),
                                             key=lambda kv: -kv[1][0]):
        if len(by.setdefault(owner, [])) < n:
            by[owner].append([name, ms, count])
    return by


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--span-cost", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    dev = torch.device("cuda")
    run.log(f"card: {run.card_line()}")
    st = run.setup(cell, args.seed, dev)
    calls0, reads0 = program.read_counters(), read_trace_counters()
    with profile(activities=ACTIVITIES) as prof:
        rounds, window_s, _ = run._window(st.fed, args.seconds, dev, True)
    calls1, reads1 = program.read_counters(), read_trace_counters()
    trace = Trace.from_profiler(prof)
    if not trace.ops:
        raise RuntimeError("the profiler recorded no device operation")
    prog = ProgramTrace.from_profiler(prof)
    ctx = SimpleNamespace(
        trace=trace, program=prog,
        rounds=rounds, rows_per_round=rows_of(cell["traffic"]),
        cfg=cell["config"], traffic=cell["traffic"],
        calls={k: calls1[k] - calls0[k] for k in calls0}, peak_bytes=0,
        families=kernel_families(),
        host_reads=None if reads0 is None
        else reads1["host_reads"] - reads0["host_reads"])
    per_round = 1e3 / rounds
    device = prog.device_s()
    total = sum(device.values())
    annotations = [e.name for e in prof.events()
                   if e.name.startswith(PREFIX)
                   and e.device_type != torch.autograd.DeviceType.CPU]
    out = {
        "workload": args.workload, "seed": args.seed, "rounds": rounds,
        "window_s": window_s, "busy_s": trace.busy_s,
        "accepted": run._per_layer(ctx),
        "program": {k: r(ctx) for k, (_, r) in READERS.items()},
        "device_ms_per_round": {k: v * per_round for k, v in sorted(
            device.items(), key=lambda kv: -kv[1])},
        "outside_share": device.get(OUTSIDE, 0.0) / total if total
        else None,
        "idle_ms_per_round": {k: v * per_round for k, v in sorted(
            prog.idle_s().items(), key=lambda kv: -kv[1])},
        "top_ops": top_ops(prog, rounds),
        "idle_gaps": [[k, v] for k, v in prog.idle_gaps()[:20]],
        "round_idle_ms": [1e3 * t for t in prog.round_idle_s()],
        "device_annotations": {
            "events": len(annotations),
            "in_trace_ops": sum(o[0].startswith(PREFIX) for o in trace.ops)},
    }
    if args.span_cost:
        out["span_cost"] = span_cost(args.span_cost)
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
