"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds (or finds built) the program's CUDA kernels, makes the
weights and the clients' documents on the card from ``--seed``, builds
the federation through ``repro_torch.api.Federation.from_spec`` and
drives it through its first rounds, which warm every shape the window
uses and are the rounds the reference checks.  The window then runs
``Federation.step()`` until ``--seconds`` have passed, each round ending
in ``torch.cuda.synchronize()``.  With ``--trace 1`` the window runs
under ``torch.profiler`` and the line carries the per-layer metrics read
from ``metrics/``; without, the end-to-end metrics.  After the window the
program's state is freed and the plain reference (``reference/``) runs
the checked rounds again; the numbers compared, each beside its limit,
close standard error and the result line.  The last line of standard
output is one JSON object.  With no CUDA card, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded, the run fails and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Any, Dict, Mapping, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))
if __name__ == "__main__":
    # compiled bytecode of every module the run imports (torch's included),
    # kept in the checkout so that only a checkout's first run compiles it,
    # also where the environment turns bytecode off
    sys.pycache_prefix = str(HERE.parent / ".pycache")
    sys.dont_write_bytecode = False

import torch  # noqa: E402

from counts.peaks import H100_SXM  # noqa: E402
from counts.work import rows as rows_of  # noqa: E402
from fedbench import cells, check, inputs, program  # noqa: E402
from fedbench.trace import STEP, SYNC, WINDOW, Trace, kernel_families  # noqa: E402
from reference import federated  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi not read ({e})"
    return out or "nvidia-smi printed nothing"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _label(name: str, on: bool):
    return torch.profiler.record_function(name) if on \
        else contextlib.nullcontext()


def _window(fed, seconds: float, device, traced: bool):
    """Rounds until ``seconds`` have passed: (rounds, seconds to the end of
    the last round, losses)."""
    rounds, losses = 0, []
    _sync(device)
    t0 = time.perf_counter()
    with _label(WINDOW, traced):
        while True:
            with _label(STEP, traced):
                rec = fed.step()
            with _label(SYNC, traced):
                _sync(device)
            rounds += 1
            losses.append(rec["loss"])
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
    return rounds, elapsed, losses


def _traced_window(fed, seconds, device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for attempt in range(2):
        with profile(activities=acts) as prof:
            out = _window(fed, seconds, device, True)
        trace = Trace.from_profiler(prof)
        if trace.ops or torch.device(device).type != "cuda":
            return out, trace, attempt
        log("the profiler recorded no device operation in the window; "
            "tracing the window once more")
    raise RuntimeError("the profiler recorded no device operation in two "
                       "traced windows")


def _per_layer(ctx) -> Dict[str, Dict[str, Any]]:
    out = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        mod = importlib.import_module(f"metrics.{path.stem}")
        value = mod.read(ctx)
        if value is not None:
            out[path.stem] = {"value": float(value), "unit": mod.UNIT}
    return out


def setup(cell: Mapping[str, Any], seed: int, dev) -> SimpleNamespace:
    """Inputs from the seed, the federation, and its checked rounds driven
    through ``Federation.step``: the program's readings ``prog`` (round
    losses, per-leaf norms of the weights' change after the first round
    and after the last)."""
    cfg, traffic = cell["config"], cell["traffic"]
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 as configured
    torch.backends.cudnn.allow_tf32 = False
    exec_seed = int(seed) % 2 ** 32
    phases = {}
    t = time.perf_counter()
    if on_card:
        from repro_torch.kernels import _build
        _build.build()
        phases["kernel build"] = time.perf_counter() - t
        built = {k: v["seconds"] for k, v in _build.BUILD_LOG.items()}
        log(f"compile: {json.dumps(built) if built else 'none, all cached'}")
    t = time.perf_counter()
    shapes = program.param_shapes(cfg)
    weights = inputs.make_weights(shapes, seed, dev)
    docs = inputs.make_docs(traffic, cfg["vocab_size"], seed, dev)
    _sync(dev)
    phases["weights and documents"] = time.perf_counter() - t
    t = time.perf_counter()
    start = federated.flat_leaves(weights)
    fed = program.build(cfg, traffic, weights, docs, exec_seed, dev)
    del weights
    _sync(dev)
    phases["Federation.from_spec"] = time.perf_counter() - t
    prog = {"losses": []}
    for r in range(traffic["checked_rounds"]):
        t = time.perf_counter()
        prog["losses"].append(fed.step()["loss"])
        _sync(dev)
        phases[f"checked round {r + 1}"] = time.perf_counter() - t
        if r == 0:
            t = time.perf_counter()
            prog["first"] = federated.leaf_norms(
                federated.flat_leaves(fed.params), start)
            phases["norms"] = time.perf_counter() - t
    t = time.perf_counter()
    prog["change"] = federated.leaf_norms(federated.flat_leaves(fed.params),
                                          start)
    del start
    _sync(dev)
    phases["norms"] += time.perf_counter() - t
    return SimpleNamespace(fed=fed, prog=prog, phases=phases, shapes=shapes,
                           docs=docs, exec_seed=exec_seed)


def reference(cell: Mapping[str, Any], seed: int, st: SimpleNamespace,
              dev, **kw) -> Dict[str, Any]:
    """The plain reference's readings of the checked rounds, from the same
    seed's weights (drawn again) and documents."""
    return federated.run_rounds(
        inputs.make_weights(st.shapes, seed, dev), cell["config"],
        cell["traffic"], st.docs, st.exec_seed,
        cell["traffic"]["checked_rounds"], **kw)


def run_cell(cell: Mapping[str, Any], seed: int, seconds: float,
             traced: bool, device="cuda", chips: int = 1) -> Dict[str, Any]:
    """One run of ``cell`` (``cells.cell``'s dict) on ``device``; the result
    line's object."""
    cfg, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    st = setup(cell, seed, dev)
    fed, prog, phases = st.fed, st.prog, st.phases
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    calls0 = program.read_counters()
    setup_s = time.perf_counter() - T_START
    log("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
        + f"; {setup_s:.3f} s from the process's start")
    trace, retried = None, 0
    if traced:
        (rounds, window_s, losses), trace, retried = _traced_window(
            fed, seconds, dev)
    else:
        rounds, window_s, losses = _window(fed, seconds, dev, False)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    calls1 = program.read_counters()
    calls = {k: calls1[k] - calls0[k] for k in calls0}
    rows = rows_of(traffic)
    tokens = rows * traffic["seq_len"]
    log(f"window: {rounds} rounds in {window_s:.4f} s, {tokens} tokens a "
        f"round; calls {json.dumps(calls)}; peak {peak} bytes"
        + (f"; traced again {retried}x" if retried else ""))
    st.fed = fed = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    metrics: Dict[str, Dict[str, Any]] = {}
    if traced:
        ctx = SimpleNamespace(trace=trace if on_card else None,
                              rounds=rounds, rows_per_round=rows, cfg=cfg,
                              traffic=traffic, calls=calls, peak_bytes=peak,
                              families=kernel_families())
        metrics = _per_layer(ctx)
    else:
        metrics["fed_train_tokens_per_s"] = {
            "value": rounds * tokens / window_s, "unit": "tokens/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    t = time.perf_counter()
    ref = reference(cell, seed, st, dev)
    _sync(dev)
    log(f"reference: {traffic['checked_rounds']} rounds in "
        f"{time.perf_counter() - t:.3f} s")
    nums = check.numbers(prog, ref)
    correct, checks = check.judge(nums, cell["limits"])
    log(f"program losses {prog['losses']}, reference {ref['losses']}; "
        f"worst leaves: first {nums['first_delta_leaf']}, change "
        f"{nums['change_leaf']}; left out {nums['left_out']}; readings "
        + ", ".join(f"{k} {nums[k]!r}" for k in check.NUMBERS))
    failed = sum(1 for x in prog["losses"] + losses if not math.isfinite(x))
    device_info: Dict[str, Any] = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(0) if on_card else dev.type,
        "count": chips if on_card else 1, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": bool(correct and failed == 0),
                           "attempted": traffic["checked_rounds"] + rounds,
                           "failed": failed, "metrics": metrics,
                           "device": device_info}
    if traced and trace is not None and on_card:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        out["breakdown"] = trace.breakdown()
    out["checks"] = checks
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < chips:
        log(f"the cell asks for {chips} cards, {torch.cuda.device_count()} "
            "visible")
        return 2
    log(f"card: {card_line()}; peaks held to (H100 SXM data sheet, 700 W): "
        + ", ".join(f"{k} {v:.4g}" for k, v in H100_SXM.items()))
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", chips)
    bad = forbidden_modules()
    if bad:
        log(f"the process holds {bad} after the window: the benchmark "
            "measures the PyTorch port alone")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
