"""Multi-process load driver for the federation wire (repro_torch.net).

Port of ``repro/launch/federate_load.py``.  Boots a
:class:`repro_torch.serve.FederationService` behind the asyncio front end
(:func:`repro_torch.net.server.run_server`) in its own process, then
drives it from N client processes, each a
:class:`repro_torch.net.client.ServiceClient` owning a DISJOINT shard of
the client population and replaying the same deterministic
permutation-sweep schedule as ``run_traffic`` (seeded per process, so a
rerun is the same schedule; the interleaving across processes is the
one genuinely concurrent ingredient).  The parent collects per-request
latencies and reduces them to the latency-under-load cell (p50/p95/p99
upload and infer round trips, uploads/s, aggregations/s, the server's
rejection totals).

Processes start with the ``spawn`` method (CUDA cannot fork): each opens
its own CUDA context on ``--device`` (default ``cuda``; the driver raises
on a host without one), so the server and its client processes share
one card, and only host numbers come back through the pipes.

Two regimes:

* ``run_load``: the concurrent measurement.
* ``run_anchor``: the sync-equivalence anchor OVER THE WIRE: M=K,
  staleness 0, in-order sequential uploads from the parent; the final
  ``GET /v1/model`` params must match the sync twin's
  ``Federation.run()`` within 1e-5.

Usage:

    PYTHONPATH=src python -m repro_torch.launch.federate_load \\
        --procs 4 --num-clients 8 --sweeps 2 --buffer-size 2 \\
        --max-staleness 4 --out experiments/load.json

Upload latency is the ``POST /v1/upload`` round trip (encode + socket +
decode + receipt); the local update is left out, as in the reference.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time
from typing import Any, Dict, List

import numpy as np

SERVER_BOOT_TIMEOUT_S = 300
CLIENT_JOIN_TIMEOUT_S = 900


# ---------------------------------------------------------------------------
# subprocess entry points (top-level: spawn pickles them by name)
# ---------------------------------------------------------------------------
def _server_main(spec_dict: Dict[str, Any], device: str, conn) -> None:
    """Server process: build the service from the spec dict on
    ``device`` and serve until a wire-side shutdown; the bound (host,
    port) goes back first."""
    from repro_torch.api.spec import FederationSpec
    from repro_torch.net.server import run_server
    from repro_torch.serve import FederationService

    spec = FederationSpec.from_dict(spec_dict)
    service = FederationService.from_spec(spec, device=device)
    run_server(service, on_bound=lambda h, p: conn.send((h, p)))


def _client_main(spec_dict: Dict[str, Any], device: str, host: str,
                 port: int, client_ids: List[int], sweeps: int, seed: int,
                 infer_every: int, infer_batch: int, conn) -> None:
    """Client process: replay ``sweeps`` permutation passes over its
    shard (the ``run_traffic`` schedule shape), timing each wire call."""
    from repro_torch.api.spec import FederationSpec
    from repro_torch.net.client import ServiceClient

    spec = FederationSpec.from_dict(spec_dict)
    client = ServiceClient(spec, host, port, device=device)
    rng = np.random.default_rng([0xFED10, int(seed)])
    vocab = spec.model.vocab
    lm = spec.model.family == "lm"
    upload_lat: List[float] = []
    infer_lat: List[float] = []
    reasons: Dict[str, int] = {}
    uploads = accepted = step = 0
    try:
        for _sweep in range(int(sweeps)):
            for c in rng.permutation(client_ids):
                step += 1
                bv, delta, w = client.client_update(int(c))
                t0 = time.perf_counter()
                receipt = client.submit(int(c), delta, w, base_version=bv)
                upload_lat.append(time.perf_counter() - t0)
                uploads += 1
                accepted += int(receipt["accepted"])
                if receipt["reason"]:
                    reasons[receipt["reason"]] = \
                        reasons.get(receipt["reason"], 0) + 1
                if infer_every and step % int(infer_every) == 0:
                    t0 = time.perf_counter()
                    if lm:
                        client.generate(
                            rng.integers(0, vocab, (infer_batch, 8))
                            .astype(np.int32), max_new=8)
                    else:
                        client.infer(rng.poisson(1.0, (infer_batch, vocab))
                                     .astype(np.float32)).cpu()
                    infer_lat.append(time.perf_counter() - t0)
        conn.send({"ok": True, "uploads": uploads, "accepted": accepted,
                   "receipt_reasons": reasons, "upload_lat": upload_lat,
                   "infer_lat": infer_lat})
    except Exception as e:              # reported by the parent
        conn.send({"ok": False, "error": f"{type(e).__name__}: {e}"})
        raise
    finally:
        client.close()


# ---------------------------------------------------------------------------
# parent-side drivers
# ---------------------------------------------------------------------------
def _percentiles(lat: List[float], prefix: str) -> Dict[str, float]:
    if not lat:
        return {}
    arr = np.asarray(lat, np.float64)
    return {f"{prefix}_p50_s": float(np.percentile(arr, 50)),
            f"{prefix}_p95_s": float(np.percentile(arr, 95)),
            f"{prefix}_p99_s": float(np.percentile(arr, 99))}


def _await(proc, conn, timeout: float, what: str):
    """The first message ``proc`` sends on ``conn``; raises at once if
    the process exits without one, or after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not conn.poll(0.2):
        if not proc.is_alive():
            raise RuntimeError(f"{what} (pid {proc.pid}) exited with code "
                               f"{proc.exitcode} before it answered")
        if time.monotonic() > deadline:
            raise RuntimeError(f"{what} (pid {proc.pid}) did not answer "
                               f"within {timeout:.0f}s")
    return conn.recv()


def _boot_server(ctx, spec_dict: Dict[str, Any], device: str):
    parent_conn, child_conn = ctx.Pipe()
    proc = ctx.Process(target=_server_main,
                       args=(spec_dict, device, child_conn), daemon=True)
    proc.start()
    try:
        host, port = _await(proc, parent_conn, SERVER_BOOT_TIMEOUT_S,
                            "the wire server")
    except BaseException:
        proc.terminate()
        raise
    return proc, host, port


def _stop(server, host: str, port: int, *, drain: bool) -> Dict[str, Any]:
    """The server's own counters, then a wire shutdown; the server
    process is joined (terminated if it outlives the join)."""
    from repro_torch.net.client import HttpClient
    http = HttpClient(host, port)
    try:
        status = json.loads(http.request_with_retry("GET", "/v1/status")[1])
        http.request_with_retry(
            "POST", f"/v1/shutdown?drain={'true' if drain else 'false'}")
    finally:
        http.close()
        server.join(60)
        if server.is_alive():
            server.terminate()
            server.join(10)
    return status


def run_load(spec, *, procs: int, sweeps: int, infer_every: int = 4,
             infer_batch: int = 8, order_seed: int = 0,
             device=None) -> Dict[str, Any]:
    """The concurrent cell: ``procs`` client processes over a round-robin
    shard of the population, every process on ``device`` (default
    ``cuda``).  Returns the ``wire-load`` stats dict."""
    from repro_torch.api.federation import resolve_device

    if procs < 1:
        raise ValueError(f"procs must be >= 1, got {procs}")
    L = spec.data.num_clients
    if procs > L:
        raise ValueError(f"--procs {procs} exceeds data.num_clients {L}: "
                         "client processes own disjoint id shards")
    dev = str(resolve_device(device))
    ctx = mp.get_context("spawn")       # CUDA cannot fork
    spec_dict = spec.to_dict()
    server, host, port = _boot_server(ctx, spec_dict, dev)
    shards = [list(range(L))[i::procs] for i in range(procs)]
    t0 = time.perf_counter()
    workers = []
    results = []
    try:
        for i, shard in enumerate(shards):
            parent_conn, child_conn = ctx.Pipe()
            p = ctx.Process(target=_client_main,
                            args=(spec_dict, dev, host, port, shard, sweeps,
                                  order_seed * 1000 + i, infer_every,
                                  infer_batch, child_conn),
                            daemon=True)
            p.start()
            workers.append((p, parent_conn))
        for p, conn in workers:
            # the result before the join: a pipe the child still writes
            # to must be drained first
            r = _await(p, conn, CLIENT_JOIN_TIMEOUT_S, "a client process")
            p.join(60)
            if not r.get("ok"):
                raise RuntimeError(f"client process failed: {r.get('error')}")
            results.append(r)
    except BaseException:
        for p, _ in workers:
            p.terminate()
        server.terminate()
        raise
    wall = time.perf_counter() - t0
    # the server's own view, then a wire shutdown
    status = _stop(server, host, port, drain=True)
    upload_lat = [x for r in results for x in r["upload_lat"]]
    infer_lat = [x for r in results for x in r["infer_lat"]]
    uploads = sum(r["uploads"] for r in results)
    cell: Dict[str, Any] = {
        "procs": procs,
        "device": dev,
        "uploads": uploads,
        "accepted": sum(r["accepted"] for r in results),
        "infer_calls": len(infer_lat),
        "aggregations": int(status["aggregations"]),
        "version": int(status["version"]),
        "rejections": dict(status["rejections"]),
        "receipt_reasons": _merge(r["receipt_reasons"] for r in results),
        "wall_s": wall,
        "aggs_per_s": float(status["aggregations"] / wall) if wall else 0.0,
        "uploads_per_s": float(uploads / wall) if wall else 0.0}
    cell.update(_percentiles(upload_lat, "upload"))
    cell.update(_percentiles(infer_lat, "infer"))
    return cell


def _merge(counts) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + int(v)
    return out


def run_anchor(spec, *, sweeps: int, device=None) -> Dict[str, Any]:
    """The anchor cell: M=K / staleness 0 / in-order uploads over the
    wire against the sync twin's ``Federation.run()``:
    ``final_param_dev`` must stay <= 1e-5."""
    from repro_torch.api.federation import (Federation, max_param_dev,
                                            resolve_device)
    from repro_torch.api.spec import spec_replace
    from repro_torch.net.client import ServiceClient
    from repro_torch.serve import sync_twin_spec

    dev = str(resolve_device(device))
    anchor_spec = spec_replace(spec, {"schedule.buffer_size": 0,
                                      "schedule.max_staleness": 0,
                                      "schedule.rounds": int(sweeps)})
    twin = Federation.from_spec(sync_twin_spec(anchor_spec), device=dev)
    twin.run()
    ctx = mp.get_context("spawn")
    server, host, port = _boot_server(ctx, anchor_spec.to_dict(), dev)
    L = anchor_spec.data.num_clients
    upload_lat: List[float] = []
    accepted = 0
    try:
        client = ServiceClient(anchor_spec, host, port, corpus=twin.corpus,
                               device=dev)
        for _sweep in range(int(sweeps)):
            for c in range(L):
                bv, delta, w = client.client_update(c)
                t0 = time.perf_counter()
                receipt = client.submit(c, delta, w, base_version=bv)
                upload_lat.append(time.perf_counter() - t0)
                accepted += int(receipt["accepted"])
        version, wire_params = client.fetch_model()
        client.close()
    except BaseException:
        server.terminate()
        raise
    status = _stop(server, host, port, drain=False)
    cell: Dict[str, Any] = {
        "device": dev,
        "final_param_dev": float(max_param_dev(twin.engine.params,
                                               wire_params)),
        "uploads": sweeps * L,
        "accepted": accepted,
        "aggregations": int(status["aggregations"]),
        "version": int(version),
        "rejections": dict(status["rejections"])}
    cell.update(_percentiles(upload_lat, "upload"))
    return cell


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def spec_from_args(args):
    from repro_torch.api.spec import (DataSpec, ExecutionSpec,
                                      FederationSpec, ModelSpec,
                                      ScheduleSpec, ServingSpec)
    return FederationSpec(
        name="federate-load",
        model=ModelSpec(vocab=args.vocab, topics=args.topics,
                        hidden=args.hidden),
        data=DataSpec(num_clients=args.num_clients,
                      docs_per_node=args.docs_per_node,
                      val_docs_per_node=args.val_docs),
        schedule=ScheduleSpec(mode="buffered_async",
                              buffer_size=args.buffer_size,
                              max_staleness=args.max_staleness,
                              staleness_policy=args.staleness_policy),
        execution=ExecutionSpec(exec_mode="loop", batch_size=args.batch,
                                learning_rate=args.lr, seed=args.seed),
        serving=ServingSpec(host=args.host, port=args.port,
                            wire_precision=args.wire_precision))


def main(argv=None):
    from repro_torch.api.federation import resolve_device
    from repro_torch.api.spec import STALENESS_POLICIES, WIRE_PRECISIONS
    ap = argparse.ArgumentParser(
        description="multi-process load driver for the federation wire "
                    "(module docstring)",
        allow_abbrev=False)
    ap.add_argument("--procs", type=int, default=4,
                    help="client processes")
    ap.add_argument("--sweeps", type=int, default=2,
                    help="passes over each process's client shard")
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--topics", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--num-clients", type=int, default=8)
    ap.add_argument("--docs-per-node", type=int, default=40)
    ap.add_argument("--val-docs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--buffer-size", type=int, default=2)
    ap.add_argument("--max-staleness", type=int, default=4)
    ap.add_argument("--staleness-policy", default="polynomial",
                    choices=STALENESS_POLICIES)
    ap.add_argument("--infer-every", type=int, default=4,
                    help="each process runs one inference batch every N "
                         "steps (0 = train-only)")
    ap.add_argument("--infer-batch", type=int, default=8)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (the driver discovers the bound "
                         "port)")
    ap.add_argument("--wire-precision", default="fp32",
                    choices=WIRE_PRECISIONS)
    ap.add_argument("--anchor-sweeps", type=int, default=3,
                    help="sweeps for the wire-sync-equivalence anchor "
                         "cell (0 = skip it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the server and every client replica "
                         "(default cuda; raises on a host without one)")
    ap.add_argument("--out", default="")
    if argv is None:
        argv = sys.argv[1:]
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    spec = spec_from_args(args)

    cells = []
    if args.anchor_sweeps:
        anchor = run_anchor(spec, sweeps=args.anchor_sweeps, device=device)
        anchor["cell"] = "wire-sync-equivalence"
        cells.append(anchor)
        print(f"[anchor] dev={anchor['final_param_dev']:.3e} "
              f"({anchor['accepted']}/{anchor['uploads']} uploads, "
              f"{anchor['aggregations']} aggregations)")
    load = run_load(spec, procs=args.procs, sweeps=args.sweeps,
                    infer_every=args.infer_every,
                    infer_batch=args.infer_batch, order_seed=args.seed,
                    device=device)
    load["cell"] = "wire-load"
    cells.append(load)
    print(f"[load] {load['procs']} procs on {device}: "
          f"{load['accepted']}/{load['uploads']} uploads accepted, "
          f"{load['aggregations']} aggregations in {load['wall_s']:.1f}s "
          f"({load['aggs_per_s']:.2f}/s), "
          f"upload p50={load.get('upload_p50_s', float('nan')):.4f}s "
          f"p99={load.get('upload_p99_s', float('nan')):.4f}s, "
          f"rejections={load['rejections']}")
    payload = {"setup": {"spec": spec.to_dict(), "procs": args.procs,
                         "sweeps": args.sweeps,
                         "anchor_sweeps": args.anchor_sweeps,
                         "device": device},
               "load_results": cells}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
