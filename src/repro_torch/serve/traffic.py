"""Deterministic traffic driver for a :class:`FederationService`.

Port of ``repro/serve/traffic.py``: the same numpy-seeded schedule
(``default_rng([0x5E12F, order_seed])``) draws the same sequence of
events — client order, held-back deltas, duplicate resubmissions,
inference batches (``infer`` for ProdLDA, ``generate`` for an LM) — so
one ``order_seed`` replays the reference's event sequence exactly.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

__all__ = ["run_traffic"]


def run_traffic(service, *, sweeps: int, order_seed: int = 0,
                hold_prob: float = 0.0, hold_sweeps: int = 1,
                duplicate_prob: float = 0.0, infer_every: int = 0,
                infer_batch: int = 8, max_new: int = 8) -> Dict[str, Any]:
    """Drive ``sweeps`` passes over the client population.

    Per step (one client's turn, in a per-sweep random permutation):
    held deltas whose release step passed submit first (genuinely stale
    if aggregations fired meanwhile); with probability ``hold_prob`` the
    client computes its update now but holds the submit for
    ``hold_sweeps`` sweeps, otherwise it submits at once; with
    probability ``duplicate_prob`` an accepted delta is submitted again;
    every ``infer_every`` steps one inference batch runs against the live
    model (``infer`` for ProdLDA, ``generate`` of ``max_new`` tokens from
    8-token prompts for an LM) and its latency (to the result on the
    host) is recorded.
    """
    rng = np.random.default_rng([0x5E12F, int(order_seed)])
    L = service.spec.data.num_clients
    vocab = service._fed.model_cfg.vocab_size
    lm = service.spec.model.family == "lm"
    held: List[Any] = []          # (release_step, client, bv, delta, w)
    lat: List[float] = []
    stats = {"steps": 0, "uploads": 0, "accepted": 0, "held": 0,
             "duplicates": 0}
    step = 0

    def _submit(client, bv, delta, w):
        stats["uploads"] += 1
        r = service.submit(client, delta, w, base_version=bv)
        stats["accepted"] += int(r["accepted"])
        return r

    for _sweep in range(int(sweeps)):
        for client in rng.permutation(L):
            step += 1
            due = [h for h in held if h[0] <= step]
            held = [h for h in held if h[0] > step]
            for _rel, c, bv, d, w in due:
                _submit(c, bv, d, w)
            bv, delta, w = service.client_update(int(client))
            if rng.random() < hold_prob:
                held.append((step + int(hold_sweeps) * L, int(client),
                             bv, delta, w))
                stats["held"] += 1
            else:
                r = _submit(int(client), bv, delta, w)
                if r["accepted"] and rng.random() < duplicate_prob:
                    stats["duplicates"] += 1
                    _submit(int(client), bv, delta, w)
            if infer_every and step % int(infer_every) == 0:
                t0 = time.perf_counter()
                if lm:
                    service.generate(
                        rng.integers(0, vocab,
                                     (infer_batch, 8)).astype(np.int32),
                        max_new=max_new)
                else:
                    service.infer(rng.poisson(1.0, (infer_batch, vocab))
                                  .astype(np.float32)).cpu()
                lat.append(time.perf_counter() - t0)
    # leftover held deltas submit at the end (most will be stale by now)
    for _rel, c, bv, d, w in held:
        _submit(c, bv, d, w)
    stats["steps"] = step
    hist = service.history
    out: Dict[str, Any] = dict(stats)
    out.update({
        "aggregations": service.agg_index,
        "version": service.version,
        "rejections": dict(service.rejection_counts),
        "mean_staleness": (float(np.mean([h["mean_age"] for h in hist]))
                           if hist else 0.0),
        "max_staleness_seen": (max(h["max_age"] for h in hist)
                               if hist else 0),
        "infer_calls": len(lat)})
    if lat:
        arr = np.asarray(lat)
        unit = infer_batch * max_new if lm else infer_batch
        out["infer_latency_p50_s"] = float(np.percentile(arr, 50))
        out["infer_throughput_per_s"] = float(unit / arr.mean())
    return out
