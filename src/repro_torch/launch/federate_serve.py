"""Buffered-async federation service driver (port of
``repro/launch/federate_serve.py``: the same flags and printout, plus
``--device``).

Compiles the flags into a ``schedule.mode="buffered_async"`` spec,
builds a :class:`repro_torch.serve.FederationService` on the device
(default ``cuda``), drives it with the deterministic schedule of
:func:`repro_torch.serve.run_traffic`, drains the buffer at shutdown and
reports the held-out metrics of the final published model.

Usage:

    # FedBuff M=2 over 5 clients, staleness window 2, polynomial
    # discount, 20% held-back uploads, inference every 3rd step
    PYTHONPATH=src python -m repro_torch.launch.federate_serve \\
        --num-clients 5 --buffer-size 2 --max-staleness 2 \\
        --staleness-policy polynomial --sweeps 6 \\
        --hold-prob 0.2 --infer-every 3 --out experiments/serve.json

    # the registry scenario on the CPU (plain PyTorch path)
    PYTHONPATH=src python -m repro_torch.launch.federate_serve \\
        --scenario buffered_async --sweeps 4 --device cpu

    # top-k compressed uploads (kernel B4 once per upload on the card)
    PYTHONPATH=src python -m repro_torch.launch.federate_serve \\
        --transforms topk --topk 0.25 --sweeps 4

``--transforms``, ``--dp-noise``, ``--dp-clip`` and ``--topk`` are the
flags of ``launch/simulate.py``: each upload goes through the transform
stage (``secure`` is refused by the spec: its masks cancel only in a
fixed cohort's combine).

``--checkpoint`` is accepted and refused: checkpoints come with ROADMAP
item A11.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.api import FederationSpec, scenario_names, scenario_spec
from repro_torch.api.spec import (STALENESS_POLICIES, DataSpec,
                                  ExecutionSpec, ModelSpec, PartitionSpec,
                                  ScheduleSpec, TransformsSpec)
from repro_torch.core.transforms import TRANSFORMS
from repro_torch.serve import FederationService, run_traffic


def spec_from_args(args) -> FederationSpec:
    return FederationSpec(
        name="federate-serve",
        model=ModelSpec(vocab=args.vocab, topics=args.topics,
                        hidden=args.hidden),
        data=DataSpec(num_clients=args.num_clients,
                      docs_per_node=args.docs_per_node,
                      val_docs_per_node=args.val_docs,
                      partition=PartitionSpec.from_value(args.partition)),
        schedule=ScheduleSpec(mode="buffered_async",
                              buffer_size=args.buffer_size,
                              max_staleness=args.max_staleness,
                              staleness_decay=args.staleness_decay,
                              staleness_policy=args.staleness_policy,
                              local_epochs=args.local_epochs),
        transforms=TransformsSpec(
            names=tuple(x.strip() for x in args.transforms.split(",")
                        if x.strip()),
            dp_noise_multiplier=args.dp_noise, dp_clip_norm=args.dp_clip,
            compression_topk=args.topk),
        execution=ExecutionSpec(exec_mode="loop", batch_size=args.batch,
                                learning_rate=args.lr, seed=args.seed))


def run_service(args) -> dict:
    if args.checkpoint:
        raise NotImplementedError(
            "--checkpoint: service checkpoints are not ported to "
            "repro_torch yet (ROADMAP.md A11)")
    spec = scenario_spec(args.scenario) if args.scenario \
        else spec_from_args(args)
    svc = FederationService.from_spec(spec, device=args.device)
    sc = spec.schedule
    print(f"serving buffered-async federation: M={svc.buffer_size}/"
          f"{spec.data.num_clients} clients, "
          f"max_staleness={svc.max_staleness}, "
          f"discount={svc.staleness_policy}"
          f"(decay={sc.staleness_decay}), {args.sweeps} sweeps")
    t0 = time.time()
    stats = run_traffic(svc, sweeps=args.sweeps, order_seed=args.seed,
                        hold_prob=args.hold_prob,
                        duplicate_prob=args.duplicate_prob,
                        infer_every=args.infer_every,
                        infer_batch=args.infer_batch)
    summary = svc.shutdown()            # drain the partial buffer
    wall = time.time() - t0
    result = {"spec": spec.to_dict(), "traffic": stats,
              "shutdown": summary, "wall_seconds": wall,
              "device": str(svc.device), **svc.evaluate()}
    print(f"done in {wall:.1f}s: {stats['aggregations']} aggregations "
          f"-> version {svc.version}, "
          f"{stats['accepted']}/{stats['uploads']} uploads accepted, "
          f"rejections={stats['rejections']}, "
          f"ppl={result['heldout_perplexity']:.1f}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {args.out}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="buffered-async federation service on PyTorch (see "
                    "module docstring)",
        allow_abbrev=False)
    ap.add_argument("--scenario", default="",
                    help="run a named registry scenario with "
                         "schedule.mode='buffered_async' "
                         f"({', '.join(scenario_names())})")
    ap.add_argument("--vocab", type=int, default=400)
    ap.add_argument("--topics", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--num-clients", type=int, default=5)
    ap.add_argument("--docs-per-node", type=int, default=400)
    ap.add_argument("--val-docs", type=int, default=80)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--buffer-size", type=int, default=0,
                    help="M: aggregate whenever M deltas accumulate; "
                         "0 = the cohort width (with --max-staleness 0 "
                         "that is the sync-equivalence anchor regime)")
    ap.add_argument("--max-staleness", type=int, default=2,
                    help="reject deltas whose version lag exceeds this")
    ap.add_argument("--staleness-policy", default="exponential",
                    choices=STALENESS_POLICIES,
                    help="delta discount vs version lag: exponential = "
                         "decay**age, polynomial = 1/sqrt(1+age) "
                         "(FedBuff)")
    ap.add_argument("--staleness-decay", type=float, default=0.5)
    ap.add_argument("--sweeps", type=int, default=4,
                    help="passes over the client population")
    ap.add_argument("--hold-prob", type=float, default=0.2,
                    help="probability an upload is held one sweep "
                         "(arrives genuinely stale)")
    ap.add_argument("--duplicate-prob", type=float, default=0.0,
                    help="probability an accepted delta is resubmitted")
    ap.add_argument("--infer-every", type=int, default=3,
                    help="run one inference batch against the live "
                         "model every N steps; 0 = train-only")
    ap.add_argument("--infer-batch", type=int, default=8)
    ap.add_argument("--partition", default="topic")
    ap.add_argument("--transforms", default="",
                    help="comma list of upload transforms "
                         f"({sorted(TRANSFORMS)}), in order")
    ap.add_argument("--dp-noise", type=float, default=0.0,
                    help="local-DP Gaussian noise multiplier (used by the "
                         "'dp' transform)")
    ap.add_argument("--dp-clip", type=float, default=1.0,
                    help="local-DP clip norm")
    ap.add_argument("--topk", type=float, default=0.0,
                    help="top-k compression fraction (used by the 'topk' "
                         "transform)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="not ported yet (ROADMAP.md A11); refused")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (kernels) or 'cpu' (plain "
                         "PyTorch path)")
    ap.add_argument("--out", default="")
    if argv is None:
        argv = sys.argv[1:]
    return run_service(ap.parse_args(argv))


if __name__ == "__main__":
    main()
