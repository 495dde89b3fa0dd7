"""Multi-round federated simulation from the command line (port of
``repro/launch/simulate.py``: the same flags, spec resolution and JSON
keys, plus ``--device``).

The flags (or a JSON spec file, or a registry scenario name) compile
into a :class:`repro_torch.api.FederationSpec`, and
:class:`repro_torch.api.Federation` runs it on the device (default
``cuda``; a host without a card raises unless ``--device cpu`` is
passed).  The all-defaults invocation is the paper's Algorithm 1: full
participation, one minibatch step per client, the Eq. (2) combine
(kernel B2 on the card) and server SGD, on the host loop.
``--transforms`` runs under both exec modes (kernel B3 for ``dp`` and
``secure``, B4 for ``topk``, once a round), and every registry
``--partition`` runs.  Flags that reach what the port does not run yet
fail with the spec's labelled refusals: ``--mesh`` (ROADMAP.md A17)
and stragglers under ``--exec-mode vmap`` (A10).  ``--stochastic-loss``
trains with the train-mode ELBO on the reference's threefry draws.

Usage:

    # the paper regime on the card
    PYTHONPATH=src python -m repro_torch.launch.simulate --rounds 100

    # a named registry scenario, on the CPU (plain PyTorch path)
    PYTHONPATH=src python -m repro_torch.launch.simulate \\
        --scenario straggler-heavy --rounds 10 --device cpu

    # Algorithm 1 with top-k compressed messages over a Dirichlet split
    PYTHONPATH=src python -m repro_torch.launch.simulate --rounds 5 \\
        --transforms topk --topk 0.25 --partition 'dirichlet(0.3)' \\
        --device cpu

    # compile a flag combination into a reusable spec file
    PYTHONPATH=src python -m repro_torch.launch.simulate \\
        --exec-mode vmap --transforms topk --topk 0.25 \\
        --dump-spec my_scenario.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.api import Federation, FederationSpec, scenario_names, \
    scenario_spec
from repro_torch.api.spec import (DataSpec, ExecutionSpec, ModelSpec,
                                  PartitionSpec, ScheduleSpec,
                                  ServerOptSpec, TransformsSpec,
                                  parse_int_tuple)
from repro_torch.core.aggregation import SERVER_OPTIMIZERS
from repro_torch.core.engine import RoundScheduler
from repro_torch.core.transforms import TRANSFORMS


def _str_tuple(s: str):
    return tuple(x.strip() for x in s.split(",") if x.strip())


def spec_from_args(args) -> FederationSpec:
    """Compile the legacy flag surface into a FederationSpec.

    This is the ONLY semantics the flags have — the spec is what runs —
    so flag-driven and spec-driven invocations can never drift.  Int
    lists parse strictly (:func:`repro_torch.api.spec.parse_int_tuple`):
    ``--hetero-epochs 1,,4`` is an error, never a silent drop.
    """
    return FederationSpec(
        name="simulate",
        model=ModelSpec(vocab=args.vocab, topics=args.topics,
                        hidden=args.hidden),
        data=DataSpec(num_clients=args.num_clients,
                      docs_per_node=args.docs_per_node,
                      val_docs_per_node=args.val_docs,
                      partition=PartitionSpec.from_value(args.partition)),
        schedule=ScheduleSpec(
            rounds=args.rounds,
            clients_per_round=args.clients_per_round,
            sampling=args.sampling,
            local_epochs=args.local_epochs,
            local_epochs_by_client=parse_int_tuple(
                args.hetero_epochs, what="--hetero-epochs", minimum=1),
            client_join_round=parse_int_tuple(
                args.join_rounds, what="--join-rounds"),
            client_leave_round=parse_int_tuple(
                args.leave_rounds, what="--leave-rounds"),
            straggler_prob=args.straggler_prob,
            max_staleness=args.max_staleness,
            staleness_decay=args.staleness_decay),
        transforms=TransformsSpec(names=_str_tuple(args.transforms),
                                  dp_noise_multiplier=args.dp_noise,
                                  dp_clip_norm=args.dp_clip,
                                  compression_topk=args.topk),
        server_opt=ServerOptSpec(name=args.server_opt, lr=args.server_lr,
                                 momentum=args.server_momentum),
        execution=ExecutionSpec(exec_mode=args.exec_mode,
                                batch_size=args.batch,
                                pad_cohorts=not args.no_pad_cohorts,
                                learning_rate=args.lr,
                                rel_tol=args.rel_tol,
                                stochastic_loss=args.stochastic_loss,
                                seed=args.seed,
                                mesh=args.mesh or None))


# flags that control I/O or select the spec source, not the scenario —
# the only ones combinable with --spec / --scenario
_NON_SCENARIO_DESTS = frozenset({"spec", "scenario", "dump_spec", "out",
                                 "device", "help"})


def _present_scenario_flags(parser, argv):
    """Scenario-defining legacy flags PRESENT on the command line.

    Presence-based, not value-vs-default: ``--exec-mode loop`` next to
    a vmap scenario is still an explicit request that would be silently
    dropped, even though ``loop`` is the argparse default."""
    out = []
    for action in parser._actions:
        if action.dest in _NON_SCENARIO_DESTS:
            continue
        for opt in action.option_strings:
            if any(a == opt or a.startswith(opt + "=") for a in argv):
                out.append(opt)
                break
    return out


def resolve_spec(args, parser=None, argv=None) -> FederationSpec:
    """--spec file > --scenario name > legacy flags, mutually checked.

    A spec file / registry scenario IS the complete scenario, so
    combining it with scenario-defining legacy flags is refused — the
    flags would otherwise be silently ignored, and this module's own
    contract is that intent is never silently dropped.
    """
    if args.spec and args.scenario:
        raise ValueError("--spec and --scenario are mutually exclusive: "
                         "a file IS a complete scenario")
    if args.spec or args.scenario:
        bad = _present_scenario_flags(parser, argv) \
            if parser is not None and argv is not None else []
        if bad:
            src = "--spec" if args.spec else "--scenario"
            raise ValueError(
                f"{src} defines the complete scenario, but scenario "
                f"flag(s) {', '.join(sorted(bad))} were also set and "
                "would be silently ignored — drop them, or customize "
                "via a spec file (--dump-spec, then edit / "
                "repro_torch.api.spec_replace)")
        return FederationSpec.load(args.spec) if args.spec \
            else scenario_spec(args.scenario)
    return spec_from_args(args)


def run_simulation(args, parser=None, argv=None) -> dict:
    spec = resolve_spec(args, parser, argv)
    if args.dump_spec:
        spec.save(args.dump_spec)
        print(f"wrote spec {args.dump_spec}")
        if not args.out:
            # compile-only invocation (the README workflow): the spec
            # file is the product — don't train 100 rounds for a JSON.
            # Pass --out as well to dump AND run.
            return {"spec": spec.to_dict(),
                    "dumped_spec": args.dump_spec}

    fed = Federation.from_spec(spec, device=args.device)
    eng, sched = fed.engine, fed.engine.scheduler
    sc, tr = spec.schedule, spec.transforms
    print(f"simulating {sc.rounds} rounds [{eng.exec_mode}, "
          f"{fed.device}]: "
          f"K={sched.clients_per_round}/{spec.data.num_clients} "
          f"({sc.sampling}), E={sc.local_epochs}"
          + (f" hetero={sc.local_epochs_by_client}"
             if sc.local_epochs_by_client else "")
          + f", partition={spec.data.partition.to_string()}, "
          f"server={spec.server_opt.name}(lr={spec.server_opt.lr}), "
          f"stragglers p={sc.straggler_prob} "
          f"max_stale={sc.max_staleness}"
          + (f", transforms={tr.names}" if tr.names else ""))
    t0 = time.time()
    fed.run(verbose=True)
    wall = time.time() - t0

    result = {
        "config": {"vocab": spec.model.vocab, "topics": spec.model.topics,
                   "num_clients": spec.data.num_clients,
                   "exec_mode": eng.exec_mode,
                   "clients_per_round": sched.clients_per_round,
                   "sampling": sc.sampling,
                   "local_epochs": sc.local_epochs,
                   "local_epochs_by_client": list(sc.local_epochs_by_client),
                   "partition": spec.data.partition.to_string(),
                   "transforms": list(tr.names),
                   "client_join_round": list(sc.client_join_round),
                   "client_leave_round": list(sc.client_leave_round),
                   "server_optimizer": spec.server_opt.name,
                   "server_lr": spec.server_opt.lr,
                   "straggler_prob": sc.straggler_prob,
                   "max_staleness": sc.max_staleness,
                   "staleness_decay": sc.staleness_decay,
                   "seed": spec.execution.seed},
        "spec": spec.to_dict(),
        "rounds_run": len(fed.history),
        "wall_seconds": wall,
        "final_loss": fed.history[-1]["loss"],
        **fed.evaluate(),
        "history": list(fed.history),
    }
    print(f"done in {wall:.1f}s: ppl={result['heldout_perplexity']:.1f} "
          f"npmi={result['npmi_coherence']:.3f} tss={result['tss']:.2f}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {args.out}")
    return result


def main(argv=None):
    # allow_abbrev=False: prefix forms ('--round 5') would bypass the
    # presence-based --spec/--scenario conflict guard below — every flag
    # must be spelled out, so every flag can be accounted for
    ap = argparse.ArgumentParser(
        description="round-based federated simulation (see module "
                    "docstring)",
        allow_abbrev=False)
    ap.add_argument("--spec", default="",
                    help="run a serialized FederationSpec JSON file "
                         "verbatim (combining it with scenario flags is "
                         "an error, never a silent drop; see docs/api.md "
                         "and examples/specs/)")
    ap.add_argument("--scenario", default="",
                    help="run a named registry scenario "
                         f"({', '.join(scenario_names())}); scenario "
                         "flags cannot be combined with it")
    ap.add_argument("--dump-spec", default="",
                    help="write the resolved spec as JSON (compile a "
                         "flag combo into a reusable scenario file) and "
                         "exit without training; add --out to dump AND "
                         "run")
    ap.add_argument("--vocab", type=int, default=400)
    ap.add_argument("--topics", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--num-clients", type=int, default=5)
    ap.add_argument("--docs-per-node", type=int, default=400)
    ap.add_argument("--val-docs", type=int, default=80)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--rel-tol", type=float, default=0.0)
    ap.add_argument("--exec-mode", default="loop", choices=("loop", "vmap"),
                    help="loop = host-side per-client stepping (Alg. 1 "
                         "literal); vmap = all K local updates in one "
                         "batched call, then combine + server step")
    ap.add_argument("--mesh", default="",
                    help="device-mesh axis spec 'data=N': not ported yet "
                         "(ROADMAP.md A17), refused; empty = one device")
    ap.add_argument("--clients-per-round", type=int, default=0,
                    help="K; 0 = all clients (paper Alg. 1)")
    ap.add_argument("--sampling", default="uniform",
                    choices=RoundScheduler.MODES)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--server-opt", default="fedavg",
                    choices=sorted(SERVER_OPTIMIZERS))
    ap.add_argument("--server-lr", type=float, default=1.0)
    ap.add_argument("--server-momentum", type=float, default=0.9)
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--max-staleness", type=int, default=0)
    ap.add_argument("--staleness-decay", type=float, default=0.5)
    ap.add_argument("--partition", default="topic",
                    help="data partitioner spec: 'topic' = the paper's "
                         "per-node topic split; 'iid', 'dirichlet(a)', "
                         "'quantity_skew(a)' pool and re-split the "
                         "corpus")
    ap.add_argument("--transforms", default="",
                    help="comma list of message transforms "
                         f"({sorted(TRANSFORMS)}), in order; either "
                         "--exec-mode")
    ap.add_argument("--no-pad-cohorts", action="store_true",
                    help="disable fixed-K zero-weight padding of "
                         "shrunken cohorts (vmap mode)")
    ap.add_argument("--dp-noise", type=float, default=0.0,
                    help="local-DP Gaussian noise multiplier (used by the "
                         "'dp' transform)")
    ap.add_argument("--dp-clip", type=float, default=1.0,
                    help="local-DP clip norm")
    ap.add_argument("--topk", type=float, default=0.0,
                    help="top-k compression fraction (used by the 'topk' "
                         "transform)")
    ap.add_argument("--hetero-epochs", default="",
                    help="comma list of per-client local-epoch counts, "
                         "cycled over clients (device heterogeneity); "
                         "empty = homogeneous --local-epochs")
    ap.add_argument("--join-rounds", default="",
                    help="comma list: round at which client l joins "
                         "(cycled; empty = all present from round 0)")
    ap.add_argument("--leave-rounds", default="",
                    help="comma list: round at which client l leaves "
                         "(0 = never; cycled)")
    ap.add_argument("--stochastic-loss", action="store_true",
                    help="train-mode ELBO (dropout + reparam noise)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device: 'cuda' (the default; kernels) or "
                         "'cpu' (plain PyTorch path)")
    ap.add_argument("--out", default="")
    if argv is None:
        argv = sys.argv[1:]
    return run_simulation(ap.parse_args(argv), parser=ap, argv=argv)


if __name__ == "__main__":
    main()
