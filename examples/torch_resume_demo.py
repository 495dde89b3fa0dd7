"""Resume contract demo on PyTorch: snapshot mid-run, resume, bitwise.

The twin of ``examples/resume_demo.py`` on the port (``repro_torch``).
Runs a straggler + top-k federation (the most stateful regime: messages
in flight in the straggler ring, one top-k error memory a client) on the
batched cohort path for 10 rounds, snapshots the whole engine state via
``Federation.save_state`` to a file, keeps going to 20 rounds, then
builds a fresh ``Federation`` from the SAME spec, loads the snapshot,
and runs it to 20.  The resumed run must equal the uninterrupted one
BIT FOR BIT: the cohorts, straggler delays and every draw are pure
functions of (spec, round index), and the snapshot holds everything
else.  On a CUDA device (the default) the rounds run kernels B2 and B4.

Run:  PYTHONPATH=src python examples/torch_resume_demo.py [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.api import (Federation, FederationSpec, build_corpus,
                             max_param_dev)
from repro_torch.api.spec import (DataSpec, ExecutionSpec, ModelSpec,
                                  ScheduleSpec, TransformsSpec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    spec = FederationSpec(
        name="resume-demo",
        model=ModelSpec(vocab=200, topics=5, hidden=32),
        data=DataSpec(num_clients=4, docs_per_node=60, val_docs_per_node=10),
        schedule=ScheduleSpec(rounds=20, straggler_prob=0.3,
                              max_staleness=2),
        transforms=TransformsSpec(names=("topk",), compression_topk=0.5),
        execution=ExecutionSpec(exec_mode="vmap", batch_size=16))
    syn = build_corpus(spec)          # shared, so the three runs see the
    #                                   same federation

    print("run A: 10 rounds, snapshot, then 10 more ...")
    a = Federation.from_spec(spec, corpus=syn, device=args.device)
    a.run(rounds=10)
    # a private directory per run: pickle is a trusted-input format
    snap_dir = tempfile.mkdtemp(prefix="torch_resume_demo_")
    snap_path = os.path.join(snap_dir, "snap.pkl")
    a.save_state(snap_path)
    print(f"  snapshot at round {a.round_index} on {a.device} -> "
          f"{snap_path}")
    a.run()                           # rounds 10..19

    print("run B: fresh Federation from the same spec, resume snapshot ...")
    b = Federation.from_spec(spec, corpus=syn, device=args.device)
    b.load_state(snap_path)
    print(f"  resumed at round {b.round_index}")
    b.run()

    print("run C: uninterrupted 20 rounds (control) ...")
    c = Federation.from_spec(spec, corpus=syn, device=args.device)
    c.run()

    dev_ab = max_param_dev(a.params, b.params)
    dev_ac = max_param_dev(a.params, c.params)
    print(f"max |A - B| = {dev_ab!r}  (snapshot/resume)")
    print(f"max |A - C| = {dev_ac!r}  (vs uninterrupted)")
    assert dev_ab == 0.0, "resume is not bit-identical!"
    assert dev_ac == 0.0, "interrupted != uninterrupted!"
    assert a.history == b.history == c.history
    print("resume contract holds: resumed trajectory is BITWISE identical")
    os.unlink(snap_path)
    os.rmdir(snap_dir)
    return {"resume_dev": dev_ab, "control_dev": dev_ac,
            "in_flight": [h["in_flight"] for h in a.history]}


if __name__ == "__main__":
    main()
