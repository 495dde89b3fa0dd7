"""The readings that a cell's limits are set from, at the cell's own size.

    python3 perfbench/control.py --workload <cell> --control-seeds 1 2 3 \
        --program-seeds 4 5 ... [--out <file.jsonl>]

For each control seed, the plain reference in fp32 against the reference
put in the program's place: computed in TF32 (the control: the nearest
precision below the configuration's fp32), with half of each batch left
out (``half_batch``) and with the combined message altered by 1% as it is
produced (``altered``).  For each program seed, the program's checked
rounds (as a run's set-up drives them) against the reference.  A step
that returns its state unchanged reads 1 on both norm gaps by their
definition and needs no run.  Each reading is one JSON line.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run  # noqa: E402
import torch  # noqa: E402
from fedbench import cells, check, inputs, program  # noqa: E402

VARIANTS = ({"precision": "tf32"}, {"fault": "half_batch"},
            {"fault": "altered"})


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.control_seeds:
        cfg, traffic = cell["config"], cell["traffic"]
        st = SimpleNamespace(
            shapes=program.param_shapes(cfg), exec_seed=seed % 2 ** 32,
            docs=inputs.make_docs(traffic, cfg["vocab_size"], seed, dev))
        t = time.perf_counter()
        ref = run.reference(cell, seed, st, dev)
        ref_s = time.perf_counter() - t
        for kw in VARIANTS:
            got = run.reference(cell, seed, st, dev, **kw)
            nums = check.numbers(got, ref)
            _emit(args.out, {"workload": args.workload, "seed": seed,
                             "side": kw, "reference_s": ref_s,
                             "losses": got["losses"],
                             "ref_losses": ref["losses"], **nums})
            del got
        del st, ref
        gc.collect()
    for seed in args.program_seeds:
        st = run.setup(cell, seed, dev)
        st.fed = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = run.reference(cell, seed, st, dev)
        nums = check.numbers(st.prog, ref)
        _emit(args.out, {"workload": args.workload, "seed": seed,
                         "side": "program", "losses": st.prog["losses"],
                         "ref_losses": ref["losses"],
                         "phases": st.phases, **nums})
        del st, ref
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
