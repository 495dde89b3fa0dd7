"""Wall time of one LM prefill and of one decode step of the port, in the
tree given by ``--root``, so that two revisions of the host path around
the kernels can be compared on one card.

hymba-1.5b at full width, bf16 (the weights read through a cast drawn
straight into bf16 from seed 0, as the serve path holds them): a prefill
of ``--batch`` x ``--prompt`` tokens into a cache with room for
``--steps`` more, then ``--steps`` greedy decode steps.  Each prefill
and each step is timed on the host clock to a synchronize, after two
warm-up prefills; prints one JSON line with the tree, the medians and
every time.  Run each revision in a process of its own, interleaved (A,
B, B, A), on one card one after another:

    python tools/time_step.py --root checkout/parent
    python tools/time_step.py --root .
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=".")
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--prefills", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models import transformer as tfm

    cfg = get_config(args.arch)
    params = tfm.init_params(prng.PRNGKey(0, device="cuda"), cfg,
                             dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                         device="cuda", generator=g)
    max_len = args.prompt + args.steps

    def prefill():
        with torch.no_grad():
            return tfm.prefill(params, cfg, {"tokens": toks},
                               max_len=max_len)
    for _ in range(2):
        prefill()
    prefills = []
    for _ in range(args.prefills):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill()
        torch.cuda.synchronize()
        prefills.append(time.perf_counter() - t0)
    tok = logits[:, -1:].argmax(-1)
    steps = []
    with torch.no_grad():
        for _ in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = tfm.decode_step(params, cfg, cache, tok)
            tok = logits[:, -1:].argmax(-1)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
    print(json.dumps({
        "root": args.root, "arch": args.arch,
        "shape": [args.batch, args.prompt, args.steps],
        "prefill_ms": statistics.median(prefills) * 1e3,
        "decode_step_ms": statistics.median(steps) * 1e3,
        "prefills_ms": [x * 1e3 for x in prefills],
        "steps_ms": [x * 1e3 for x in steps]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
