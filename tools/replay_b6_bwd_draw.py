"""Replay the one draw on which B6-bwd's bf16 ``da`` left its bound, and
save it.

``chip_smoke.py``'s kernel phase draws every check's inputs from one
generator seeded 0.  In the revision that first checked B5 at the dense
zoo's head dims, those checks ran right after B5's own, on that same
generator, so every later check drew other inputs; B6-bwd's grid case
(1, 100, 2, 32, 16, 48) in bf16 then read ``da`` at 0.106 of max|plain|
against its 2e-2 bound.  This script runs the phase's checks in that
order on the card (the federated LM shapes left out: they draw from the
generator after B6-bwd), draws B6-bwd's grid in its order, prints each
case's errors, and writes the failing case's inputs (x, B and C as the
one conv output they are slices of, dt, dy, dh) to ``--out`` for
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` to hold as a fixed case.

    python tools/replay_b6_bwd_draw.py --out chiprun_out/ssd_bwd_draw.pt
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = (1, 100, 2, 32, 16, 48)


class _Done(Exception):
    """Raised once B6-bwd's grid is drawn: the phase stops there."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/ssd_bwd_draw.pt")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    import chip_smoke as c
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    orig = {n: getattr(c, n) for n in ("_kernel_b3", "_kernel_b5",
                                       "_kernel_b5_zoo")}
    stash = {}

    def b3_after_b5(g, dev):          # B5, then its zoo cases, then B3
        rec = orig["_kernel_b5"](g, dev)
        orig["_kernel_b5_zoo"](g, dev, rec)
        stash["b5"] = rec
        return orig["_kernel_b3"](g, dev)

    def b6_bwd_grid(g, dev):
        found = None
        for b, s, h, p, n, chunk, dtype in c.B6_BWD_CASES:
            i = len(stash.setdefault("rows", []))
            x, dt, a, bb, cc = c._ssd_inputs(g, dev, b, s, h, p, n, dtype)
            dy = torch.randn(b, s, h, p, generator=g).to(dev, dtype)
            dh = None if i == 0 else \
                torch.randn(b, h, p, n, generator=g).to(dev)
            _, _, st = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk,
                                     keep_states=True)
            got = ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, dh,
                                    chunk=chunk)
            want = ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, dh, chunk)
            rel = [c._rel_err(u, w) for u, w in zip(got, want)]
            stash["rows"].append({"case": [b, s, h, p, n, chunk,
                                           str(dtype)], "rel": rel})
            if (b, s, h, p, n, chunk) == CASE and dtype == torch.bfloat16:
                conv = torch.cat([x.reshape(b, s, h * p), bb, cc], -1)
                found = {"conv": conv.cpu(), "dt": dt.cpu(), "dy": dy.cpu(),
                         "dh": dh.cpu(), "shape": list(CASE[:-1]),
                         "chunk": chunk, "rel": rel}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        torch.save(found, args.out)
        raise _Done

    c._kernel_b3 = b3_after_b5
    c._kernel_b5 = lambda g, dev: stash["b5"]
    c._kernel_b6_bwd = b6_bwd_grid
    try:
        c.phase_kernels()
    except _Done:
        pass
    for row in stash["rows"]:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
