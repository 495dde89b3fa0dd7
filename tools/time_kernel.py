"""Device time of one of the port's kernels at one shape and dtype, in
the tree given by ``--root``, so that two revisions of its CUDA source can
be compared on one card.

Builds only the kernel's own source of that tree (into its own
``kernels/build/``), times ``--calls`` back-to-back calls between two CUDA
events ``--reps`` times after a warm-up, and prints one JSON line: the
tree, the kernel, the shape, the per-call median and every rep.  Run each
revision in a process of its own, interleaved (A, B, B, A), in one
machine session:

    python tools/time_kernel.py --root checkout/parent flash_attention
    python tools/time_kernel.py --root . flash_attention

Kernels and their default shapes (bf16, the default ``--dtype``):

- ``flash_attention`` (B5): hymba-1.5b's prefill, ``b,s,hq,hkv,dqk,dv``
  = 4,2048,25,5,64,64, causal with a 1024-token window;
- ``flash_attention_bwd`` (B5-bwd, from the forward's ``out`` and
  ``lse``): hymba's training step, 1,4096,25,5,64,64, the same mask;
- ``ssd_scan`` (B6): hymba-1.5b's prefill, ``b,s,h,p,n,chunk`` =
  4,2048,50,64,16,256;
- ``ssd_scan_bwd`` (B6-bwd, from the states the forward kept): hymba's
  training step, 1,4096,50,64,16,256.

With ``--dtype float32`` B5 and B5-bwd default to the federated
hymba-1.5b round's folded batch (4 clients x 4 documents), 16,2048,25,5,
64,64 with the 1024-token window; the minicpm3-4b round's (4 clients x 2
documents, MLA's pair, causal) is ``--shape 8,2048,40,40,96,64 --window
0``.  B6 and B6-bwd default to one client of that hymba round,
4,2048,50,64,16,256 (the batched path calls them once a client); one
client of a mamba2-1.3b round at its full width is ``--shape
4,2048,64,64,128,256``.

``--pad N`` gives B5 and B5-bwd explicit positions ``arange(S) - N`` on
every row (``--pad 0``: ``arange(S)`` through the kernels' position
instances); ``--h0`` starts B6 and B6-bwd from a drawn carried state.
Neither exists in a tree before explicit positions and carried states
were ported: leave them out when timing such a parent.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

SHAPES = {"flash_attention": "4,2048,25,5,64,64",
          "flash_attention_bwd": "1,4096,25,5,64,64",
          "ssd_scan": "4,2048,50,64,16,256",
          "ssd_scan_bwd": "1,4096,50,64,16,256"}
SHAPES_F32 = {"flash_attention": "16,2048,25,5,64,64",
              "flash_attention_bwd": "16,2048,25,5,64,64",
              "ssd_scan": "4,2048,50,64,16,256",
              "ssd_scan_bwd": "4,2048,50,64,16,256"}
# the sources each kernel's call builds (the backward reads the states
# the forward kept)
SOURCES = {"flash_attention": ("flash_attention",),
           "flash_attention_bwd": ("flash_attention", "flash_attention_bwd"),
           "ssd_scan": ("ssd_scan",),
           "ssd_scan_bwd": ("ssd_scan", "ssd_scan_bwd")}


def _call(kernel, shape, args, torch, dev):
    """The kernel's call on inputs drawn from seed 0."""
    g = torch.Generator().manual_seed(0)
    dtype = getattr(torch, args.dtype)

    def randn(*s):
        return torch.randn(*s, generator=g).to(dev, dtype)
    if kernel.startswith("flash_attention"):
        from repro_torch.kernels.flash_attention import (
            flash_attention_bwd_cuda, flash_attention_cuda)
        b, s, hq, hkv, dqk, dv = shape
        q, k, v = randn(b, s, hq, dqk), randn(b, s, hkv, dqk), \
            randn(b, s, hkv, dv)
        mask = dict(causal=bool(args.causal), window=args.window,
                    scale=dqk ** -0.5)
        if args.pad is not None:
            pos = (torch.arange(s) - args.pad).to(dev, torch.int32)
            mask.update(q_pos=pos.expand(b, s), k_pos=pos.expand(b, s))
        if kernel == "flash_attention":
            return lambda: flash_attention_cuda(q, k, v, **mask)
        out, lse = flash_attention_cuda(q, k, v, want_lse=True, **mask)
        dout = randn(b, s, hq, dv)
        return lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                **mask)
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    b, s, h, p, n, chunk = shape
    conv = randn(b, s, h * p + 2 * n)
    xs, bb, cc = conv.split([h * p, n, n], dim=-1)
    x = xs.reshape(b, s, h, p)
    dt = (0.001 + 0.099 * torch.rand(b, s, h, generator=g)).to(dev)
    a = -torch.arange(1, h + 1, dtype=torch.float32).to(dev)
    start = {"h0": torch.randn(b, h, p, n, generator=g).to(dev)} \
        if args.h0 else {}
    if kernel == "ssd_scan":
        return lambda: ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk, **start)
    dy = randn(b, s, h, p)
    _, _, st = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk, keep_states=True,
                             **start)
    return lambda: ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, None,
                                     chunk=chunk)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(SHAPES))
    ap.add_argument("--root", default=".")
    ap.add_argument("--shape", default=None, help="see the module docstring")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--causal", type=int, default=1)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--pad", type=int, default=None,
                    help="B5: positions arange(S) - PAD on every row")
    ap.add_argument("--h0", action="store_true",
                    help="B6: start from a drawn carried state")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    default = SHAPES_F32.get(args.kernel) if args.dtype == "float32" \
        else None
    shape = [int(v) for v in (args.shape or default
                              or SHAPES[args.kernel]).split(",")]
    _build.SOURCES = SOURCES[args.kernel]
    call = _call(args.kernel, shape, args, torch, torch.device("cuda"))
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    reps = []
    for _ in range(args.reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(args.calls):
            call()
        t1.record()
        t1.synchronize()
        reps.append(t0.elapsed_time(t1) * 1e3 / args.calls)
    print(json.dumps({"root": args.root, "kernel": args.kernel,
                      "shape": shape, "dtype": args.dtype,
                      "causal": args.causal, "window": args.window,
                      "pad": args.pad, "h0": args.h0,
                      "us_per_call": statistics.median(reps),
                      "reps_us": reps,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
