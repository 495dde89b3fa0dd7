"""Serving launcher: batched prefill + greedy lock-step decode (port of
``repro/launch/serve.py``: the same flags and returned keys, plus
``--device``).

The prompts are ``--batch`` seeded integer sequences of ``--prompt-len``
tokens (the reference draws equal-length prompts, not left-padded
ones); the weights are the port's own seeded init.  The full configs run
with bf16 activations (the weights the layers read through a cast drawn
in bf16, the rest in fp32); ``--reduced`` runs in fp32, as the reference
does.

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --reduced --batch 4 --prompt-len 96 --max-new 8 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import prng
from repro_torch.models import transformer as tfm


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(args, params=None, cfg=None) -> dict:
    """Prefill ``args.batch`` prompts, then decode ``args.max_new`` tokens
    greedily in lock-step.  ``params`` (the port's tree, e.g. from
    :func:`repro_torch.models.transformer.params_from_reference`) replaces
    the seeded init, and ``cfg`` the arch's config (a variant cut in
    depth, for one card).  An encoder-only arch exits, as the reference's
    launcher does."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path "
                         f"(DESIGN.md §7)")
    tfm.check_supported(cfg)
    device = resolve_device(args.device)
    dtype = torch.float32 if args.reduced else getattr(torch, cfg.dtype)
    if params is None:
        # the weights read through a cast drawn straight into ``dtype``:
        # the bits of activation_copy of the fp32 init, without its peak
        params = tfm.init_params(prng.PRNGKey(args.seed, device=device),
                                 cfg, dtype=dtype)
    elif dtype != torch.float32:
        params = tfm.activation_copy(params, cfg, dtype)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    ).to(device)

    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = tfm.prefill(params, cfg, {"tokens": prompts},
                                    dtype=dtype,
                                    max_len=args.prompt_len + args.max_new)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        tok = sample_greedy(logits)
        generated = [tok]
        t1 = time.perf_counter()
        for _ in range(args.max_new - 1):
            logits, cache = tfm.decode_step(params, cfg, cache, tok,
                                            dtype=dtype)
            tok = sample_greedy(logits)
            generated.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t1

    out = torch.cat(generated, dim=1).cpu().numpy().astype(np.int32)
    tokens_per_s = args.batch * (args.max_new - 1) / max(t_decode, 1e-9)
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill:.3f}s")
    print(f"decode:  {args.max_new - 1} steps x {args.batch} reqs "
          f"in {t_decode:.3f}s ({tokens_per_s:.1f} tok/s)")
    print(f"first generations: {out[:, :8]}")
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "tokens_per_s": tokens_per_s, "generated": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-1.3b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    return serve(ap.parse_args(argv))


if __name__ == "__main__":
    main()
