"""Serving demo on PyTorch: batched prefill + autoregressive decode across
families.

The twin of ``examples/serve_demo.py`` on the port (``repro_torch``).
Exercises the three cache disciplines in production serving:
  * full KV cache            (phi3 — dense GQA),
  * ring-buffer window cache (granite with the long_500k sliding-window
    variant — constant memory at any context length),
  * recurrent SSM state      (mamba2 — no KV cache at all),
and, as the reference's demo does, MLA's latent cache (minicpm3) and
the hybrid's window KV beside its SSM state (hymba).  Reduced configs,
fp32, from the seed's weights; on a CUDA device (the default) the
prefills run kernels B5 and B6.

Run:  PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.api import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.models import transformer as tfm

DEMOS = (("phi3-mini-3.8b", 0),        # full KV cache
         ("granite-34b", 32),          # ring buffer (long-context mode)
         ("mamba2-1.3b", 0),           # recurrent state only
         ("minicpm3-4b", 0),           # MLA latent cache
         ("hymba-1.5b", 0))            # hybrid: window KV + SSM state


def demo(arch, *, window=0, prompt_len=48, max_new=16, device="cuda"):
    """Greedy generations (2, max_new) of the reduced ``arch``."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    params = tfm.init_params(prng.PRNGKey(0, device=dev), cfg)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, prompt_len))).to(dev)
    with torch.no_grad():
        logits, cache = tfm.prefill(params, cfg, {"tokens": prompts},
                                    dtype=torch.float32,
                                    max_len=prompt_len + max_new)
        tok = torch.argmax(logits[:, -1:, :], dim=-1)
        out = [tok]
        t0 = time.time()
        for _ in range(max_new - 1):
            logits, cache = tfm.decode_step(params, cfg, cache, tok,
                                            dtype=torch.float32)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        gen = torch.cat(out, dim=1).cpu().numpy()
    dt = time.time() - t0
    cache_desc = {k: tuple(v.shape) for k, v in cache.items()
                  if isinstance(v, torch.Tensor)}
    print(f"{arch:18s} window={window or '-':>5} "
          f"{2 * (max_new - 1) / dt:6.1f} tok/s  cache={cache_desc}")
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    print("arch               window  tok/s   cache layout")
    return {arch: demo(arch, window=window, device=args.device)
            for arch, window in DEMOS}


if __name__ == "__main__":
    main()
