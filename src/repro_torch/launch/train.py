"""LM training launcher (port of ``repro/launch/train.py``'s LM path: the
same flags and defaults, plus ``--device``).

Synchronous data-parallel training of one registered architecture on
one device: each step's batch concatenates ``--num-clients`` client
parts of the seeded synthetic token stream, so the global token-weighted
loss's gradient is the paper's Eq. (2) client-weighted aggregate, and
``--optimizer sgd`` makes the update Eq. (3).  The full configs run with
bf16 activations over fp32 masters, ``--reduced`` in fp32, as the
reference does.  The weights are the port's own seeded init (the
reference draws threefry keys: the loss curves agree in distribution,
not in value, until ROADMAP.md A4).  ``--ntm`` (the NTM trainer) and
``--checkpoint-dir`` raise, naming A3 and A11.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --reduced --steps 3 --batch 2 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --steps 4 --batch 1 --seq 4096 --num-clients 1      # on a card
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import get_optimizer


def train_lm(args, init=None, on_step=None) -> float:
    """``args.steps`` steps; returns the last step's loss.  ``init()``,
    when given, returns the starting weights (the port's tree) in place
    of the seeded init; it is called once, so no caller's frame holds
    them while the steps replace them.  ``on_step(step, loss)`` is
    called after each step with the step's loss tensor."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tfm.check_supported(cfg)
    device = resolve_device(args.device)
    opt = get_optimizer(args.optimizer, args.lr)
    params = init() if init is not None else tfm.init_params(
        torch.Generator().manual_seed(args.seed), cfg, device=device)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, dtype=torch.float32
                              if args.reduced else None)
    stream = SyntheticLMStream(cfg, args.batch, args.seq,
                               num_clients=args.num_clients, seed=args.seed)
    t0 = time.time()
    loss = torch.tensor(float("nan"))
    for step, batch in zip(range(args.steps), stream):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params, opt_state, loss = step_fn(params, opt_state, batch, step)
        if on_step is not None:
            on_step(step, loss)
        if step % args.log_every == 0:
            print(f"[step {step:5d}] loss={float(loss):.4f} "
                  f"({time.time() - t0:.1f}s)")
    print(f"final loss: {float(loss):.4f}")
    return float(loss)


def parser() -> argparse.ArgumentParser:
    """The launcher's flags: the reference's LM flags, plus ``--device``.
    The reference's NTM-only flags (``--docs-per-node``,
    ``--local-steps``, ``--secure-agg``, ``--topk``) come with ``--ntm``
    (ROADMAP.md A3)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="phi3-mini-3.8b",
                    choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ntm", action="store_true",
                    help="Algorithm-1 NTM trainer (not in the port: A3)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--num-clients", type=int, default=4)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    return ap


def main(argv=None, init=None, on_step=None):
    """Parse ``argv`` and train; ``init`` and ``on_step`` go to
    ``train_lm``.  Returns the last step's loss."""
    args = parser().parse_args(argv)
    if args.ntm:
        raise NotImplementedError("the NTM trainer (--ntm) is not in the "
                                  "port's launcher yet (ROADMAP.md A3)")
    if args.checkpoint_dir:
        raise NotImplementedError("checkpoints (--checkpoint-dir) are not "
                                  "in the port yet (ROADMAP.md A11)")
    return train_lm(args, init=init, on_step=on_step)


if __name__ == "__main__":
    main()
