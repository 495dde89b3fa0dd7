"""Training launcher (port of ``repro/launch/train.py``: the same flags
and defaults, plus ``--device``).

The LM path: synchronous data-parallel training of one registered
architecture on one device: each step's batch concatenates
``--num-clients`` client parts of the seeded synthetic token stream, so
the global token-weighted loss's gradient is the paper's Eq. (2)
client-weighted aggregate, and ``--optimizer sgd`` makes the update
Eq. (3).  The full configs run with bf16 activations over fp32 masters,
``--reduced`` in fp32, as the reference does.

The NTM path (``--ntm``, or an NTM arch such as ``prodlda-synthetic``):
the paper's own experiment, Algorithm 1 over ``--num-clients`` nodes of
the synthetic LDA corpus — vocabulary consensus, then
``FederatedTrainer`` with the train-mode ELBO (dropout and
reparametrization on the reference's threefry keys), ``--docs-per-node``
documents a node, ``--secure-agg`` and ``--topk`` as message transforms.
As in the reference, the clients hold BoW only, so ``--arch ctm-s2orc``
(``contextual_dim=768``, the CombinedTM input) fails with
``KeyError: 'contextual'``.  The NTM-only flags are refused on the LM
path, rather than ignored.

Weights come from ``--seed`` on the reference's threefry key tree, so
they are the reference's; ``init=`` carries others in.
``--checkpoint-dir DIR`` writes the LM's final weights as the
reference's npz (``ckpt_{steps:08d}.npz``, its layer-stacked tree keyed
by path).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --reduced --steps 3 --batch 2 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --steps 4 --batch 1 --seq 4096 --num-clients 1      # on a card
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch prodlda-synthetic --ntm --steps 100 --batch 64
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import NTM, FederatedConfig
from repro_torch.checkpoint import save_checkpoint
from repro_torch.checkpoint.checkpoint import to_tree
from repro_torch.core import prng, vocab
from repro_torch.core.engine import ClientState
from repro_torch.core.ntm import prodlda
from repro_torch.core.protocol import FederatedTrainer
from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.data.synthetic_lda import generate_lda_corpus
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import get_optimizer


def train_lm(args, init=None, on_step=None, cfg=None) -> float:
    """``args.steps`` steps; returns the last step's loss.  ``init()``,
    when given, returns the starting weights (the port's tree) in place
    of the seeded init; it is called once, so no caller's frame holds
    them while the steps replace them.  ``on_step(step, loss)`` is
    called after each step with the step's loss tensor.  ``cfg``, when
    given, is trained in place of ``args.arch``'s (a depth-cut config, or
    one with ``remat_layers``), as ``serve`` takes one."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    tfm.check_supported(cfg)
    device = resolve_device(args.device)
    opt = get_optimizer(args.optimizer, args.lr)
    params = init() if init is not None else tfm.init_params(
        prng.PRNGKey(args.seed, device=device), cfg)
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
    if args.checkpoint_dir:
        # the reference's file: its layer-stacked tree, path-keyed
        save_checkpoint(args.checkpoint_dir, args.steps,
                        to_tree(tfm.stack_layers(params)))
        print(f"saved checkpoint to {args.checkpoint_dir}")
    print(f"final loss: {float(loss):.4f}")
    return float(loss)


def train_ntm(args, init=None, on_step=None) -> float:
    """The paper's own experiment: federated ProdLDA/CTM via Algorithm 1
    (the reference's ``train_ntm``); ``args.steps`` rounds at most,
    returns the last round's loss.  ``init()``, when given, returns the
    starting ProdLDA dict; ``on_step(round, loss)`` is called after each
    round."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    syn = generate_lda_corpus(
        vocab_size=cfg.vocab_size, num_topics=cfg.num_topics,
        num_nodes=args.num_clients, shared_topics=max(cfg.num_topics // 5, 1),
        docs_per_node=args.docs_per_node, val_docs_per_node=50,
        seed=args.seed)

    # stage 1: vocabulary consensus (the vocabularies already share ids;
    # the merge mirrors Algorithm 1's information flow)
    terms = [f"term{i}" for i in range(cfg.vocab_size)]
    vocabs = [vocab.Vocabulary.from_bow(b, terms) for b in syn.node_bows]
    v_global = vocab.merge_vocabularies(vocabs)
    print(f"vocabulary consensus: |V| = {len(v_global)} "
          f"from {len(vocabs)} clients")

    def loss_fn(p, b):
        return prodlda.elbo_loss(p, cfg, b)
    params = init() if init is not None else prodlda.init_params(
        prng.PRNGKey(args.seed, device=device), cfg)
    fed = FederatedConfig(num_clients=args.num_clients,
                          learning_rate=args.lr, max_rounds=args.steps,
                          local_steps=args.local_steps,
                          secure_aggregation=args.secure_agg,
                          compression_topk=args.topk)
    clients = [ClientState(data={"bow": torch.from_numpy(b).to(device)},
                           num_docs=len(b)) for b in syn.node_bows]
    trainer = FederatedTrainer(loss_fn, params, clients, fed,
                               optimizer=get_optimizer(args.optimizer,
                                                       args.lr),
                               batch_size=args.batch)
    hook = None if on_step is None else \
        (lambda rec: on_step(rec["round"], rec["loss"]))
    trainer.fit(seed=args.seed, verbose=True, on_round=hook)
    print(f"final loss: {trainer.history[-1]['loss']:.4f} after "
          f"{len(trainer.history)} rounds")
    return trainer.history[-1]["loss"]


# the NTM trainer's own flags and their defaults
_NTM_FLAGS = {"docs_per_node": 500, "local_steps": 1, "secure_agg": False,
              "topk": 0.0}


def parser() -> argparse.ArgumentParser:
    """The launcher's flags: the reference's, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="phi3-mini-3.8b",
                    choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ntm", action="store_true",
                    help="Algorithm-1 NTM trainer (paper experiment)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--num-clients", type=int, default=4)
    ap.add_argument("--docs-per-node", type=int, default=500)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--secure-agg", action="store_true")
    ap.add_argument("--topk", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    return ap


def main(argv=None, init=None, on_step=None, cfg=None):
    """Parse ``argv`` and train; ``init`` and ``on_step`` go to
    ``train_ntm`` (``--ntm`` or an NTM arch) or ``train_lm``, ``cfg`` (an
    LM config in place of ``--arch``'s) to ``train_lm``.  Returns the last
    step's loss."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.ntm or get_config(args.arch).kind == NTM:
        return train_ntm(args, init=init, on_step=on_step)
    given = [f"--{k.replace('_', '-')}" for k, v in _NTM_FLAGS.items()
             if getattr(args, k) != v]
    if given:
        ap.error(f"{', '.join(given)} configure the NTM trainer; add --ntm "
                 "(the LM path would ignore them)")
    return train_lm(args, init=init, on_step=on_step, cfg=cfg)


if __name__ == "__main__":
    main()
