"""Privacy & communication features of the federated protocol, on PyTorch.

The twin of ``examples/privacy_features.py`` on the port (``repro_torch``).
Demonstrates, on a small federated ProdLDA run:
  1. secure aggregation — pairwise PRG masks hide every client's gradient
     from the server while the aggregate stays unchanged;
  2. local differential privacy — clip + Gaussian noise, utility trade-off;
  3. top-k gradient compression with error feedback — 10x fewer bytes on
     the wire per round, convergence preserved;
  4. FedAvg local steps — K x fewer synchronization rounds.

Weights and masks come from the reference's threefry keys, so the masks
are the reference example's (normals within a few ulps).  On a CUDA
device the combine runs kernel B2, dp and secure kernel B3, top-k B4.

Run:  PYTHONPATH=src python examples/torch_privacy_features.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import resolve_device
from repro_torch.configs.base import NTM, FederatedConfig, ModelConfig
from repro_torch.core import prng
from repro_torch.core.aggregation import pairwise_mask
from repro_torch.core.ntm import prodlda
from repro_torch.core.protocol import (ClientState, FedAvgTrainer,
                                       FederatedTrainer)
from repro_torch.data.synthetic_lda import generate_lda_corpus
from repro_torch.optim import adam


def make_setup(dev, vocab: int, docs: int):
    cfg = ModelConfig(name="privacy-demo", kind=NTM, vocab_size=vocab,
                      num_topics=8, ntm_hidden=(48, 48))
    syn = generate_lda_corpus(vocab_size=vocab, num_topics=8, num_nodes=4,
                              shared_topics=2, docs_per_node=docs,
                              val_docs_per_node=40, seed=3)
    loss = lambda p, b: prodlda.elbo_loss(p, cfg, b)  # noqa: E731
    init = prodlda.init_params(prng.PRNGKey(0, device=dev), cfg)
    clients = [ClientState(data={"bow": torch.from_numpy(b).to(dev)},
                           num_docs=len(b)) for b in syn.node_bows]
    return cfg, loss, init, clients


def run_variant(name, fed, setup, trainer_cls=FederatedTrainer, rounds=60):
    _, loss, init, clients = setup
    # FedAvg runs plain local SGD at fed.learning_rate and takes no client
    # optimizer (the reference's ignores the one it is handed)
    kw = {"optimizer": adam(2e-3)} if trainer_cls is FederatedTrainer \
        else {}
    tr = trainer_cls(loss, init, clients, fed, batch_size=48, **kw)
    for _ in range(rounds):
        tr.round()
    print(f"{name:34s} loss {tr.history[0]['loss']:8.2f} -> "
          f"{tr.history[-1]['loss']:8.2f}")
    return tr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--vocab", type=int, default=300)
    ap.add_argument("--docs", type=int, default=250,
                    help="documents per client")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== masks cancel exactly ==")
    tree = {"w": torch.zeros((64, 32), device=dev)}
    key = prng.PRNGKey(0)
    masks = [pairwise_mask(tree, key, c, 4, scale=8.0) for c in range(4)]
    total = float(torch.abs(sum(m["w"] for m in masks)).max())
    one = float(torch.abs(masks[0]["w"]).max())
    print(f"per-client mask magnitude: {one:.2f}; "
          f"sum over clients: {total:.2e} (cancels)\n")

    print("== convergence under each privacy/communication mode ==")
    setup = make_setup(dev, args.vocab, args.docs)
    r = args.rounds
    out = {"mask_sum": total, "mask_magnitude": one, "loss": {}}
    for name, fed, cls, rounds in (
            ("baseline SyncOpt (paper)",
             FederatedConfig(learning_rate=2e-3), FederatedTrainer, r),
            ("secure aggregation",
             FederatedConfig(learning_rate=2e-3, secure_aggregation=True),
             FederatedTrainer, r),
            ("top-10% compression + err-fb",
             FederatedConfig(learning_rate=2e-3, compression_topk=0.1),
             FederatedTrainer, r),
            ("local DP (clip 1.0, sigma 0.3)",
             FederatedConfig(learning_rate=2e-3, dp_clip_norm=1.0,
                             dp_noise_multiplier=0.3), FederatedTrainer, r),
            ("FedAvg 4 local steps",
             FederatedConfig(learning_rate=2e-3, local_steps=4),
             FedAvgTrainer, max(r // 4, 1))):
        tr = run_variant(name, fed, setup, trainer_cls=cls, rounds=rounds)
        out["loss"][name] = (tr.history[0]["loss"], tr.history[-1]["loss"])
    print("\n(secure-agg run must match baseline to float precision; "
          "compare the loss columns)")
    assert all(np.isfinite(v).all() for v in out["loss"].values())
    return out


if __name__ == "__main__":
    main()
