"""Quickstart on PyTorch: train a federated neural topic model (gFedNTM).

The twin of ``examples/quickstart.py`` on the port (``repro_torch``).
The paper's Algorithm 1, end to end on synthetic data:
  stage 1 — vocabulary consensus across 3 clients,
  stage 2 — synchronous federated training (Eq. 2 aggregation, Eq. 3
            server update with adam),
then evaluation against the known LDA ground truth with the paper's DSS
and TSS metrics, and a check that the federated model equals centralized
training on the concatenated corpus: with whole-corpus minibatches and
SGD, the Eq. (2) average of the clients' gradients is the gradient of
the pooled loss, so both runs take the same steps.  Weights come from
``PRNGKey(0)`` on the reference's key schedule, so they are the
reference quickstart's.  On a CUDA device the combine runs kernel B2.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import max_param_dev, resolve_device
from repro_torch.configs.base import NTM, FederatedConfig, ModelConfig
from repro_torch.core import prng
from repro_torch.core.ntm import prodlda
from repro_torch.core.protocol import (ClientState, FederatedTrainer,
                                       train_centralized)
from repro_torch.core.vocab import Vocabulary, merge_vocabularies
from repro_torch.data.synthetic_lda import generate_lda_corpus
from repro_torch.metrics import dss, tss
from repro_torch.optim import adam, sgd


def federated_equals_centralized(cfg, syn, init, dev, steps: int = 5
                                 ) -> float:
    """Max parameter deviation between ``steps`` rounds of federated SGD
    (each client's whole corpus a minibatch) and ``steps`` centralized
    SGD steps on the concatenated corpus, from the same init."""
    def loss(p, b):
        return prodlda.elbo_loss(p, cfg, b, train=False)
    bows = [torch.from_numpy(b).to(dev) for b in syn.node_bows]
    clients = [ClientState(data={"bow": b}, num_docs=len(b)) for b in bows]
    fed = FederatedTrainer(
        loss, init, clients,
        FederatedConfig(num_clients=len(bows), learning_rate=1e-3,
                        max_rounds=steps, rel_tol=0.0),
        optimizer=sgd(1e-3), batch_size=max(len(b) for b in bows))
    fed_params = fed.fit(seed=0)
    pooled = torch.cat(bows)
    cent = train_centralized(loss, init, {"bow": pooled},
                             optimizer=sgd(1e-3), batch_size=len(pooled),
                             steps=steps, seed=0)
    return max_param_dev(fed_params, cent)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = ModelConfig(name="quickstart", kind=NTM, vocab_size=400,
                      num_topics=10, ntm_hidden=(64, 64))
    print("generating synthetic federation (3 clients, 2 shared topics)...")
    syn = generate_lda_corpus(
        vocab_size=cfg.vocab_size, num_topics=cfg.num_topics, num_nodes=3,
        shared_topics=2, docs_per_node=400, val_docs_per_node=80, seed=0)

    # ---- stage 1: vocabulary consensus --------------------------------
    terms = [f"term{i}" for i in range(cfg.vocab_size)]
    vocabs = [Vocabulary.from_bow(b, terms) for b in syn.node_bows]
    v_global = merge_vocabularies(vocabs)
    print(f"stage 1: merged vocabulary |V| = {len(v_global)}")

    # ---- stage 2: federated training (Algorithm 1) --------------------
    init = prodlda.init_params(prng.PRNGKey(0, device=dev), cfg)
    clients = [ClientState(data={"bow": torch.from_numpy(b).to(dev)},
                           num_docs=len(b)) for b in syn.node_bows]
    trainer = FederatedTrainer(
        lambda p, b: prodlda.elbo_loss(p, cfg, b), init, clients,
        FederatedConfig(num_clients=3, learning_rate=2e-3,
                        max_rounds=args.rounds, rel_tol=0.0),
        optimizer=adam(2e-3), batch_size=64)
    print(f"stage 2: federated training on {dev}...")
    params = trainer.fit(seed=0, verbose=True)

    # ---- evaluate against ground truth --------------------------------
    beta = prodlda.get_topics(params).detach().cpu().numpy()
    with torch.no_grad():
        theta = prodlda.infer_theta(
            params, cfg, torch.from_numpy(syn.concat_val_bows()).to(dev))
    theta = theta.cpu().numpy()
    print(f"\nDSS (lower=better):  {dss(syn.concat_val_thetas(), theta):.3f}")
    print(f"TSS (max {cfg.num_topics}):     {tss(syn.beta, beta):.2f}")
    print("top words of topic 0:",
          np.argsort(beta[0])[::-1][:8].tolist())

    # ---- federated == centralized --------------------------------------
    dev_fc = federated_equals_centralized(cfg, syn, init, dev)
    print(f"federated vs centralized SGD, 5 whole-corpus steps: max "
          f"|param diff| = {dev_fc:.3e}")
    assert dev_fc <= 1e-5, "federated training left centralized training"
    return {"dss": float(dss(syn.concat_val_thetas(), theta)),
            "tss": float(tss(syn.beta, beta)), "fed_vs_central": dev_fc}


if __name__ == "__main__":
    main()
