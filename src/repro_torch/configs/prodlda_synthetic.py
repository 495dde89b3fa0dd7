"""ProdLDA on the paper's synthetic-LDA setting (paper §4.1).

Paper defaults: V=5000 artificial terms, K=50 topics, L=5 nodes,
10 000 train + 1 000 validation docs per node, doc length U[150, 250],
alpha = 50/K, encoder = the AVITM authors' default (100-100 softplus MLP,
dropout 0.2, learned priors).
"""
from repro_torch.configs.base import NTM, ModelConfig

CONFIG = ModelConfig(
    name="prodlda-synthetic",
    kind=NTM,
    citation="arXiv:1703.01488 (AVITM) per the paper's §4.1 setup",
    vocab_size=5000,
    num_topics=50,
    ntm_hidden=(100, 100),
    ntm_dropout=0.2,
    contextual_dim=0,
    learn_priors=True,
)
