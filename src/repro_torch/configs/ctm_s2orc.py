"""CombinedTM for the paper's real-data experiment (paper §4.2).

The paper trains gFedNTM+CTM over five Semantic Scholar (S2ORC) field-of-
study subsets with K in {10, 25}, max 100 federated iterations, CTM author
defaults. SBERT embeddings are 768-d.  S2ORC is not redistributable
offline; the runs here use the synthetic stand-in corpus with
``data.synthetic_lda.fake_contextual_embeddings``.
"""
from repro_torch.configs.base import NTM, ModelConfig

CONFIG = ModelConfig(
    name="ctm-s2orc",
    kind=NTM,
    citation="arXiv:2004.03974 (CombinedTM) per the paper's §4.2 setup",
    vocab_size=10000,
    num_topics=25,
    ntm_hidden=(100, 100),
    ntm_dropout=0.2,
    contextual_dim=768,
    learn_priors=True,
)
