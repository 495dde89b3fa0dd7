"""hubert-xlarge — encoder-only audio transformer (wav2vec2 architecture).

[arXiv:2106.07447] HuBERT. 48 layers, d_model 1280, 16 heads (full MHA,
kv=16), d_ff 5120, vocab 504 (k-means cluster units for masked prediction).
The mel-spectrogram + conv feature extractor frontend is a stub:
callers provide precomputed frame embeddings. Encoder-only:
no decode shapes (DESIGN.md §7).
"""
from repro_torch.configs.base import AUDIO, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    kind=AUDIO,
    citation="arXiv:2106.07447",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    max_seq_len=4096,
    encoder_only=True,
    frontend_embed_dim=1280,   # conv feature extractor output dim (stubbed)
    activation="gelu",
    tie_embeddings=False,
)
