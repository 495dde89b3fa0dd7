"""phi3-mini-3.8b — dense RoPE+SwiGLU+GQA (kv=heads=32 i.e. full MHA).

[arXiv:2404.14219] Phi-3 technical report. 32 layers, d_model 3072,
32 heads (kv=32), d_ff 8192, vocab 32064.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    kind=DENSE,
    citation="arXiv:2404.14219",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    max_seq_len=4096,
    rope_theta=10000.0,
    activation="swiglu",
)
