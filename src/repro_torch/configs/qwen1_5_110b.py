"""qwen1.5-110b — dense transformer with QKV bias.

[hf:Qwen/Qwen1.5-0.5B (family card)] 80 layers, d_model 8192, 64 heads
(GQA kv=8), d_ff 49152, vocab 152064.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    kind=DENSE,
    citation="hf:Qwen/Qwen1.5-0.5B",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    max_seq_len=32768,
    qkv_bias=True,
    rope_theta=1000000.0,
    activation="swiglu",
)
