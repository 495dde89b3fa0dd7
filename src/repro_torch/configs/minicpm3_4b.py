"""minicpm3-4b — dense with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B] 62 layers, d_model 2560, 40 heads, d_ff 6400,
vocab 73448. MLA compresses KV into a low-rank latent (kv_lora_rank 256)
plus a decoupled RoPE key — the KV cache stores only the latent + rope key,
which shrinks both the decode cache and the federated gradient volume.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    kind=DENSE,
    citation="hf:openbmb/MiniCPM3-4B",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    max_seq_len=32768,
    use_mla=True,
    mla_kv_lora_rank=256,
    mla_q_lora_rank=768,
    mla_rope_head_dim=32,
    rope_theta=10000.0,
    activation="swiglu",
)
