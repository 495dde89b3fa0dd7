"""qwen3-moe-235b-a22b — MoE 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B (family card)] 94 layers, d_model 4096, 64 heads
(GQA kv=4), expert d_ff 1536, vocab 151936, 128 experts top-8, no shared
expert, every layer MoE.
"""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    kind=MOE,
    citation="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    max_seq_len=32768,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, capacity_factor=1.25,
                  num_shared_experts=0, moe_every=1),
    activation="swiglu",
)
