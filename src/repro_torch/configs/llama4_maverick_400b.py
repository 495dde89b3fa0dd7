"""llama4-maverick-400b-a17b — MoE 128 experts top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E (family card)] 48 layers, d_model 5120,
40 heads (GQA kv=8), d_ff 8192 per expert, vocab 202048, 128 routed experts
top-1 + 1 shared expert, MoE on alternating layers (llama4 interleave).
"""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    kind=MOE,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    max_seq_len=32768,
    rope_theta=500000.0,
    moe=MoEConfig(num_experts=128, top_k=1, capacity_factor=1.25,
                  num_shared_experts=1, moe_every=2),
    activation="swiglu",
)
