"""hymba-1.5b — hybrid-head model: parallel attention + mamba heads.

[arXiv:2411.13676] Hymba. 32 layers, d_model 1600, 25 heads (GQA kv=5),
d_ff 5504, ssm_state 16. Attention and SSM heads process the same input in
parallel within each block and their (normalized) outputs are mean-fused.
The reference models the sub-quadratic sliding-window path (window 1024).
"""
from repro_torch.configs.base import HYBRID, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    kind=HYBRID,
    citation="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    max_seq_len=8192,
    hybrid_attn=True,
    sliding_window=1024,
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, chunk_size=256),
    activation="swiglu",
)
