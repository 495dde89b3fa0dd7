"""mamba2-1.3b — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] Mamba-2. 48 layers, d_model 2048, no attention heads,
d_ff 0 (the SSD block subsumes the MLP), vocab 50280, ssm_state 128.
"""
from repro_torch.configs.base import SSM, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    kind=SSM,
    citation="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    max_seq_len=524288,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
    tie_embeddings=True,
)
