"""granite-34b — dense llama-arch code model, extreme-GQA (MQA, kv=1).

[arXiv:2405.04324] IBM Granite Code Models. 88 layers, d_model 6144,
48 heads with a single KV head (multi-query attention), d_ff 24576,
vocab 49152.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    kind=DENSE,
    citation="arXiv:2405.04324",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    max_seq_len=8192,
    rope_theta=10000.0,
    activation="swiglu",
    # long_500k runs only through this sliding-window variant (DESIGN.md §7)
    sliding_window=0,
)
