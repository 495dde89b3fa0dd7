"""qwen2-vl-7b — VLM backbone with M-RoPE and dynamic resolution.

[arXiv:2409.12191] Qwen2-VL. 28 layers, d_model 3584, 28 heads (GQA kv=4),
d_ff 18944, vocab 152064. The ViT frontend is a stub:
callers provide precomputed patch embeddings; the language
backbone, M-RoPE (temporal/height/width rotary sections) and token/patch
interleaving are implemented for real.
"""
from repro_torch.configs.base import VLM, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    kind=VLM,
    citation="arXiv:2409.12191",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    max_seq_len=32768,
    rope_theta=1000000.0,
    qkv_bias=True,
    use_mrope=True,
    mrope_sections=(16, 24, 24),   # temporal / height / width halves of hd/2
    frontend_embed_dim=3584,       # projector output == d_model (stubbed ViT)
    activation="swiglu",
)
