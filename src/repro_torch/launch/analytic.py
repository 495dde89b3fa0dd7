"""Analytic FLOP and HBM-traffic model per (architecture x input shape):
the reference's ``launch/analytic.py``, copied so that the port imports
nothing of the reference.  Pure Python over the config, so its numbers
are the reference's exactly (``tests/test_torch_launch_sizing.py``).

The dry run (``launch/dryrun.py``) reads its FLOPs and bytes from here:
a fake-tensor run has no cost model of its own, and the closed form is
exact for the model's own products.

Conventions:
  * 1 multiply-add = 2 FLOPs;
  * attention is the chunked implementation: full (not causal-halved)
    S x S score work;
  * training = forward + backward: FLOPs x3 (standard 2x-forward
    backward), +1x extra attention-core recompute for the flash VJP;
  * traffic model: every major op reads operands and writes results once
    (no fusion credit), params are read once per forward and once per
    backward, gradients written once; activation dtype from cfg.dtype,
    params fp32.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import (AUDIO, HYBRID, MOE, NTM, SSM, VLM,
                                      ModelConfig, ShapeConfig)


@dataclass(frozen=True)
class CostEstimate:
    flops: float          # global FLOPs for one step
    bytes: float          # global modeled HBM bytes (activations etc.)
    param_bytes: float = 0.0   # global param read/write traffic

    def per_device(self, chips: int,
                   param_ways: int | None = None) -> "CostEstimate":
        """param_ways — how many ways parameter traffic actually shards
        (== chips under FSDP; == the model-axis size under TP decode,
        where params are replicated across the data axis)."""
        pw = param_ways or chips
        return CostEstimate(self.flops / chips,
                            self.bytes / chips + self.param_bytes / pw,
                            0.0)


def _act_bytes(cfg) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


# ---------------------------------------------------------------------------
# per-layer forward FLOPs
# ---------------------------------------------------------------------------
def _attn_flops(cfg, t, s_kv, decode=False):
    """GQA/MLA attention forward FLOPs for t query tokens vs s_kv keys."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if cfg.sliding_window:
        s_kv = min(s_kv, cfg.sliding_window)
    if cfg.use_mla:
        qr, kr, rr = (cfg.mla_q_lora_rank, cfg.mla_kv_lora_rank,
                      cfg.mla_rope_head_dim)
        proj = 2 * t * (d * qr + qr * hq * (hd + rr)
                        + d * (kr + rr) + hq * hd * d)
        if decode and cfg.mla_absorb:
            # absorbed: q->latent map + scores/combine in latent space
            absorb = 2 * t * hq * hd * kr * 2
            core = 2 * t * s_kv * hq * (kr + rr + kr)
            return proj + absorb + core
        # unabsorbed: the K/V expansion runs over every cached position
        # (s_kv for decode, the token's own position set for prefill)
        expand_tokens = t * s_kv if decode else t
        expand = 2 * expand_tokens * kr * hq * 2 * hd
        core = 2 * t * s_kv * hq * ((hd + rr) + hd)
        return proj + expand + core
    proj = 2 * t * d * (hq * hd + 2 * hkv * hd) + 2 * t * hq * hd * d
    core = 2 * t * s_kv * hq * hd * 2        # scores + p@v
    return proj + core


def _ffn_flops(cfg, t, moe_layer: bool):
    d, f = cfg.d_model, cfg.d_ff
    if moe_layer:
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        cap_tokens = min(t * k, int(t * k * cfg.moe.capacity_factor))
        flops = 6 * cap_tokens * d * f            # 3 matmuls on dispatched
        flops += 2 * t * d * e                    # router
        flops += 6 * t * d * f * cfg.moe.num_shared_experts
        return flops
    mult = 6 if cfg.activation == "swiglu" else 4
    return mult * t * d * f


def _ssd_flops(cfg, t):
    s_cfg = cfg.ssm
    d = cfg.d_model
    d_in = s_cfg.expand * d
    nh = d_in // s_cfg.head_dim
    n, p, q = s_cfg.state_dim, s_cfg.head_dim, s_cfg.chunk_size
    proj = 2 * t * d * (2 * d_in + 2 * n + nh) + 2 * t * d_in * d
    conv = 2 * t * (d_in + 2 * n) * s_cfg.conv_width
    # SSD core per token: G row (Q x N), W@x (Q x H x P), states, y_off
    core = 2 * t * q * n + 2 * t * q * nh * p \
        + 4 * t * n * nh * p
    return proj + conv + core


def _layer_flops(cfg, t, s_kv, moe_layer: bool, decode=False):
    if cfg.kind == SSM:
        return _ssd_flops(cfg, t)
    fl = _attn_flops(cfg, t, s_kv, decode=decode)
    if cfg.kind == HYBRID:
        fl += _ssd_flops(cfg, t)
    fl += _ffn_flops(cfg, t, moe_layer)
    return fl


def _head_flops(cfg, t):
    return 2 * t * cfg.d_model * cfg.vocab_size


def _layer_param_count(cfg, moe_layer: bool) -> int:
    """Approximate per-layer parameter count (for traffic)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    n = 0
    if cfg.kind != SSM:
        if cfg.use_mla:
            qr, kr, rr = (cfg.mla_q_lora_rank, cfg.mla_kv_lora_rank,
                          cfg.mla_rope_head_dim)
            n += d * qr + qr * hq * (hd + rr) + d * (kr + rr) \
                + kr * hq * 2 * hd + hq * hd * d
        else:
            n += d * (hq + 2 * hkv) * hd + hq * hd * d
        if moe_layer:
            e = cfg.moe.num_experts + cfg.moe.num_shared_experts
            n += 3 * e * d * cfg.d_ff + d * cfg.moe.num_experts
        else:
            mult = 3 if cfg.activation == "swiglu" else 2
            n += mult * d * cfg.d_ff
    if cfg.kind in (SSM, HYBRID):
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        n += d * (2 * d_in + 2 * s.state_dim + nh) + d_in * d \
            + (d_in + 2 * s.state_dim) * s.conv_width
    return n


def estimate(cfg: ModelConfig, shape: ShapeConfig) -> CostEstimate:
    """Global FLOPs + modeled HBM bytes for one step of ``shape``."""
    b = shape.global_batch
    ab = _act_bytes(cfg)
    train = shape.mode == "train"
    if shape.mode in ("train", "prefill"):
        t = b * shape.seq_len
        s_kv = shape.seq_len
    else:
        t = b
        s_kv = shape.seq_len

    per_unit = 2 if (cfg.kind == MOE and cfg.moe.moe_every > 1) else 1
    nu = cfg.num_layers // per_unit

    fwd = 0.0
    params = cfg.vocab_size * cfg.d_model   # embed
    if not cfg.tie_embeddings and not cfg.encoder_only:
        params += cfg.vocab_size * cfg.d_model
    decode = shape.mode == "decode"
    for moe_layer in ([False, True] if per_unit == 2
                      else [cfg.kind == MOE]):
        fwd += nu * _layer_flops(cfg, t, s_kv, moe_layer, decode=decode)
        params += nu * _layer_param_count(cfg, moe_layer)
    fwd += _head_flops(cfg, t)

    if train:
        # backward = 2x forward; flash VJP recomputes the attention core
        attn_core = 0.0
        if cfg.kind not in (SSM, NTM):
            hd = cfg.resolved_head_dim + (cfg.mla_rope_head_dim
                                          if cfg.use_mla else 0)
            skv_eff = min(s_kv, cfg.sliding_window) if cfg.sliding_window \
                else s_kv
            attn_core = cfg.num_layers * 2 * t * skv_eff \
                * cfg.num_heads * hd * 2
        flops = 3 * fwd + attn_core
    else:
        flops = fwd

    # ---- traffic model ---------------------------------------------------
    d = cfg.d_model
    act_flow_per_layer = 12 * t * d * ab     # rough: reads+writes of the
    #   residual stream, norms, qkv/ffn activations (no fusion credit)
    if cfg.kind == MOE:
        act_flow_per_layer += 4 * t * d * ab     # dispatch/combine copies
    attn_traffic = 0.0
    if cfg.kind not in (SSM, NTM) and shape.mode != "decode":
        # kv chunks re-read once per scan step set; acc rw in fp32
        attn_traffic = cfg.num_layers * (4 * t * cfg.num_heads
                                         * cfg.resolved_head_dim * 4)
    cache_bytes = 0.0
    if shape.mode == "decode":
        skv_eff = min(s_kv, cfg.sliding_window) if cfg.sliding_window \
            else s_kv
        if cfg.kind == SSM:
            s_ = cfg.ssm
            d_in = s_.expand * d
            cache_bytes = cfg.num_layers * b * (d_in // s_.head_dim) \
                * s_.head_dim * s_.state_dim * 4 * 2
        elif cfg.use_mla:
            cache_bytes = cfg.num_layers * b * skv_eff \
                * (cfg.mla_kv_lora_rank + cfg.mla_rope_head_dim) * ab
        else:
            cache_bytes = cfg.num_layers * b * skv_eff \
                * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * ab
            if cfg.kind == HYBRID:
                s_ = cfg.ssm
                d_in = s_.expand * d
                cache_bytes += cfg.num_layers * b * (d_in // s_.head_dim) \
                    * s_.head_dim * s_.state_dim * 4 * 2
    param_traffic = params * 4 * (3 if train else 1)   # read fwd+bwd, write grad
    byts = cfg.num_layers * act_flow_per_layer \
        * (3 if train else 1) + attn_traffic + cache_bytes \
        + 2 * t * cfg.vocab_size * 4 * (2 if train else 1)   # logits fp32
    return CostEstimate(float(flops), float(byts), float(param_traffic))
