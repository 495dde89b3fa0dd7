"""Hymba hybrid-head block: parallel attention + mamba (SSD) heads.

[arXiv:2411.13676]  The same normalized input feeds a sliding-window GQA
branch and a Mamba-2 SSD branch in parallel; the two outputs are
normalized, scaled by learned per-channel gains and mean-fused:

    y = 1/2 (beta_a * RMSNorm(attn(x)) + beta_m * RMSNorm(ssm(x)))

Each branch carries its own decode state (ring-buffer KV + recurrent SSM
state).  The port of the reference's ``models/layers/hymba.py``.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import mamba2
from repro_torch.models.layers.norms import rmsnorm, rmsnorm_init


def hymba_init(cfg, *, generator, device) -> dict:
    d = cfg.d_model
    return {
        "attn": attn.gqa_init(cfg, generator=generator, device=device),
        "ssm": mamba2.mamba2_init(cfg, generator=generator, device=device),
        "attn_norm": rmsnorm_init(d, device=device),
        "ssm_norm": rmsnorm_init(d, device=device),
        "beta_attn": torch.ones((d,), dtype=torch.float32, device=device),
        "beta_ssm": torch.ones((d,), dtype=torch.float32, device=device),
    }


def _fuse(params, cfg, a_out, m_out):
    a = rmsnorm(params["attn_norm"], a_out, cfg.norm_eps) \
        * params["beta_attn"].to(a_out.dtype)
    m = rmsnorm(params["ssm_norm"], m_out, cfg.norm_eps) \
        * params["beta_ssm"].to(m_out.dtype)
    return 0.5 * (a + m)


def hymba_full(params, cfg, x, angles):
    a_out, kv = attn.gqa_full(params["attn"], cfg, x, angles, causal=True)
    m_out, m_state = mamba2.mamba2_apply(params["ssm"], cfg, x)
    return _fuse(params, cfg, a_out, m_out), (kv, m_state)


def hymba_decode(params, cfg, x, angles, *, cache_k, cache_v, pos: int,
                 conv_state, ssm_state):
    a_out, (ck, cv) = attn.gqa_decode(
        params["attn"], cfg, x, angles,
        cache_k=cache_k, cache_v=cache_v, pos=pos)
    m_out, (cs, ss) = mamba2.mamba2_decode(
        params["ssm"], cfg, x, conv_state=conv_state, ssm_state=ssm_state)
    return _fuse(params, cfg, a_out, m_out), (ck, cv, cs, ss)
