"""GQA attention: the reference's ``models/layers/attention.py`` subset
the serving slice runs (MLA, the chunked flash VJP and the bias of
qwen-style q/k/v join with ROADMAP.md A16).

Two execution modes, driven by the caller:
  * full sequence (prefill / forward): causal, sliding-window-causal or
    bidirectional masks, through ``ops.flash_attention`` (kernel B5 on
    the card) in place of the reference's jnp core ``chunked_attention``;
  * one-token decode against a KV cache: a full-length cache, or a
    ring-buffer cache of ``sliding_window`` slots, scored by the
    materialized ``_sdpa`` (no Pallas kernel in the reference either).

All attention math accumulates in fp32 and casts back to the activation
dtype.  Shapes: x (B, S, D); q (B, S, Hq, hd); k/v (B, S, Hkv, hd).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models.layers.init import dense_init
from repro_torch.models.layers.rope import apply_rope

NEG_INF = -1e30


def make_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window: int = 0) -> torch.Tensor:
    """Boolean attention mask (..., Sq, Sk): True = may attend."""
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (k_pos[..., None, :] <= q_pos[..., :, None])
    if window:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m


def _sdpa(q, k, v, mask, scale):
    """q (B,Sq,Hq,hd) k/v (B,Sk,Hkv,hd) mask (B,Sq,Sk) -> (B,Sq,Hq,hd).

    Materializes the (Sq, Sk) scores — the decode path (Sq == 1)."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf = q.to(torch.float32).reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                          k.to(torch.float32)) * scale
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def gqa_init(key, cfg) -> dict:
    if cfg.qkv_bias:
        raise NotImplementedError("q/k/v biases are not in the port yet "
                                  "(ROADMAP.md A16)")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    ks = prng.split(key, 4)
    return {
        "wq": dense_init(ks[0], (d, nq * hd)),
        "wk": dense_init(ks[1], (d, nkv * hd)),
        "wv": dense_init(ks[2], (d, nkv * hd)),
        "wo": dense_init(ks[3], (nq * hd, d)),
    }


def _project_qkv(params, cfg, x):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(x, params["wq"].to(x.dtype))
    k = torch.matmul(x, params["wk"].to(x.dtype))
    v = torch.matmul(x, params["wv"].to(x.dtype))
    return (q.reshape(b, s, cfg.num_heads, hd),
            k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd))


def gqa_full(params, cfg, x, angles, *, causal: bool = True):
    """Prefill / forward attention over the full sequence at the
    implicit positions ``arange(S)``.  Returns (out, (k, v)) — prefill
    builds the cache from k, v."""
    q, k, v = _project_qkv(params, cfg, x)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    out = ops.flash_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window,
                              scale=cfg.resolved_head_dim ** -0.5)
    out = out.reshape(x.shape[0], x.shape[1], -1)
    return torch.matmul(out, params["wo"].to(x.dtype)), (k, v)


def gqa_decode(params, cfg, x, angles, *, cache_k, cache_v, pos: int):
    """One-token decode.  x (B,1,D); cache (B, C, Hkv, hd); ``pos`` the
    new token's position (a Python int).

    With ``cfg.sliding_window`` the cache is a ring buffer of C == window
    slots; otherwise C is the capacity and slot ``pos`` is written
    directly.  The new k/v are written INTO ``cache_k``/``cache_v`` (in
    place: the reference returns updated copies; the port saves the copy
    of every layer's cache per token), which are returned.
    """
    b = x.shape[0]
    cache_len = cache_k.shape[1]
    q, k, v = _project_qkv(params, cfg, x)      # (B,1,·,hd)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    slot = pos % cache_len if cfg.sliding_window > 0 else pos
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    idx = torch.arange(cache_len, device=x.device)
    if cfg.sliding_window > 0:
        # ring buffer: entry i holds position p with p % C == i and
        # pos - C < p <= pos (torch's % is a floor-mod, as JAX's)
        orig = pos - torch.remainder(slot - idx, cache_len)
        valid = (orig >= 0) & (orig <= pos) \
            & (orig > pos - cfg.sliding_window)
    else:
        valid = idx <= pos
    mask = valid[None, None, :].expand(b, 1, cache_len)
    out = _sdpa(q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask,
                cfg.resolved_head_dim ** -0.5)
    out = torch.matmul(out.reshape(b, 1, -1), params["wo"].to(x.dtype))
    return out, (cache_k, cache_v)
