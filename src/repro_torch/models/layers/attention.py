"""Attention layers: GQA (llama/qwen family, with qwen's q/k/v biases)
and MLA (minicpm3's multi-head latent attention), the reference's
``models/layers/attention.py``.

Two execution modes, driven by the caller:
  * full sequence (prefill / forward): causal, sliding-window-causal or
    bidirectional masks, through ``ops.flash_attention`` (kernel B5 on
    the card) in place of the reference's jnp core ``chunked_attention``;
    MLA's prefill folds the decoupled rope channels into the query/key
    head dim and hands B5 a value head dim of its own;
  * one-token decode against a KV cache: a full-length cache, or a
    ring-buffer cache of ``sliding_window`` slots, scored by the
    materialized ``_sdpa`` (no Pallas kernel in the reference either);
    MLA's cache holds the compressed latent and the shared rope key,
    expanded per step (``mla_decode``) or scored in the latent
    (``mla_decode_absorbed``, ``cfg.mla_absorb``).

All attention math accumulates in fp32 and casts back to the activation
dtype.  Shapes: x (B, S, D); q (B, S, Hq, hd); k/v (B, S, Hkv, hd).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models.layers.init import dense_init
from repro_torch.models.layers.norms import rmsnorm, rmsnorm_init
from repro_torch.models.layers.rope import apply_rope
from repro_torch.parallel.sharding import constrain_batch, constrain_heads

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


def _valid_slots(cfg, cache_len: int, pos: int, device) -> torch.Tensor:
    """(C,) bool: the cache slots a decode step at ``pos`` may read."""
    idx = torch.arange(cache_len, device=device)
    if cfg.sliding_window > 0:
        # ring buffer: entry i holds position p with p % C == i and
        # pos - C < p <= pos (torch's % is a floor-mod, as JAX's)
        slot = pos % cache_len
        orig = pos - torch.remainder(slot - idx, cache_len)
        return (orig >= 0) & (orig <= pos) \
            & (orig > pos - cfg.sliding_window)
    return idx <= pos


def gqa_init(key, cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    ks = prng.split(key, 4)
    p = {
        "wq": dense_init(ks[0], (d, nq * hd)),
        "wk": dense_init(ks[1], (d, nkv * hd)),
        "wv": dense_init(ks[2], (d, nkv * hd)),
        "wo": dense_init(ks[3], (nq * hd, d)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((n * hd,), dtype=torch.float32,
                                  device=key.device)
    return p


def _project_qkv(params, cfg, x):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(x, params["wq"].to(x.dtype))
    k = torch.matmul(x, params["wk"].to(x.dtype))
    v = torch.matmul(x, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return (q.reshape(b, s, cfg.num_heads, hd),
            k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd))


def gqa_full(params, cfg, x, angles, *, positions=None, causal: bool = True):
    """Prefill / forward attention over the full sequence at the tokens'
    ``positions`` (B, S) (``None``: the implicit ``arange(S)``), which the
    mask compares: a key at a negative position (a left pad) is never
    attended.  The rotary ``angles`` come with the caller.  Returns (out,
    (k, v)) — prefill builds the cache from k, v."""
    q, k, v = _project_qkv(params, cfg, x)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    out = ops.flash_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window,
                              scale=cfg.resolved_head_dim ** -0.5,
                              q_pos=positions, k_pos=positions)
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
    valid = _valid_slots(cfg, cache_len, pos, x.device)
    mask = valid[None, None, :].expand(b, 1, cache_len)
    out = _sdpa(q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask,
                cfg.resolved_head_dim ** -0.5)
    out = torch.matmul(out.reshape(b, 1, -1), params["wo"].to(x.dtype))
    return out, (cache_k, cache_v)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (minicpm3-4b / deepseek-v2 style)
# ---------------------------------------------------------------------------
def mla_init(key, cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq = cfg.num_heads
    qr, kr, rr = (cfg.mla_q_lora_rank, cfg.mla_kv_lora_rank,
                  cfg.mla_rope_head_dim)
    ks = prng.split(key, 7)
    return {
        "w_dq": dense_init(ks[0], (d, qr)),
        "q_norm": rmsnorm_init(qr, device=key.device),
        "w_uq": dense_init(ks[1], (qr, nq * (hd + rr))),
        "w_dkv": dense_init(ks[2], (d, kr)),
        "kv_norm": rmsnorm_init(kr, device=key.device),
        "w_kr": dense_init(ks[3], (d, rr)),
        "w_ukv": dense_init(ks[4], (kr, nq * 2 * hd)),
        "wo": dense_init(ks[5], (nq * hd, d)),
    }


def _mla_q(params, cfg, x, angles):
    b, s, _ = x.shape
    nq, hd, rr = cfg.num_heads, cfg.resolved_head_dim, cfg.mla_rope_head_dim
    cq = rmsnorm(params["q_norm"], torch.matmul(x, params["w_dq"].to(x.dtype)),
                 cfg.norm_eps)
    q = torch.matmul(cq, params["w_uq"].to(x.dtype)).reshape(b, s, nq,
                                                             hd + rr)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    if angles is not None:
        q_rope = apply_rope(q_rope, angles[..., :rr // 2])
    return q_nope, q_rope


def _mla_kv_latent(params, cfg, x, angles):
    ckv = torch.matmul(x, params["w_dkv"].to(x.dtype))
    kr = torch.matmul(x, params["w_kr"].to(x.dtype))
    if angles is not None:
        kr = apply_rope(kr[:, :, None, :],
                        angles[..., :cfg.mla_rope_head_dim // 2])[:, :, 0, :]
    return ckv, kr


def _mla_expand_kv(params, cfg, ckv):
    b, s, _ = ckv.shape
    nq, hd = cfg.num_heads, cfg.resolved_head_dim
    c = rmsnorm(params["kv_norm"], ckv, cfg.norm_eps)
    kv = torch.matmul(c, params["w_ukv"].to(ckv.dtype)).reshape(b, s, nq,
                                                                2 * hd)
    return kv[..., :hd], kv[..., hd:]


def _mla_attend(params, cfg, q_nope, q_rope, k_nope, k_rope, v, mask):
    scale = (cfg.resolved_head_dim + cfg.mla_rope_head_dim) ** -0.5
    f32 = torch.float32
    s_nope = torch.einsum("bqhd,bkhd->bhqk", q_nope.to(f32), k_nope.to(f32))
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.to(f32), k_rope.to(f32))
    scores = torch.where(mask[:, None, :, :], (s_nope + s_rope) * scale,
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(f32))
    b, sq = out.shape[0], out.shape[1]
    out = out.reshape(b, sq, -1).to(q_nope.dtype)
    return torch.matmul(out, params["wo"].to(q_nope.dtype))


def mla_full(params, cfg, x, angles, *, positions=None, causal: bool = True):
    """Prefill / forward MLA over the full sequence at the tokens'
    ``positions`` (B, S) (``None``: ``arange(S)``), as
    :func:`gqa_full`'s mask compares them.  The decoupled rope
    channels join the query/key head dim (q_cat = [q_nope, q_rope], k_cat
    = [k_nope, the shared rope key on every head]), so one B5 call scores
    q_nope.k_nope + q_rope.k_rope, with v at its own head dim.  Returns
    (out, (ckv, kr)), the latent cache entry; under ``cfg.mla_absorb`` the
    latent is normalized at write time, as the absorbed decode reads it."""
    q_nope, q_rope = _mla_q(params, cfg, x, angles)
    ckv, kr = _mla_kv_latent(params, cfg, x, angles)
    k_nope, v = _mla_expand_kv(params, cfg, ckv)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    kr_b = kr[:, :, None, :].expand(kr.shape[:2] + (cfg.num_heads,
                                                    kr.shape[-1]))
    k_cat = torch.cat([k_nope, kr_b], dim=-1)
    scale = (cfg.resolved_head_dim + cfg.mla_rope_head_dim) ** -0.5
    out = ops.flash_attention(q_cat, k_cat, v, causal=causal,
                              window=cfg.sliding_window, scale=scale,
                              q_pos=positions, k_pos=positions)
    out = out.reshape(x.shape[0], x.shape[1], -1)
    out = torch.matmul(out, params["wo"].to(x.dtype))
    if cfg.mla_absorb:
        ckv = rmsnorm(params["kv_norm"], ckv, cfg.norm_eps)
    return out, (ckv, kr)


def _mla_write(cfg, x, ckv_new, kr_new, cache_ckv, cache_kr, pos: int):
    """Writes the step's latent and rope key into slot ``pos`` (``pos %
    C`` for a ring) of the caches, in place; returns the slot mask."""
    cache_len = cache_ckv.shape[1]
    slot = pos % cache_len if cfg.sliding_window > 0 else pos
    cache_ckv[:, slot] = ckv_new[:, 0].to(cache_ckv.dtype)
    cache_kr[:, slot] = kr_new[:, 0].to(cache_kr.dtype)
    return _valid_slots(cfg, cache_len, pos, x.device)


def mla_decode(params, cfg, x, angles, *, cache_ckv, cache_kr, pos: int):
    """One-token MLA decode: the cache holds the compressed latent
    (B, C, kv_lora_rank) and the shared rope key (B, C, rope_dim), both
    written in place; the whole cache's K/V is expanded each step."""
    b = x.shape[0]
    q_nope, q_rope = _mla_q(params, cfg, x, angles)
    ckv_new, kr_new = _mla_kv_latent(params, cfg, x, angles)
    valid = _mla_write(cfg, x, ckv_new, kr_new, cache_ckv, cache_kr, pos)
    k_nope, v = _mla_expand_kv(params, cfg, cache_ckv.to(x.dtype))
    mask = valid[None, None, :].expand(b, 1, cache_ckv.shape[1])
    out = _mla_attend(params, cfg, q_nope, q_rope, k_nope,
                      cache_kr.to(x.dtype), v, mask)
    return out, (cache_ckv, cache_kr)


def mla_decode_absorbed(params, cfg, x, angles, *, cache_ckv, cache_kr,
                        pos: int):
    """MLA decode with weight absorption (DeepSeek-V2's serving trick):
    equal to :func:`mla_decode` up to rounding, reassociated so that the
    queries are mapped into the latent (``q_nope W_uk^T``) and the output
    combined there and expanded once (``(p c_kv) W_uv``); the cache's K/V
    is never expanded.  The cache holds the latent normalized at write
    time (``mla_full`` under ``cfg.mla_absorb``, and the write here).
    The products accumulate in fp32 from the activation dtype's operands,
    as the reference's ``preferred_element_type=float32``, under its
    sharding constraints (``parallel.sharding.constrain_batch`` /
    ``constrain_heads``: the identity off-mesh)."""
    b = x.shape[0]
    nq, hd = cfg.num_heads, cfg.resolved_head_dim
    kr = cfg.mla_kv_lora_rank
    f32 = torch.float32
    q_nope, q_rope = _mla_q(params, cfg, x, angles)      # (B,1,H,hd)
    ckv_new, kr_new = _mla_kv_latent(params, cfg, x, angles)
    ckv_new = rmsnorm(params["kv_norm"], ckv_new, cfg.norm_eps)
    # the per-step latent comes r-sharded from w_dkv's sharding: gather the
    # new entry rather than reshard the cache at the write
    ckv_new, kr_new = constrain_batch(ckv_new), constrain_batch(kr_new)
    valid = _mla_write(cfg, x, ckv_new, kr_new, cache_ckv, cache_kr, pos)

    w_ukv = params["w_ukv"].to(x.dtype).reshape(kr, nq, 2 * hd)
    w_k, w_v = w_ukv[..., :hd], w_ukv[..., hd:]          # (kr, H, hd)
    c_n = cache_ckv                                      # (B, C, kr)
    q_eff = constrain_heads(
        torch.einsum("bqhd,rhd->bqhr", q_nope.to(f32), w_k.to(f32)), 2)
    s_nope = constrain_heads(
        torch.einsum("bqhr,bkr->bhqk", q_eff.to(x.dtype).to(f32),
                     c_n.to(f32)), 1)
    s_rope = constrain_heads(
        torch.einsum("bqhd,bkd->bhqk", q_rope.to(f32), cache_kr.to(f32)), 1)
    scale = (hd + cfg.mla_rope_head_dim) ** -0.5
    scores = torch.where(valid[None, None, None, :],
                         (s_nope + s_rope) * scale, NEG_INF)
    probs = torch.softmax(scores, dim=-1)                # (B,H,1,C)
    o_lat = constrain_heads(
        torch.einsum("bhqk,bkr->bqhr", probs.to(x.dtype).to(f32),
                     c_n.to(f32)), 2)
    out = constrain_heads(
        torch.einsum("bqhr,rhd->bqhd", o_lat.to(x.dtype).to(f32),
                     w_v.to(f32)), 2)
    out = out.reshape(b, 1, nq * hd).to(x.dtype)
    out = torch.matmul(out, params["wo"].to(x.dtype))
    return out, (cache_ckv, cache_kr)
