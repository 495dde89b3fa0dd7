"""Plain PyTorch versions of the port's kernels — the ground truth.

Each is the mathematically direct expression, fp32 math, no tiling, so
it can be audited against the equations.  The CPU path of ``ops.py``
runs them; ``chip_smoke.py`` holds each CUDA kernel against its plain
version on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.aggregation import topk_keep_mask

NEG_INF = -1e30


def fed_weighted_sum_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Eq. (2) numerator ``sum_k where(w_k > 0, w_k * x_k, 0)`` over a
    stacked ``(K, ...)`` leaf -> ``(...)`` fp32.

    Zero-weight rows are masked OUT before the multiply — a free or
    padded slot may hold stale or non-finite payload and ``0 * nan`` is
    nan — and bf16 rows are upcast and summed in fp32.  Dividing by
    ``max(sum w, 1e-12)`` gives the reference's ``fed_combine_ref``.
    """
    wb = w.to(torch.float32).reshape((-1,) + (1,) * (x.dim() - 1))
    contrib = torch.where(wb > 0.0, x.to(torch.float32),
                          torch.zeros((), dtype=torch.float32,
                                      device=x.device))
    return torch.sum(wb * contrib, dim=0)


def topic_decoder_ref(theta, beta, bow, dec_scale=None) -> torch.Tensor:
    """ProdLDA reconstruction term, materialized:
        recon_d = -sum_v bow_dv * log softmax_v(theta_d . beta_v * scale_v)
    theta (B,K), beta (K,V), bow (B,V) -> (B,) fp32.
    """
    logits = theta.to(torch.float32) @ beta.to(torch.float32)
    if dec_scale is not None:
        logits = logits * dec_scale.to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(bow.to(torch.float32) * logp, dim=-1)


def fed_topk_ef_ref(msgs: torch.Tensor, err_rows: torch.Tensor,
                    k_keep: int):
    """Top-k with error feedback over a ``(K, D)`` cohort, per row:
    ``corrected = msg + err``; ``sent`` keeps EXACTLY ``k_keep`` entries
    of ``|corrected|`` (bf16-rounded ranking, lower-index ties:
    ``aggregation.topk_keep_mask``); ``new_err = corrected - sent``.
    ``err_rows`` are the cohort's rows of the error memory, already
    gathered.  Returns ``(sent, new_err)``, both ``(K, D)`` fp32."""
    corrected = msgs.to(torch.float32) + err_rows.to(torch.float32)
    mask = topk_keep_mask(torch.abs(corrected), k_keep)
    sent = torch.where(mask, corrected,
                       torch.zeros((), dtype=torch.float32,
                                   device=corrected.device))
    return sent, corrected - sent


def fed_dp_secure_apply_ref(msgs: torch.Tensor, noise=None, masks=None,
                            clip_coef=None, weights=None,
                            noise_scale: float = 0.0) -> torch.Tensor:
    """dp-noise + secure-mask application over a ``(K, D)`` cohort:

        out = msg * clip_coef + noise_scale * noise + mask / max(w, 1e-9)

    each term present only when its operand is given, evaluated as
    separate roundings in this order (``dp`` passes noise and clip_coef,
    ``secure`` passes masks and weights)."""
    out = msgs.to(torch.float32)
    rows = (-1,) + (1,) * (out.dim() - 1)
    if clip_coef is not None:
        out = out * clip_coef.to(torch.float32).reshape(rows)
    if noise is not None:
        out = out + noise_scale * noise.to(torch.float32)
    if masks is not None:
        w = torch.clamp(weights.to(torch.float32), min=1e-9)
        out = out + masks.to(torch.float32) / w.reshape(rows)
    return out


def _attention_mask(q_pos, k_pos, causal: bool, window: int):
    """(Sq,) x (Sk,) positions -> (Sq, Sk) bool: True = may attend."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def _softmax_attention(q, k, v, causal: bool, window: int, scale):
    """q (B,S,H,D), k/v (B,S,Hkv,D) -> (out (B,S,H,D) in q's dtype, the
    masked fp32 scores (B,Hkv,H/Hkv,S,S)).

    Materialized fp32 softmax over the (S, S) scores; GQA by index (query
    head h reads kv head ``h // (H/Hkv)``, no repeat); the mask is causal
    ``k <= q``, sliding-window ``k > q - window``, or full.  Masked
    scores are ``NEG_INF`` before the softmax, as in the reference's
    ``ref.flash_attention_ref``.  Heads-major inside, so that both
    products are batched GEMMs."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qf = q.transpose(1, 2).to(torch.float32).reshape(b, hkv, h // hkv, s, d)
    scores = torch.einsum("bgrqd,bgkd->bgrqk", qf,
                          k.transpose(1, 2).to(torch.float32)) * scale
    pos = torch.arange(s, device=q.device)
    scores = torch.where(_attention_mask(pos, pos, causal, window), scores,
                         NEG_INF)
    out = torch.einsum("bgrqk,bgkd->bgrqd", torch.softmax(scores, dim=-1),
                       v.transpose(1, 2).to(torch.float32))
    return out.reshape(b, h, s, d).transpose(1, 2).to(q.dtype), scores


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale=None) -> torch.Tensor:
    """q (B,H,S,D), k/v (B,Hkv,S,D) -> (B,H,S,D) in q's dtype: the
    attention of :func:`_softmax_attention` in the heads-major layout."""
    out, _ = _softmax_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal, window, scale)
    return out.transpose(1, 2)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True,
                            window: int = 0, scale=None):
    """q (B,S,H,D), k/v (B,S,Hkv,D) -> (out (B,S,H,D) in q's dtype, lse
    (B,H,S) fp32): :func:`_softmax_attention` plus the row log-sum-exp
    the backward recomputes from, over the same scores.  The reference's
    ``_flash_fwd_scan`` takes ``lse = m + log(l_safe)`` with ``l_safe =
    1`` where a row is fully masked: a masked score adds exp(NEG_INF - m)
    = 0, and a fully masked row gives NEG_INF + log(S), which is NEG_INF
    in fp32."""
    b, s, h, _ = q.shape
    out, scores = _softmax_attention(q, k, v, causal, window, scale)
    return out, torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: int = 0, scale=None, chunk: int = 512):
    """The reference's ``_flash_vjp_bwd`` (``models/layers/attention.py``)
    line for line, in the kernels' layout: q, out, dout (B,S,H,D), k/v
    (B,S,Hkv,D), lse (B,H,S) -> (dq, dk, dv) in the inputs' dtypes.

    Recomputes ``p = exp(s - lse)`` chunk by chunk over the keys, with
    ``delta = rowsum(dout * out)``, ``ds = p (dp - delta) scale``; GQA by
    index, so dk and dv sum over the ``H/Hkv`` query heads that read each
    kv head.  A fully masked row gives zero gradients."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    f32 = torch.float32
    qf = q.to(f32).reshape(b, s, hkv, g, d)
    d_out = dout.to(f32).reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)
    o = out.to(f32).reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)
    delta = torch.sum(d_out * o, dim=-1)                 # (B,Hkv,g,Sq)
    lse_r = lse.to(f32).reshape(b, hkv, g, s)
    pos = torch.arange(s, device=q.device)
    ck = min(chunk, s)
    dq = torch.zeros((b, s, hkv, g, d), dtype=f32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, s, ck):
        kb = k[:, k0:k0 + ck].to(f32)
        vb = v[:, k0:k0 + ck].to(f32)
        mask = _attention_mask(pos, pos[k0:k0 + ck], causal, window)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb) * scale
        p = torch.where(mask, torch.exp(sc - lse_r[..., None]), 0.0)
        dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p, d_out))
        dp = torch.einsum("bhgqd,bkhd->bhgqk", d_out, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qf))
    return (dq.reshape(b, s, h, d).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q) with out[i,j] = sum_{j<r<=i} a_r (i>=j),
    -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, float("-inf"))


def ssd_scan_ref(x, dt, a, b, c, chunk: int):
    """Mamba-2 SSD chunked scan from a zero state: the reference's
    ``models/layers/mamba2.py:ssd_chunked`` in torch, chunk by chunk.

    x (B,S,H,P), dt (B,S,H), a (H,), b/c (B,S,N) [ngroups=1] -> (y
    (B,S,H,P) in x's dtype, h_last (B,H,P,N) fp32).  Per chunk, with
    ``cum = cumsum(dt*a)``:

        y      = ((C B^T) o exp(segsum(dt a)) o dt_j) X + exp(cum) C h^T
        h_new  = exp(cum_Q) h + (B o dt exp(cum_Q - cum))^T X

    A ragged last chunk is padded with zero steps (dt = 0 leaves the
    state as it is), as the reference's ``mamba2_apply`` pads.
    """
    s = x.shape[1]
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (dt, b, c))
    bs, sp, h, p = x.shape
    n = b.shape[-1]
    nc = sp // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(bs, nc, chunk, h, p)
    dtc = dt.to(f32).reshape(bs, nc, chunk, h)
    bc = b.to(f32).reshape(bs, nc, chunk, n)
    cc = c.to(f32).reshape(bs, nc, chunk, n)
    af = a.to(f32)
    hst = torch.zeros((bs, h, p, n), dtype=f32, device=x.device)
    ys = []
    for i in range(nc):
        xb, dtb, bb, cb = xc[:, i], dtc[:, i], bc[:, i], cc[:, i]
        da = dtb * af                                      # (B,Q,H)
        cum = torch.cumsum(da, dim=1)                      # (B,Q,H)
        decay = torch.exp(_segsum(da.transpose(1, 2)))     # (B,H,Q,Q)
        gram = torch.einsum("bin,bjn->bij", cb, bb)        # (B,Q,Q)
        w = gram[:, None] * decay * dtb.transpose(1, 2)[:, :, None, :]
        y = torch.einsum("bhij,bjhp->bihp", w, xb)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bin,bhpn->bihp", cb, hst)
        to_end = torch.exp(cum[:, -1:, :] - cum) * dtb     # (B,Q,H)
        new_state = torch.einsum("bjn,bjhp->bhpn", bb,
                                 to_end[..., None] * xb)
        hst = torch.exp(cum[:, -1, :])[:, :, None, None] * hst + new_state
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bs, sp, h, p)[:, :s]
    return y.to(x.dtype), hst


def ssd_scan_bwd_ref(x, dt, a, b, c, dy, dh_last, chunk: int):
    """Gradient of :func:`ssd_scan_ref` (the reference's ``ssd_chunked``
    from a zero state, whose own backward is ``jax.grad`` through its
    checkpointed chunk body) by ``torch.func.vjp`` through the plain
    version, which also runs inside ``torch.func`` transforms:
    cotangents ``dy`` (B,S,H,P) of y and ``dh_last`` (B,H,P,N) of h_last
    (``None``: zero) -> (dx, ddt, da, db, dc) in the inputs' dtypes."""
    (y, h_last), vjp = torch.func.vjp(
        lambda *ins: ssd_scan_ref(*ins, chunk), x, dt, a, b, c)
    dh = torch.zeros_like(h_last) if dh_last is None \
        else dh_last.to(h_last.dtype)
    return vjp((dy.to(y.dtype), dh))
