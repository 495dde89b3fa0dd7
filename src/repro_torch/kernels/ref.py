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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale=None) -> torch.Tensor:
    """q (B,H,S,D), k/v (B,Hkv,S,D) -> (B,H,S,D) in q's dtype.

    Materialized fp32 softmax over the (S, S) scores; GQA by index (query
    head h reads kv head ``h // (H/Hkv)``, no repeat); the mask is causal
    ``k <= q``, sliding-window ``k > q - window``, or full.  Masked
    scores are ``NEG_INF`` before the softmax, as in the reference's
    ``ref.flash_attention_ref``.
    """
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qf = q.to(torch.float32).reshape(b, hkv, h // hkv, s, d)
    scores = torch.einsum("bgrqd,bgkd->bgrqk", qf,
                          k.to(torch.float32)) * scale
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", probs, v.to(torch.float32))
    return out.reshape(b, h, s, d).to(q.dtype)


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
