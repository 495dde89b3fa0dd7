"""Plain PyTorch versions of the port's kernels — the ground truth.

Each is the mathematically direct expression, fp32 math, no tiling, so
it can be audited against the equations.  The CPU path of ``ops.py``
runs them; ``chip_smoke.py`` holds each CUDA kernel against its plain
version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import topk_keep_mask


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
