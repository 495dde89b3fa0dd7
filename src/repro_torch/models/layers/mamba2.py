"""Mamba-2 block: SSD (state-space duality) with a chunked scan.

[arXiv:2405.21060]  The selective SSM
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t        (per head, state N)
    y_t = C_t^T h_t + D x_t
evaluated chunk by chunk over the full sequence through ``ops.ssd_scan``
(kernel B6 on the card, the reference's jnp ``ssd_chunked`` in its plain
version), and as the O(1) recurrent step for decode on a persistent
(conv_state, ssm_state) pair.  ngroups = 1: B and C are shared across
heads.  The port of the reference's ``models/layers/mamba2.py``.
"""
from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models.layers.init import dense_init
from repro_torch.models.layers.norms import rmsnorm, rmsnorm_init


def mamba2_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.state_dim
    return d_inner, nheads, conv_ch


# float32 log(1e-3) and log(1e-1), the bounds of the reference's dt draw
_LOG_DT_MIN, _LOG_DT_MAX = float(np.log(np.float32(1e-3))), \
    float(np.log(np.float32(1e-1)))


def mamba2_init(key, cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_ch = mamba2_dims(cfg)
    # in_proj packs [z, x, B, C, dt]
    proj_out = 2 * d_in + 2 * s.state_dim + nh
    ks = prng.split(key, 4)
    device = key.device
    dt = torch.exp(prng.uniform(ks[2], (nh,), _LOG_DT_MIN, _LOG_DT_MAX))
    return {
        "in_proj": dense_init(ks[0], (d, proj_out)),
        "conv_w": dense_init(ks[1], (s.conv_width, conv_ch), scale=1.0),
        "conv_b": torch.zeros((conv_ch,), dtype=torch.float32,
                              device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        # inverse softplus of dt
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm": rmsnorm_init(d_in, device=device),
        "out_proj": dense_init(ks[3], (d_in, d)),
    }


def _split_proj(cfg, proj):
    s = cfg.ssm
    d_in, nh, _ = mamba2_dims(cfg)
    n = s.state_dim
    return torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B,S,C), w (W,C)."""
    width = w.shape[0]
    # zeros before the sequence: F.pad's values, by a concatenation,
    # which DTensor places on a 2-D mesh in every torch the port runs on
    xp = torch.cat([x.new_zeros((x.shape[0], width - 1, x.shape[2])), x],
                   dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width))
    return out + b


def mamba2_apply(params, cfg, x, *, conv_state=None, ssm_state=None):
    """Full-sequence SSD.  x (B,S,D) -> (y (B,S,D), (conv_state,
    ssm_state)).  ``ssm_state`` (B,H,P,N), a continued sequence's carried
    state, is B6's ``h0`` (``None``: zero), and the returned state carries
    its decay.  ``conv_state`` is accepted and not read: the conv starts
    from zeros, as in the reference's ``mamba2_apply``."""
    del conv_state  # the reference accepts it and never reads it
    s_cfg = cfg.ssm
    d_in, nh, conv_ch = mamba2_dims(cfg)
    bsz, slen, _ = x.shape
    proj = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xs, b, c, dt = _split_proj(cfg, proj)

    conv_in = torch.cat([xs, b, c], dim=-1)
    conv_out = _causal_conv(conv_in.to(torch.float32), params["conv_w"],
                            params["conv_b"])
    conv_out = F.silu(conv_out).to(x.dtype)
    xs, b, c = torch.split(conv_out, [d_in, s_cfg.state_dim,
                                      s_cfg.state_dim], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    xh = xs.reshape(bsz, slen, nh, s_cfg.head_dim)
    chunk = min(s_cfg.chunk_size, slen)
    if slen % chunk:                      # pad to a chunk multiple
        pad = chunk - slen % chunk
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    y, h_last = ops.ssd_scan(xh, dt, a, b, c, chunk=chunk, h0=ssm_state)
    y = y[:, :slen]

    y = y + params["D"][None, None, :, None] * xs.reshape(
        bsz, slen, nh, s_cfg.head_dim)
    y = y.reshape(bsz, slen, d_in)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    # y is fp32 here even for bf16 x (``D * xs`` promotes, as in JAX):
    # the bf16-rounded weight meets it in an fp32 product, as jnp.einsum
    # promotes it
    w = params["out_proj"].to(x.dtype)
    out = torch.matmul(y, w.to(y.dtype))

    tail = s_cfg.conv_width - 1
    if tail > 0:
        ci = conv_in.to(torch.float32)
        if slen < tail:   # short sequence: left-pad with zeros
            ci = F.pad(ci, (0, 0, tail - slen, 0))
        new_conv_state = ci[:, -tail:, :]
    else:
        new_conv_state = torch.zeros((bsz, 0, conv_ch), dtype=torch.float32,
                                     device=x.device)
    return out, (new_conv_state, h_last)


def mamba2_decode(params, cfg, x, *, conv_state, ssm_state):
    """O(1) recurrent decode step.  x (B,1,D); conv_state (B, conv_width-1,
    conv_ch) fp32; ssm_state (B,H,P,N) fp32.  Returns new states."""
    s_cfg = cfg.ssm
    d_in, nh, conv_ch = mamba2_dims(cfg)
    bsz = x.shape[0]
    proj = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xs, b, c, dt = _split_proj(cfg, proj)

    conv_in = torch.cat([xs, b, c], dim=-1).to(torch.float32)
    window = torch.cat([conv_state, conv_in], dim=1)     # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window, params["conv_w"]) \
        + params["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :].to(x.dtype)
    xs, b, c = torch.split(conv_out, [d_in, s_cfg.state_dim,
                                      s_cfg.state_dim], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])[:, 0]
    a = -torch.exp(params["A_log"])
    xh = xs.reshape(bsz, nh, s_cfg.head_dim).to(torch.float32)
    bv = b[:, 0].to(torch.float32)                        # (B,N)
    cv = c[:, 0].to(torch.float32)
    decay = torch.exp(dt * a)                             # (B,H)
    new_state = ssm_state * decay[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * bv[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", cv, new_state) \
        + params["D"][None, :, None] * xh
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"].to(x.dtype))
    return out, (window[:, 1:, :], new_state)
