"""Rotary position embeddings (rotate-half convention, as the
reference's ``rope_angles`` / ``apply_rope``; M-RoPE is not ported,
ROADMAP.md A16)."""
from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim//2) in fp32."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32,
                       device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    return positions.to(torch.float32)[..., None] * freqs


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), angles (B, S, D//2) -> same shape and dtype."""
    xf = x.to(torch.float32)
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    cos = torch.cos(angles)[..., None, :]   # (B, S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
