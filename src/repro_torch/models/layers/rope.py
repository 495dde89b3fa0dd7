"""Rotary position embeddings (rotate-half convention, as the
reference's ``rope_angles`` / ``apply_rope``) and Qwen2-VL's M-RoPE: the
``head_dim/2`` frequency slots split into three contiguous sections
(temporal, height, width), each rotated by its own position stream.
Text tokens carry equal (t, h, w) positions, so M-RoPE is RoPE on text."""
from __future__ import annotations

from typing import Tuple

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


def mrope_angles(positions_thw: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """positions_thw (3, B, S) -> angles (B, S, head_dim//2) in fp32:
    ``sections`` frequency slots (of head_dim//2) driven by the temporal,
    height and width streams, in that order."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {half}")
    dev = positions_thw.device
    idx = torch.arange(0, half, dtype=torch.float32, device=dev)
    freqs = 1.0 / (theta ** (idx / half))
    section_id = torch.tensor([i for i, n in enumerate(sections)
                               for _ in range(n)], device=dev)
    pos = positions_thw.to(torch.float32)[section_id]   # (half, B, S)
    return pos.permute(1, 2, 0) * freqs


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """(B, S) text positions -> the (3, B, S) M-RoPE streams."""
    return positions[None].expand((3,) + tuple(positions.shape))
