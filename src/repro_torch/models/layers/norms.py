"""RMSNorm (functional, param-dict style, as the reference's)."""
from __future__ import annotations

import torch


def rmsnorm_init(dim: int, *, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, cast back to the input dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * (var + eps) ** -0.5
    return (y * params["scale"]).to(x.dtype)
