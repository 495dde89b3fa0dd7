"""Feed-forward block: SwiGLU (the GELU MLP joins with ROADMAP.md A16)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.init import dense_init


def swiglu_init(d_model: int, d_ff: int, *, generator, device) -> dict:
    return {
        "w_gate": dense_init((d_model, d_ff), generator=generator,
                             device=device),
        "w_up": dense_init((d_model, d_ff), generator=generator,
                           device=device),
        "w_down": dense_init((d_ff, d_model), generator=generator,
                             device=device),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, params["w_gate"].to(x.dtype))
    u = torch.matmul(x, params["w_up"].to(x.dtype))
    return torch.matmul(F.silu(g) * u, params["w_down"].to(x.dtype))
