"""Feed-forward blocks: SwiGLU (llama family) and the GELU MLP with
biases (hubert)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models.layers.init import dense_init


def swiglu_init(key, d_model: int, d_ff: int) -> dict:
    k1, k2, k3 = prng.split(key, 3)
    return {
        "w_gate": dense_init(k1, (d_model, d_ff)),
        "w_up": dense_init(k2, (d_model, d_ff)),
        "w_down": dense_init(k3, (d_ff, d_model)),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, params["w_gate"].to(x.dtype))
    u = torch.matmul(x, params["w_up"].to(x.dtype))
    return torch.matmul(F.silu(g) * u, params["w_down"].to(x.dtype))


def gelu_mlp_init(key, d_model: int, d_ff: int) -> dict:
    k1, k2 = prng.split(key)
    dev = key.device
    return {
        "w_up": dense_init(k1, (d_model, d_ff)),
        "b_up": torch.zeros((d_ff,), dtype=torch.float32, device=dev),
        "w_down": dense_init(k2, (d_ff, d_model)),
        "b_down": torch.zeros((d_model,), dtype=torch.float32, device=dev),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation, so is this."""
    h = torch.matmul(x, params["w_up"].to(x.dtype))
    h = F.gelu(h + params["b_up"].to(x.dtype), approximate="tanh")
    y = torch.matmul(h, params["w_down"].to(x.dtype))
    return y + params["b_down"].to(x.dtype)
