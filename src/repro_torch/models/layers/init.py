"""Weight initializers (fan-in scaled normal, fp32 master params)."""
from __future__ import annotations

import torch


def dense_init(shape, *, generator: torch.Generator, device,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init, as the reference's ``dense_init``.

    The reference truncates a STANDARD normal at ±2 and then scales it by
    ``std``; ``torch.nn.init.trunc_normal_`` takes its bounds ``a``/``b``
    in absolute units, so they are ±2·std here.  The draw runs on the
    CPU generator and is moved afterwards, so a seed gives the same
    weights on every device.
    """
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale * (fan_in ** -0.5)
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2.0 * std,
                                b=2.0 * std, generator=generator)
    return w.to(device)


def embed_init(shape, *, generator: torch.Generator, device,
               scale: float = 1.0) -> torch.Tensor:
    """``scale`` times a standard normal (the reference's ``embed_init``),
    drawn on the CPU generator like :func:`dense_init`."""
    w = torch.randn(shape, dtype=torch.float32, generator=generator)
    return (scale * w).to(device)
