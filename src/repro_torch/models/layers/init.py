"""Weight initializers (fan-in scaled normal, fp32 master params).

Both draw from a threefry key (``core/prng.py``) on the key's device,
the reference's values: ``dense_init`` bitwise up to the few-ulp
rounding of ``erfinv``, ``embed_init`` likewise."""
from __future__ import annotations

import torch

from repro_torch.core import prng


def dense_init(key: torch.Tensor, shape, scale: float = 1.0
               ) -> torch.Tensor:
    """Truncated-normal fan-in init, as the reference's ``dense_init``: a
    standard normal truncated at ±2, scaled by ``scale / sqrt(fan_in)``."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale * (fan_in ** -0.5)
    return std * prng.truncated_normal(key, -2.0, 2.0, shape)


def embed_init(key: torch.Tensor, shape, scale: float = 1.0
               ) -> torch.Tensor:
    """``scale`` times a standard normal (the reference's ``embed_init``)."""
    return scale * prng.normal(key, shape)
