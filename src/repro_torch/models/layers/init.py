"""Weight initializers (fan-in scaled normal, fp32 master params).

Both draw from a threefry key (``core/prng.py``) on the key's device,
the reference's values: ``dense_init`` bitwise up to the few-ulp
rounding of ``erfinv``, ``embed_init`` likewise.

Under :func:`deferred` both return a :class:`Draw` in place of the
tensor: the draw made later, in the dtype the caller picks then, each
chunk of the hash cast as it is written.  ``transformer.init_params``
uses it to draw the weights that serving reads in bf16 straight into
bf16."""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.core import prng

_DEFER = contextvars.ContextVar("defer_draws", default=False)


class Draw:
    """A weight not drawn yet, of shape ``shape``: ``draw(dtype)`` draws
    it, float32 values cast to ``dtype`` (None: float32) chunk by
    chunk."""

    def __init__(self, fn, shape):
        self._fn = fn
        self.shape = tuple(shape)

    def __call__(self, dtype=None) -> torch.Tensor:
        return self._fn(dtype)


@contextlib.contextmanager
def deferred():
    """Within the block, ``dense_init`` and ``embed_init`` return
    :class:`Draw` objects."""
    token = _DEFER.set(True)
    try:
        yield
    finally:
        _DEFER.reset(token)


def _draw_or_defer(fn, shape):
    return Draw(fn, shape) if _DEFER.get() else fn(None)


def dense_init(key: torch.Tensor, shape, scale: float = 1.0):
    """Truncated-normal fan-in init, as the reference's ``dense_init``: a
    standard normal truncated at ±2, scaled by ``scale / sqrt(fan_in)``
    (``fan_in = shape[0]``, so a stack of expert matrices ``(E, d, f)``
    takes ``E``, as the reference's)."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale * (fan_in ** -0.5)
    return _draw_or_defer(lambda dtype: prng.truncated_normal(
        key, -2.0, 2.0, shape, scale=std, dtype=dtype), shape)


def embed_init(key: torch.Tensor, shape, scale: float = 1.0):
    """``scale`` times a standard normal (the reference's ``embed_init``)."""
    return _draw_or_defer(lambda dtype: prng.normal(
        key, shape, scale=scale, dtype=dtype), shape)
