"""Public wrappers of the port's kernels, with the device dispatch.

Model and service code import from here, never from the kernel modules.
Dispatch follows the tensor and has no knob: a CUDA tensor launches the
hand-written kernel (built from ``csrc/`` at first use; a build or launch
failure raises), a CPU tensor runs the plain version in ``ref.py``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fed_aggregate import fed_weighted_sum_cuda
from repro_torch.kernels.topic_decoder import topic_decoder_cuda

Stacked = Union[torch.Tensor, Mapping[str, torch.Tensor]]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def _weighted_sum_leaf(leaf: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    if not _on_cuda(leaf):
        return ref.fed_weighted_sum_ref(leaf, c)
    flat = leaf.reshape(leaf.shape[0], -1)
    return fed_weighted_sum_cuda(flat.contiguous(),
                                 c.to(leaf.device).contiguous()
                                 ).reshape(leaf.shape[1:])


def fed_weighted_sum(stacked: Stacked, coefs) -> Stacked:
    """NUMERATOR-only ``sum_k where(c_k > 0, c_k x_k, 0)`` over a stacked
    ``(K, ...)`` tensor, or per leaf over a dict of them — the
    staleness-discounted combine's numerator (the caller divides)."""
    c = torch.as_tensor(coefs, dtype=torch.float32)
    if isinstance(stacked, torch.Tensor):
        return _weighted_sum_leaf(stacked, c)
    return {k: _weighted_sum_leaf(v, c) for k, v in stacked.items()}


def fed_weighted_combine(stacked: Stacked, weights) -> Stacked:
    """Eq. (2): ``sum_k w_k x_k / max(sum w, 1e-12)`` with zero-weight rows
    masked out (tensor or per leaf over a dict of stacked leaves)."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    total = torch.clamp(torch.sum(w), min=1e-12)
    num = fed_weighted_sum(stacked, w)
    if isinstance(num, torch.Tensor):
        return num / total.to(num.device)
    return {k: v / total.to(v.device) for k, v in num.items()}


def topic_decoder_loss(theta, beta, bow,
                       dec_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Fused ProdLDA reconstruction loss, per document (B,)."""
    if not _on_cuda(theta):
        return ref.topic_decoder_ref(theta, beta, bow, dec_scale)
    return topic_decoder_cuda(
        theta.contiguous(), beta.contiguous(), bow.contiguous(),
        None if dec_scale is None else dec_scale.contiguous())
