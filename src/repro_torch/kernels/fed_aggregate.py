"""Kernel B2: the Eq. (2) weighted sum, in CUDA for Hopper.

Port of the TPU kernel ``fed_weighted_sum_pallas``
(``repro/kernels/fed_aggregate.py``); the source, with the note on what
bounds it on the card, is ``csrc/fed_aggregate.cu``.  Model and service
code call ``ops.fed_weighted_sum`` / ``ops.fed_weighted_combine``, which
route a CUDA tensor here and a CPU tensor to ``ref.fed_weighted_sum_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (``chip_smoke.py`` zeroes it
# before the service's main path and reads it after)
launches = 0

# the per-block shared-memory copy of the weights: K floats
MAX_ROWS = 8192

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("fed_aggregate").fed_weighted_sum
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fed_weighted_sum_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_k where(w_k > 0, w_k x_k, 0)`` over a contiguous ``(K, D)``
    fp32 or bf16 CUDA tensor -> ``(D,)`` fp32; ``w`` is ``(K,)`` fp32 on
    the same device.  K = 0 returns zeros without a launch."""
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"fed_weighted_sum_cuda needs x and w on one CUDA "
                         f"device, got {x.device} and {w.device}")
    if x.dim() != 2 or w.shape != (x.shape[0],):
        raise ValueError(f"fed_weighted_sum_cuda needs x (K, D) and w (K,), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or w.dtype != torch.float32:
        raise ValueError(f"fed_weighted_sum_cuda takes fp32/bf16 x and fp32 "
                         f"w, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fed_weighted_sum_cuda needs contiguous x and w")
    k, d = x.shape
    if k > MAX_ROWS:
        raise ValueError(f"fed_weighted_sum_cuda takes at most {MAX_ROWS} "
                         f"rows, got {k}")
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    if k == 0 or d == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), k, d,
                        int(x.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"fed_weighted_sum kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
