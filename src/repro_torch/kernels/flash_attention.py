"""Kernel B5: flash attention forward, in CUDA for Hopper.

Port of the TPU kernel ``flash_attention_bhsd``
(``repro/kernels/flash_attention.py``) -> :func:`flash_attention_cuda`
(``csrc/flash_attention.cu``, whose note says what bounds it on the
card).  Model code calls ``ops.flash_attention``, which routes a CUDA
tensor here and a CPU tensor to ``ref.flash_attention_ref``.

Two routes, by dtype: bf16 runs on the tensor cores (``wgmma``), fp32
on the CUDA cores in IEEE fp32, which the card-vs-CPU agreement of fp32
models needs (TF32 or bf16 products would not hold its bounds).  A bf16
call the tensor-core kernel cannot take raises; it never goes to the
fp32 kernel or to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the kernel in this process (``chip_smoke.py`` zeroes it
# before the main path and reads it after)
launches = 0

HEAD_DIMS = (32, 64, 96, 128)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12 \
            + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int,
                         scale: float) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,Hkv,D) CUDA tensors of one dtype (fp32 or
    bf16), read in place through their strides (the head dim must be
    contiguous) -> (B,S,H,D) contiguous in q's dtype.  ``window`` 0 means
    no sliding window.  bf16 operands must start on 16 bytes and have
    (b, s, h) strides that are multiples of 8 elements."""
    global launches
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes fp32 or bf16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_cuda needs q (B,S,H,D) and k, v "
                         f"(B,S,Hkv,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d \
            or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention_cuda: k/v {tuple(k.shape)} do "
                         f"not fit q {tuple(q.shape)} (H a multiple of Hkv)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs a contiguous head dim")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)):
                raise ValueError(
                    f"flash_attention_cuda on bf16 takes 16-byte aligned "
                    f"operands with (b, s, h) strides that are multiples "
                    f"of 8: {name} starts at {t.data_ptr() % 16} mod 16 "
                    f"with strides {t.stride()[:3]}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash_attention_cuda takes B, H <= 65535, got "
                         f"{b}, {h}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    if b == 0 or s == 0 or h == 0:
        return out
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), *strides, b, s, h, hkv, d,
                        int(bool(causal)), int(window), float(scale),
                        int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
