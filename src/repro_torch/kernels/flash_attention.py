"""Kernel B5: flash attention, forward and backward, in CUDA for Hopper.

Port of the TPU kernel ``flash_attention_bhsd``
(``repro/kernels/flash_attention.py``) -> :func:`flash_attention_cuda`
(``csrc/flash_attention.cu``, whose note says what bounds it on the
card), and of the reference's jnp VJP ``_flash_vjp_bwd``
(``repro/models/layers/attention.py``; no Pallas kernel) ->
:func:`flash_attention_bwd_cuda` (``csrc/flash_attention_bwd.cu``).
Model code calls ``ops.flash_attention``, which routes a CUDA tensor
here and a CPU tensor to the plain versions in ``ref.py``.

Two routes, by dtype, in the forward and in the backward alike: bf16
runs on the tensor cores (``wgmma``; the backward in three launches:
dq, dk/dv partials per query head, their sum over each GQA group), fp32
on the CUDA cores in IEEE fp32, which the card-vs-CPU agreement of fp32
models needs (TF32 or bf16 products would not hold its bounds).  A bf16
call the tensor-core kernels cannot take raises; it never goes to the
fp32 kernels or to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# calls that launched the forward / the backward kernels in this process
# (``chip_smoke.py`` zeroes them before the main path and reads them after)
launches = 0
bwd_launches = 0

HEAD_DIMS = (32, 64, 96, 128)

_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        if name == "fwd":
            fn = _build.load("flash_attention").flash_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12 \
                + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p]
        else:
            fn = _build.load("flash_attention_bwd").flash_attention_bwd
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 15 \
                + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Device, dtype, shape and head-dim checks shared by both kernels."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{fn} needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{fn} takes fp32 or bf16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{fn} needs q (B,S,H,D) and k, v "
                         f"(B,S,Hkv,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d \
            or hkv == 0 or h % hkv:
        raise ValueError(f"{fn}: k/v {tuple(k.shape)} do "
                         f"not fit q {tuple(q.shape)} (H a multiple of Hkv)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn} takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{fn} needs a contiguous head dim")
    if b > 65535 or h > 65535:
        raise ValueError(f"{fn} takes B, H <= 65535, got {b}, {h}")


def _check_aligned(fn: str, **operands: torch.Tensor):
    """The tensor-core routes read 16-byte aligned operands whose (b, s,
    h) strides are multiples of 8 elements; raise on any other."""
    for name, t in operands.items():
        if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)):
            raise ValueError(
                f"{fn} on bf16 takes 16-byte aligned operands with (b, s, "
                f"h) strides that are multiples of 8: {name} starts at "
                f"{t.data_ptr() % 16} mod 16 with strides {t.stride()[:3]}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, scale: float,
                         want_lse: bool = False):
    """q (B,S,H,D), k/v (B,S,Hkv,D) CUDA tensors of one dtype (fp32 or
    bf16), read in place through their strides (the head dim must be
    contiguous) -> (B,S,H,D) contiguous in q's dtype, and with
    ``want_lse`` also each row's log-sum-exp (B,H,S) fp32 for the
    backward.  ``window`` 0 means no sliding window.  bf16 operands must
    start on 16 bytes and have (b, s, h) strides that are multiples of 8
    elements."""
    global launches
    _check("flash_attention_cuda", q, k, v)
    dev = q.device
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_attention_cuda", q=q, k=k, v=v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) \
        if want_lse else None
    if b == 0 or s == 0 or h == 0:
        return (out, lse) if want_lse else out
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("fwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), *strides, b, s, h, hkv, d,
                             int(bool(causal)), int(window), float(scale),
                             int(q.dtype == torch.bfloat16),
                             lse.data_ptr() if want_lse else None, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return (out, lse) if want_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, window: int, scale: float):
    """The gradient of :func:`flash_attention_cuda`: q, k, v as the
    forward took them, its ``out`` and ``lse``, and ``dout`` (B,S,H,D) ->
    (dq (B,S,H,D), dk, dv (B,S,Hkv,D)) contiguous in q's dtype, dk and dv
    summed over the query heads of each kv head.  bf16 runs on the tensor
    cores in three launches (dq with each row's ``rowsum(dout * out)``,
    dk and dv as fp32 partials per query head, their sum over each kv
    head's group) and takes operands as the forward's bf16 route does.
    fp32 runs on the CUDA cores in two launches (dq, then dk and
    dv).  No atomics, so repeated calls give the same bits."""
    global bwd_launches
    _check("flash_attention_bwd_cuda", q, k, v)
    dev = q.device
    b, s, h, d = q.shape
    hkv = k.shape[2]
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or out.device != dev \
            or dout.device != dev:
        raise ValueError(f"flash_attention_bwd_cuda: out "
                         f"{tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} must match q "
                         f"{tuple(q.shape)} {q.dtype} on {dev}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or lse.device != dev:
        raise ValueError(f"flash_attention_bwd_cuda: lse must be (B,H,S) "
                         f"fp32 on {dev}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_aligned("flash_attention_bwd_cuda", q=q, k=k, v=v, out=out,
                       dout=dout)
    lse = lse.contiguous()
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, s, hkv, d), dtype=q.dtype, device=dev)
    dv = torch.empty((b, s, hkv, d), dtype=q.dtype, device=dev)
    if b == 0 or s == 0 or h == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    # the bf16 route's dk, dv partials, one per query head
    part = torch.empty((2, b, s, h, d),
                       dtype=torch.float32, device=dev) if bf16 else None
    strides = [t.stride(i) for t in (q, k, v, out, dout) for i in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("bwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                             delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                             dv.data_ptr(), *strides, b, s, h, hkv, d,
                             int(bool(causal)), int(window), float(scale),
                             int(bf16), part.data_ptr() if bf16 else None,
                             stream)
    if err:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv
