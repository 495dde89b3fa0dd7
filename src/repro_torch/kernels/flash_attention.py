"""Kernel B5: flash attention, forward and backward, in CUDA for Hopper.

Port of the TPU kernel ``flash_attention_bhsd``
(``repro/kernels/flash_attention.py``) -> :func:`flash_attention_cuda`
(``csrc/flash_attention.cu``, whose note says what bounds it on the
card), and of the reference's jnp VJP ``_flash_vjp_bwd``
(``repro/models/layers/attention.py``; no Pallas kernel) ->
:func:`flash_attention_bwd_cuda` (``csrc/flash_attention_bwd.cu``).
Model code calls ``ops.flash_attention``, which routes a CUDA tensor
here and a CPU tensor to the plain versions in ``ref.py``.

Two routes, by dtype, in the forward and in the backward alike, both on
the tensor cores (``wgmma``).  bf16: products of bf16 values (the
backward in three launches: dq, dk/dv partials per query head, their
sum over each GQA group).  fp32: split TF32, each operand carried as
``hi = tf32(x)`` and ``lo = tf32(x - hi)`` and each product taken as
``lo hi + hi lo + hi hi``, three TF32 products summed in fp32 (the
backward in two launches: dq, then dk/dv summed over each GQA group),
which holds fp32 models' card-vs-CPU bounds where one TF32 product would
not: in ``tests/test_torch_kernels.py``'s emulation one TF32 product
misses by 9.1e-4 where the split reads 8.3e-7, and on an H100 the
kernels read 1.4e-6 to 5.7e-6 of each output's max|plain|.  Both read
16-byte aligned operands; a call the kernels cannot take raises: it
never goes to the other route or to the plain version.

Both take explicit positions (B, S) int32 for the queries and the keys
(left-padded prompts: ``arange(S) - pad``): the mask then compares them,
the key tiles a block visits come from the positions' range, and a key
at a negative position is never attended.  Without positions the kernels
run their index-masked instances, compiled apart (a template flag).

Both take a value head dim of its own (MLA's q and k carry the
decoupled rope channels on top of v's): the (DQK, DV) pairs of
:data:`HEAD_DIM_PAIRS`, the same set forward and backward; any other
pair raises before a launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# calls that launched the forward / the backward kernels in this process
# (``chip_smoke.py`` zeroes them before the main path and reads them after)
launches = 0
bwd_launches = 0

# the (q/k head dim, v head dim) pairs the forward and backward kernels
# instantiate: the diagonal, MLA's prefill at minicpm3-4b width (96, 64)
# and at its reduced config (80, 64); 80 is hubert-xlarge's head dim
HEAD_DIM_PAIRS = ((32, 32), (64, 64), (80, 80), (96, 96), (128, 128),
                  (96, 64), (80, 64))

_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        if name == "fwd":
            fn = _build.load("flash_attention").flash_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12 \
                + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int] \
                + [ctypes.c_void_p] * 4
        else:
            fn = _build.load("flash_attention_bwd").flash_attention_bwd
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 15 \
                + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int] \
                + [ctypes.c_void_p] * 4
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
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{fn} needs q (B,S,H,D), k (B,S,Hkv,D) and v "
                         f"(B,S,Hkv,Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d \
            or hkv == 0 or h % hkv:
        raise ValueError(f"{fn}: k/v {tuple(k.shape)} do "
                         f"not fit q {tuple(q.shape)} (H a multiple of Hkv)")
    if (d, v.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"{fn} takes (q/k, v) head dims in "
                         f"{HEAD_DIM_PAIRS}, got {(d, v.shape[3])}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{fn} needs a contiguous head dim")
    if b > 65535 or h > 65535:
        raise ValueError(f"{fn} takes B, H <= 65535, got {b}, {h}")


def _check_aligned(fn: str, **operands: torch.Tensor):
    """Both routes read 16-byte aligned operands whose (b, s, h) strides
    are whole 16-byte chunks (multiples of 8 bf16 or 4 fp32 elements);
    raise on any other."""
    for name, t in operands.items():
        per16 = 16 // t.element_size()
        if t.data_ptr() % 16 or any(t.stride(i) % per16 for i in range(3)):
            raise ValueError(
                f"{fn} on {str(t.dtype).replace('torch.', '')} takes "
                f"16-byte aligned operands with (b, s, h) strides that are "
                f"multiples of {per16}: {name} starts at "
                f"{t.data_ptr() % 16} mod 16 with strides {t.stride()[:3]}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _positions(fn: str, q: torch.Tensor, q_pos, k_pos):
    """The query and key positions as the kernels read them: (B, S) int32
    on q's device, contiguous, or (None, None) for the implicit
    ``arange(S)``; one of the two given and the other None takes
    ``arange(S)`` for the other.  Anything else raises before a launch:
    another dtype, another shape (Sq != Sk among them), another device."""
    if q_pos is None and k_pos is None:
        return None, None
    b, s = q.shape[0], q.shape[1]
    out = []
    for name, pos in (("q_pos", q_pos), ("k_pos", k_pos)):
        if pos is None:
            pos = torch.arange(s, dtype=torch.int32, device=q.device
                               ).expand(b, s)
        if pos.dtype != torch.int32 or tuple(pos.shape) != (b, s) \
                or pos.device != q.device:
            raise ValueError(
                f"{fn} takes {name} as (B, S) = {(b, s)} int32 on "
                f"{q.device} (the queries' and keys' S are one), got "
                f"{tuple(pos.shape)} {pos.dtype} on {pos.device}")
        out.append(pos.contiguous())
    return out[0], out[1]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, scale: float,
                         want_lse: bool = False, q_pos=None, k_pos=None):
    """q (B,S,H,D), k (B,S,Hkv,D), v (B,S,Hkv,Dv) CUDA tensors of one
    dtype (fp32 or bf16), (D, Dv) in :data:`HEAD_DIM_PAIRS`, read in place
    through their strides (the head dim must be contiguous) -> (B,S,H,Dv)
    contiguous in q's dtype, and with
    ``want_lse`` also each row's log-sum-exp (B,H,S) fp32 for the
    backward.  ``window`` 0 means no sliding window.  ``q_pos`` and
    ``k_pos`` (B,S) int32, or None for ``arange(S)``: the mask compares
    positions, a key at a negative one is never attended, and a row that
    may attend no key gives 0 (lse ``-1e30``); without them the kernels
    run their index-masked instances.  Operands must start on 16 bytes
    and have (b, s, h) strides that are whole 16-byte chunks (multiples
    of 8 bf16 or 4 fp32 elements)."""
    global launches
    _check("flash_attention_cuda", q, k, v)
    q_pos, k_pos = _positions("flash_attention_cuda", q, q_pos, k_pos)
    dev = q.device
    b, s, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    _check_aligned("flash_attention_cuda", q=q, k=k, v=v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) \
        if want_lse else None
    if b == 0 or s == 0 or h == 0:
        return (out, lse) if want_lse else out
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("fwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), *strides, b, s, h, hkv, d, dv,
                             int(bool(causal)), int(window), float(scale),
                             int(q.dtype == torch.bfloat16),
                             lse.data_ptr() if want_lse else None,
                             _ptr(q_pos), _ptr(k_pos), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return (out, lse) if want_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, window: int, scale: float,
                             q_pos=None, k_pos=None):
    """The gradient of :func:`flash_attention_cuda`: q, k, v as the
    forward took them, its ``out`` and ``lse``, and ``dout`` (B,S,H,Dv) ->
    (dq (B,S,H,D), dk (B,S,Hkv,D), dv (B,S,Hkv,Dv)) contiguous in q's
    dtype, dk and dv summed over the query heads of each kv head.  Both
    dtypes run on the tensor cores: bf16 in three launches (dq with each
    row's ``rowsum(dout * out)``, dk and dv as fp32 partials per query
    head, their sum over each kv head's group); fp32 in split TF32 in
    two launches (dq, then dk and dv summed over the group in
    registers).  Both take operands as the forward does.  No atomics, so repeated
    calls give the same bits.  Takes the forward's (D, Dv) pairs,
    :data:`HEAD_DIM_PAIRS`: any other raises ``ValueError`` before a
    launch, with no plain fallback; and the forward's positions (a row
    with lse ``-1e30`` gets no gradient, a key at a negative position
    none)."""
    global bwd_launches
    _check("flash_attention_bwd_cuda", q, k, v)
    q_pos, k_pos = _positions("flash_attention_bwd_cuda", q, q_pos, k_pos)
    dev = q.device
    b, s, h, d = q.shape
    hkv, d_v = k.shape[2], v.shape[3]
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    want = (b, s, h, d_v)
    if out.shape != want or dout.shape != want \
            or out.dtype != q.dtype or out.device != dev \
            or dout.device != dev:
        raise ValueError(f"flash_attention_bwd_cuda: out "
                         f"{tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} must be {want} "
                         f"{q.dtype} on {dev}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or lse.device != dev:
        raise ValueError(f"flash_attention_bwd_cuda: lse must be (B,H,S) "
                         f"fp32 on {dev}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    bf16 = q.dtype == torch.bfloat16
    _check_aligned("flash_attention_bwd_cuda", q=q, k=k, v=v, out=out,
                   dout=dout)
    lse = lse.contiguous()
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, s, hkv, d), dtype=q.dtype, device=dev)
    dv = torch.empty((b, s, hkv, d_v), dtype=q.dtype, device=dev)
    if b == 0 or s == 0 or h == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    # the bf16 route's dk (B,S,H,D) then dv (B,S,H,Dv) partials, one per
    # query head
    part = torch.empty((b * s * h * (d + d_v),),
                       dtype=torch.float32, device=dev) if bf16 else None
    strides = [t.stride(i) for t in (q, k, v, out, dout) for i in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("bwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                             delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                             dv.data_ptr(), *strides, b, s, h, hkv, d,
                             d_v, int(bool(causal)), int(window),
                             float(scale),
                             int(bf16), part.data_ptr() if bf16 else None,
                             _ptr(q_pos), _ptr(k_pos), stream)
    if err:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv
