"""Kernel B6: the Mamba-2 SSD chunked scan, forward and backward, in CUDA
for Hopper.

Port of the TPU kernel ``ssd_scan_pallas`` (``repro/kernels/ssd_scan.py``)
-> :func:`ssd_scan_cuda` (``csrc/ssd_scan.cu``, whose note says what
bounds it on the card), and of the reference's backward, ``jax.grad``
through ``ssd_chunked`` (``repro/models/layers/mamba2.py``; no Pallas
kernel) -> :func:`ssd_scan_bwd_cuda` (``csrc/ssd_scan_bwd.cu``).  Model
code calls ``ops.ssd_scan``, which routes a CUDA tensor here and a CPU
tensor to the plain versions in ``ref.py``.

Two routes in each direction, by dtype, both on the tensor cores
(``wgmma``): bf16 products, or fp32 operands as split TF32 pairs (hi =
tf32(x), lo = tf32(x - hi), three TF32 products an fp32 product), which
holds the card-vs-CPU agreement of fp32 models.  The forward takes three
launches (chunk states, the pass over the chunks, the chunk outputs), the
backward four (rows, the reverse pass over the chunks, columns, the sums
over the heads).  The forward starts from a carried state ``h0`` where it
is given (the pass over the chunks starts from it, so the chunk kernels
read it as chunk 0's entering state), and the backward's reverse pass
writes the gradient of that state, ``dh0``.  A call the kernels cannot
take raises before any launch; it never goes to another route or to the
plain version.  The
backward recomputes nothing of the forward's state pass: the forward
keeps the state entering each chunk (``keep_states``) and the backward
reads it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

# calls that launched the forward / the backward kernels in this process
# (``chip_smoke.py`` zeroes them before the main path and reads them after)
launches = 0
bwd_launches = 0

HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 256
# both routes pad N to 16, 32, 64 or 128; every (P, N, chunk) they take
# fits a Hopper block's 227 KB of shared memory (the notes of
# csrc/ssd_scan.cu and csrc/ssd_scan_bwd.cu hold the budgets)
MAX_STATE = 128

_fns = {}


def _kernels():
    if not _fns:
        lib = _build.load("ssd_scan")
        fn = lib.ssd_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 10 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["fwd"] = fn
    return _fns["fwd"]


def _bwd_kernels():
    if "bwd" not in _fns:
        lib = _build.load("ssd_scan_bwd")
        fn = lib.ssd_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int64] * 10 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["bwd"] = fn
    return _fns["bwd"]


def _check(fn: str, x, dt, a, b, c, chunk: int):
    """Device, dtype, shape and layout checks shared by both kernels;
    returns (B, S, H, P, N)."""
    dev = x.device
    operands = {"x": x, "dt": dt, "a": a, "b": b, "c": c}
    if dev.type != "cuda" \
            or any(t.device != dev for t in operands.values()):
        where = {n: str(t.device) for n, t in operands.items()}
        raise ValueError(f"{fn} needs every operand on one CUDA "
                         f"device, got {where}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or b.dtype != x.dtype or c.dtype != x.dtype \
            or dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"{fn} takes fp32 or bf16 x, b, c of one "
                         f"dtype and fp32 dt, a; got x {x.dtype}, b "
                         f"{b.dtype}, c {c.dtype}, dt {dt.dtype}, a "
                         f"{a.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{fn} needs x (B,S,H,P), got "
                         f"{tuple(x.shape)}")
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if dt.shape != (bs, s, h) or a.shape != (h,) \
            or b.shape != (bs, s, n) or c.shape != (bs, s, n):
        raise ValueError(f"{fn}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} do not fit")
    if p not in HEAD_DIMS:
        raise ValueError(f"{fn} takes head_dim in {HEAD_DIMS}, got "
                         f"{p}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{fn} takes 1 <= chunk <= {MAX_CHUNK}, "
                         f"got {chunk}")
    if x.stride(3) != 1 or b.stride(2) != 1 or c.stride(2) != 1 \
            or not a.is_contiguous():
        raise ValueError(f"{fn} needs contiguous last dims of x, "
                         f"b, c and a contiguous a")
    return bs, s, h, p, n


def _check_tensor_core_operands(fn: str, x, b, c):
    """What the kernels read: N a multiple of 8 (bf16) or 4 (fp32) up to
    128, and x, b, c starting on 16 bytes with
    (b, s, h) strides that are multiples of 8 (bf16) or 4 (fp32)
    elements."""
    n = b.shape[-1]
    unit = 8 if x.dtype == torch.bfloat16 else 4
    what = "bf16" if unit == 8 else "fp32"
    if n % unit or not unit <= n <= MAX_STATE:
        raise ValueError(f"{fn} on {what} takes N a multiple of {unit} up "
                         f"to {MAX_STATE}, got {n}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.data_ptr() % 16 or any(st % unit for st in t.stride()[:-1]):
            raise ValueError(
                f"{fn} on {what} takes 16-byte aligned operands with (b, "
                f"s, h) strides that are multiples of {unit}: {name} starts "
                f"at {t.data_ptr() % 16} mod 16 with strides "
                f"{t.stride()[:-1]}")


def _check_h0(fn: str, h0, bs: int, h: int, p: int, n: int, dev):
    """The carried state as the state pass reads it: (B,H,P,N) fp32,
    contiguous, on the operands' device; anything else raises."""
    if h0 is None:
        return
    if h0.dtype != torch.float32 or tuple(h0.shape) != (bs, h, p, n) \
            or h0.device != dev or not h0.is_contiguous():
        raise ValueError(f"{fn} takes h0 as a contiguous (B,H,P,N) = "
                         f"{(bs, h, p, n)} fp32 tensor on {dev}, got "
                         f"{tuple(h0.shape)} {h0.dtype} on {h0.device}"
                         f"{'' if h0.is_contiguous() else ', strided'}")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                  keep_states: bool = False, h0=None):
    """x (B,S,H,P), dt (B,S,H) fp32, a (H,) fp32, b/c (B,S,N) in x's
    dtype (fp32 or bf16), CUDA tensors read in place through their
    strides (last dims contiguous) -> (y (B,S,H,P) in x's dtype, h_last
    (B,H,P,N) fp32), from the state ``h0`` (a contiguous (B,H,P,N) fp32
    tensor) or from zero; with ``keep_states`` also the state entering
    each chunk, (B,H,chunks,P,N) fp32 (chunk 0's is h0), for the
    backward.
    A ragged last chunk is read as dt = 0 steps, which leave the state
    unchanged.  bf16 takes N a multiple of 8 up to 128 and x, b, c that
    start on 16 bytes with (b, s, h) strides that are multiples of 8
    elements."""
    global launches
    bs, s, h, p, n = _check("ssd_scan_cuda", x, dt, a, b, c, chunk)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    _check_tensor_core_operands("ssd_scan_cuda", x, b, c)
    _check_h0("ssd_scan_cuda", h0, bs, h, p, n, dev)
    fn = _kernels()
    y = torch.empty((bs, s, h, p), dtype=x.dtype, device=dev)
    nc = -(-s // chunk)
    if bs == 0 or s == 0 or h == 0:
        h_last = torch.zeros((bs, h, p, n), dtype=torch.float32, device=dev)
        if h0 is not None and s == 0:
            h_last.copy_(h0)
        states = torch.zeros((bs, h, nc, p, n), dtype=torch.float32,
                             device=dev)
        return (y, h_last, states) if keep_states else (y, h_last)
    h_last = torch.empty((bs, h, p, n), dtype=torch.float32, device=dev)
    # the scratch: each chunk's state (then the state entering it) and its
    # cum_Q
    states = torch.empty((bs, h, nc, p, n), dtype=torch.float32, device=dev)
    tot = torch.empty((bs * h * nc,), dtype=torch.float32, device=dev)
    strides = [x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
               dt.stride(1), dt.stride(2), b.stride(0), b.stride(1),
               c.stride(0), c.stride(1)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                 states.data_ptr(), tot.data_ptr(),
                 None if h0 is None else h0.data_ptr(), *strides, bs, s, h,
                 p, n, chunk, int(bf16), stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return (y, h_last, states) if keep_states else (y, h_last)


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                      states: torch.Tensor, dh_last, *, chunk: int):
    """The gradient of :func:`ssd_scan_cuda`: its operands as it took
    them, ``dy`` (B,S,H,P) of y, the ``states`` it kept (chunk 0's the
    h0 it started from) and ``dh_last`` (B,H,P,N) of h_last or None
    (zero) -> (dx (B,S,H,P) in x's dtype, ddt (B,S,H) fp32, da (H,) fp32,
    db, dc (B,S,N) in x's dtype, dh0 (B,H,P,N) fp32, the gradient of the
    state entering chunk 0).  Four launches; no atomics, so repeated
    calls give the same bits.  Takes what the forward takes, and a dy
    that starts on 16 bytes."""
    global bwd_launches
    bs, s, h, p, n = _check("ssd_scan_bwd_cuda", x, dt, a, b, c, chunk)
    dev = x.device
    nc = -(-s // chunk)
    bf16 = x.dtype == torch.bfloat16
    _check_tensor_core_operands("ssd_scan_bwd_cuda", x, b, c)
    dy = dy.to(x.dtype).contiguous()
    if dy.data_ptr() % 16:  # a view into another tensor: the kernel
        dy = dy.clone()     # reads whole 16-byte chunks of its rows
    if dy.shape != x.shape or dy.device != dev:
        raise ValueError(f"ssd_scan_bwd_cuda: dy {tuple(dy.shape)} on "
                         f"{dy.device} must match x {tuple(x.shape)} on "
                         f"{dev}")
    if states.shape != (bs, h, nc, p, n) or states.dtype != torch.float32 \
            or not states.is_contiguous() or states.device != dev:
        raise ValueError(f"ssd_scan_bwd_cuda: states must be the forward's "
                         f"contiguous (B,H,chunks,P,N) fp32 "
                         f"{(bs, h, nc, p, n)}, got {tuple(states.shape)} "
                         f"{states.dtype}")
    if dh_last is not None:
        dh_last = dh_last.to(torch.float32).contiguous()
        if dh_last.shape != (bs, h, p, n) or dh_last.device != dev:
            raise ValueError(f"ssd_scan_bwd_cuda: dh_last must be (B,H,P,N) "
                             f"{(bs, h, p, n)} on {dev}, got "
                             f"{tuple(dh_last.shape)}")
    fn = _bwd_kernels()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((bs, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((bs, s, h), **f32)
    da = torch.empty((h,), **f32)
    db = torch.empty((bs, s, n), dtype=x.dtype, device=dev)
    dc = torch.empty((bs, s, n), dtype=x.dtype, device=dev)
    dh0 = torch.empty((bs, h, p, n), **f32)
    if bs == 0 or s == 0 or h == 0:
        if dh_last is not None and s == 0:
            dh0.copy_(dh_last)
        else:
            dh0.zero_()
        return dx, ddt, da.zero_(), db.zero_(), dc.zero_(), dh0
    dcum = torch.empty((bs * h * nc * chunk,), **f32)
    du = torch.empty((bs * h * nc * p * n,), **f32)
    cum_q = torch.empty((bs * h * nc,), **f32)
    db_part = torch.empty((bs * h * s * n,), **f32)
    dc_part = torch.empty((bs * h * s * n,), **f32)
    da_part = torch.empty((bs * h * nc,), **f32)
    strides = [x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
               dt.stride(1), dt.stride(2), b.stride(0), b.stride(1),
               c.stride(0), c.stride(1)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), dy.data_ptr(), states.data_ptr(),
                 None if dh_last is None else dh_last.data_ptr(),
                 dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
                 dc.data_ptr(), dh0.data_ptr(), dcum.data_ptr(),
                 du.data_ptr(), cum_q.data_ptr(), db_part.data_ptr(),
                 dc_part.data_ptr(), da_part.data_ptr(), *strides, bs, s, h,
                 p, n, chunk, int(bf16), stream)
    if err:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    bwd_launches += 1
    return dx, ddt, da, db, dc, dh0
