"""Kernel B6: the Mamba-2 SSD chunked scan, in CUDA for Hopper.

Port of the TPU kernel ``ssd_scan_pallas`` (``repro/kernels/ssd_scan.py``)
-> :func:`ssd_scan_cuda` (``csrc/ssd_scan.cu``, whose note says what
bounds it on the card).  Model code calls ``ops.ssd_scan``, which routes
a CUDA tensor here and a CPU tensor to ``ref.ssd_scan_ref``.

Two routes, by dtype: bf16 runs on the tensor cores (``wgmma``) in three
launches (chunk states, the pass over the chunks, the chunk outputs),
fp32 on the CUDA cores in IEEE fp32, which the card-vs-CPU agreement of
fp32 models needs.  A bf16 call the tensor-core kernels cannot take
raises; it never goes to the fp32 kernel or to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

# launches of the kernel in this process (``chip_smoke.py`` zeroes it
# before the main path and reads it after)
launches = 0

HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 256
# the tensor-core route pads N to 16, 32, 64 or 128
MAX_STATE_TC = 128
# dynamic shared memory one block may opt into on Hopper (227 KB)
MAX_SMEM = 232_448

_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.load("ssd_scan")
        fn = lib.ssd_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 10 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        smem = lib.ssd_scan_smem_bytes
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_int64
        _fns = (fn, smem)
    return _fns


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, *, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dt (B,S,H) fp32, a (H,) fp32, b/c (B,S,N) in x's
    dtype (fp32 or bf16), CUDA tensors read in place through their
    strides (last dims contiguous) -> (y (B,S,H,P) in x's dtype, h_last
    (B,H,P,N) fp32), from a zero state.  A ragged last chunk is read as
    dt = 0 steps, which leave the state unchanged.  bf16 takes N a
    multiple of 8 up to 128 and x, b, c that start on 16 bytes with
    (b, s, h) strides that are multiples of 8 elements."""
    global launches
    dev = x.device
    operands = {"x": x, "dt": dt, "a": a, "b": b, "c": c}
    if dev.type != "cuda" \
            or any(t.device != dev for t in operands.values()):
        where = {n: str(t.device) for n, t in operands.items()}
        raise ValueError(f"ssd_scan_cuda needs every operand on one CUDA "
                         f"device, got {where}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or b.dtype != x.dtype or c.dtype != x.dtype \
            or dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd_scan_cuda takes fp32 or bf16 x, b, c of one "
                         f"dtype and fp32 dt, a; got x {x.dtype}, b "
                         f"{b.dtype}, c {c.dtype}, dt {dt.dtype}, a "
                         f"{a.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan_cuda needs x (B,S,H,P), got "
                         f"{tuple(x.shape)}")
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if dt.shape != (bs, s, h) or a.shape != (h,) \
            or b.shape != (bs, s, n) or c.shape != (bs, s, n):
        raise ValueError(f"ssd_scan_cuda: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} do not fit")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_scan_cuda takes head_dim in {HEAD_DIMS}, got "
                         f"{p}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan_cuda takes 1 <= chunk <= {MAX_CHUNK}, "
                         f"got {chunk}")
    if x.stride(3) != 1 or b.stride(2) != 1 or c.stride(2) != 1 \
            or not a.is_contiguous():
        raise ValueError("ssd_scan_cuda needs contiguous last dims of x, "
                         "b, c and a contiguous a")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        if n % 8 or not 8 <= n <= MAX_STATE_TC:
            raise ValueError(f"ssd_scan_cuda on bf16 takes N a multiple of 8 "
                             f"up to {MAX_STATE_TC}, got {n}")
        for name, t in (("x", x), ("b", b), ("c", c)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1]):
                raise ValueError(
                    f"ssd_scan_cuda on bf16 takes 16-byte aligned operands "
                    f"with (b, s, h) strides that are multiples of 8: {name} "
                    f"starts at {t.data_ptr() % 16} mod 16 with strides "
                    f"{t.stride()[:-1]}")
    fn, smem_fn = _kernels()
    smem = smem_fn(p, n, chunk, int(bf16))
    if smem > MAX_SMEM:
        raise ValueError(f"ssd_scan_cuda: P={p}, N={n}, chunk={chunk} needs "
                         f"{smem} bytes of shared memory per block, more "
                         f"than the {MAX_SMEM} a Hopper block may hold")
    y = torch.empty((bs, s, h, p), dtype=x.dtype, device=dev)
    if bs == 0 or s == 0 or h == 0:
        return y, torch.zeros((bs, h, p, n), dtype=torch.float32, device=dev)
    h_last = torch.empty((bs, h, p, n), dtype=torch.float32, device=dev)
    # the tensor-core route's scratch: each chunk's state (then the state
    # entering it) and its cum_Q
    nc = -(-s // chunk) if bf16 else 0
    states = torch.empty((bs * h * nc * p * n,), dtype=torch.float32,
                         device=dev)
    tot = torch.empty((bs * h * nc,), dtype=torch.float32, device=dev)
    strides = [x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
               dt.stride(1), dt.stride(2), b.stride(0), b.stride(1),
               c.stride(0), c.stride(1)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                 states.data_ptr(), tot.data_ptr(), *strides, bs, s, h, p,
                 n, chunk, int(bf16), stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y, h_last
