"""Kernels B2, B3 and B4: the aggregation hot path, in CUDA for Hopper.

Ports of the TPU kernels of ``repro/kernels/fed_aggregate.py``:

* B2 ``fed_weighted_sum_pallas``   -> :func:`fed_weighted_sum_cuda`
  (``csrc/fed_aggregate.cu``), the Eq. (2) numerator;
* B3 ``fed_dp_secure_apply_pallas`` -> :func:`fed_dp_secure_apply_cuda`
  (``csrc/fed_dp_secure.cu``), the dp-noise / secure-mask application;
* B4 ``fed_topk_ef_pallas``         -> :func:`fed_topk_ef_cuda`
  (``csrc/fed_topk_ef.cu``), top-k with error feedback per leaf segment.

Each source carries the note on what bounds it on the card.  Engine and
service code call the ``ops`` wrappers, which route a CUDA tensor here
and a CPU tensor to the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

# launches of each CUDA kernel in this process (``chip_smoke.py`` zeroes
# them before each main path and reads them after): B2, B3, B4
launches = 0
dp_secure_launches = 0
topk_ef_launches = 0

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


# ---------------------------------------------------------------------------
# B3: dp-noise + secure-mask application
# ---------------------------------------------------------------------------
_dp_fn = None


def _dp_kernel():
    global _dp_fn
    if _dp_fn is None:
        fn = _build.load("fed_dp_secure").fed_dp_secure_apply
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float,
                                               ctypes.c_void_p,
                                               ctypes.c_int64, ctypes.c_int64,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _dp_fn = fn
    return _dp_fn


def fed_dp_secure_apply_cuda(x: torch.Tensor, noise=None, masks=None,
                             clip_coef=None, weights=None,
                             noise_scale: float = 0.0) -> torch.Tensor:
    """``x * clip_coef + noise_scale * noise + masks / max(weights, 1e-9)``
    over contiguous ``(K, D)`` fp32 CUDA tensors, each term present only
    when its operand is given (``clip_coef`` and ``weights`` are
    ``(K,)``; ``masks`` needs ``weights``).  Bitwise the plain version."""
    global dp_secure_launches
    if (masks is None) != (weights is None):
        raise ValueError("fed_dp_secure_apply_cuda takes masks and weights "
                         "together")
    rows = {"x": x, "noise": noise, "masks": masks}
    vecs = {"clip_coef": clip_coef, "weights": weights}
    given = {n: t for n, t in {**rows, **vecs}.items() if t is not None}
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in given.values()):
        where = {n: str(t.device) for n, t in given.items()}
        raise ValueError("fed_dp_secure_apply_cuda needs every operand on "
                         f"one CUDA device, got {where}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in given.values()):
        raise ValueError("fed_dp_secure_apply_cuda takes contiguous fp32 "
                         "operands")
    if x.dim() != 2:
        raise ValueError(f"fed_dp_secure_apply_cuda needs x (K, D), got "
                         f"{tuple(x.shape)}")
    k, d = x.shape
    for n, t in given.items():
        want = (k, d) if n in rows else (k,)
        if tuple(t.shape) != want:
            raise ValueError(f"fed_dp_secure_apply_cuda: {n} has shape "
                             f"{tuple(t.shape)}, expected {want}")
    out = torch.empty((k, d), dtype=torch.float32, device=dev)
    if k == 0 or d == 0:
        return out
    # the kernel streams float4s: an operand off 16 bytes (a view into a
    # larger buffer) is copied to a fresh, aligned allocation
    x, noise, masks = (t if t is None or t.data_ptr() % 16 == 0
                       else t.clone() for t in (x, noise, masks))
    flags = (clip_coef is not None) | (noise is not None) << 1 \
        | (masks is not None) << 2
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _dp_kernel()(x.data_ptr(), ptr(noise), ptr(masks),
                           ptr(clip_coef), ptr(weights), float(noise_scale),
                           out.data_ptr(), k, d, flags, stream)
    if err:
        raise RuntimeError(f"fed_dp_secure_apply kernel launch failed: CUDA "
                           f"error {err}")
    dp_secure_launches += 1
    return out


# ---------------------------------------------------------------------------
# B4: top-k with error feedback, per leaf segment of the flat row
# ---------------------------------------------------------------------------
CHUNK = 4096        # columns per block of the chunked passes (never
#                     straddling a segment; kChunk of the kernel)
_topk_fn = None
_TABLES: Dict[Tuple, Dict[str, torch.Tensor]] = {}


def _topk_kernel():
    global _topk_fn
    if _topk_fn is None:
        fn = _build.load("fed_topk_ef").fed_topk_ef
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                               ctypes.c_int] \
            + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int] \
            + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
        _topk_fn = fn
    return _topk_fn


def chunk_table(segments: Sequence[Tuple[int, int, int]]
                ) -> Dict[str, np.ndarray]:
    """Host table of the chunked passes for ``(offset, size, k_keep)``
    segments: each segment cut into chunks of at most :data:`CHUNK`
    columns, in column order."""
    seg_of, start, length, first = [], [], [], []
    for s, (off, size, _) in enumerate(segments):
        first.append(len(start))
        for c0 in range(0, size, CHUNK):
            seg_of.append(s)
            start.append(off + c0)
            length.append(min(CHUNK, size - c0))
    return {"chunk_seg": np.asarray(seg_of, np.int32),
            "chunk_start": np.asarray(start, np.int64),
            "chunk_len": np.asarray(length, np.int32),
            "seg_k": np.asarray([k for _, _, k in segments], np.int32),
            "seg_chunk0": np.asarray(first, np.int32)}


def _device_table(segments, dev) -> Dict[str, torch.Tensor]:
    key = (tuple(segments), str(dev))
    tab = _TABLES.get(key)
    if tab is None:
        tab = {n: torch.from_numpy(a).to(dev)
               for n, a in chunk_table(segments).items()}
        _TABLES[key] = tab
    return tab


def fed_topk_ef_cuda(msgs: torch.Tensor, err_state: torch.Tensor,
                     ids: torch.Tensor,
                     segments: Sequence[Tuple[int, int, int]]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k with error feedback per ``(offset, size, k_keep)`` segment of
    contiguous fp32 CUDA rows: ``msgs (K, D)``, ``err_state (L, D)``, and
    ``ids (K,)`` int32 rows of ``err_state`` (clamped to ``[0, L)`` in
    the kernel).  The segments must tile ``[0, D)`` in order.  Returns
    ``(sent, new_err)``, both ``(K, D)`` fp32, bitwise the plain
    version, from one memset and three launches on the current stream."""
    global topk_ef_launches
    dev = msgs.device
    ts = {"msgs": msgs, "err_state": err_state, "ids": ids}
    if dev.type != "cuda" or any(t.device != dev for t in ts.values()):
        where = {n: str(t.device) for n, t in ts.items()}
        raise ValueError("fed_topk_ef_cuda needs every operand on one CUDA "
                         f"device, got {where}")
    if msgs.dtype != torch.float32 or err_state.dtype != torch.float32 \
            or ids.dtype != torch.int32:
        raise ValueError("fed_topk_ef_cuda takes fp32 msgs and err_state "
                         "and int32 ids")
    if not all(t.is_contiguous() for t in ts.values()):
        raise ValueError("fed_topk_ef_cuda needs contiguous operands")
    if msgs.dim() != 2 or err_state.dim() != 2 \
            or err_state.shape[1] != msgs.shape[1] \
            or tuple(ids.shape) != (msgs.shape[0],):
        raise ValueError(f"fed_topk_ef_cuda needs msgs (K, D), err_state "
                         f"(L, D) and ids (K,), got {tuple(msgs.shape)}, "
                         f"{tuple(err_state.shape)}, {tuple(ids.shape)}")
    k, d = msgs.shape
    pos = 0
    for off, size, keep in segments:
        if off != pos or size < 1 or not 1 <= keep <= size:
            raise ValueError(f"fed_topk_ef_cuda: segments must tile [0, D) "
                             f"in order with 1 <= k_keep <= size, got "
                             f"{(off, size, keep)} at column {pos}")
        pos += size
    if pos != d:
        raise ValueError(f"fed_topk_ef_cuda: segments cover {pos} columns, "
                         f"rows have {d}")
    if k > 65535 or err_state.shape[0] < 1:
        raise ValueError(f"fed_topk_ef_cuda takes 1 <= L and K <= 65535, "
                         f"got L={err_state.shape[0]}, K={k}")
    sent = torch.empty((k, d), dtype=torch.float32, device=dev)
    new_err = torch.empty((k, d), dtype=torch.float32, device=dev)
    if k == 0 or d == 0:
        return sent, new_err
    if msgs.data_ptr() % 16:        # the kernel's vectors follow msgs' phase
        msgs = msgs.clone()
    tab = _device_table(segments, dev)
    nseg, nchunk = len(segments), tab["chunk_seg"].shape[0]
    # scratch of this call, on this stream: the two histograms (zeroed by
    # the kernel's one memset), the selections and each chunk's low-byte
    # histogram, and the 16-bit keys
    ks = k * nseg
    n_zeroed = 2 * ks * 256
    scratch = torch.empty((n_zeroed + 2 * ks + k * nchunk * 256,),
                          dtype=torch.int32, device=dev)
    keys = torch.empty((k, d), dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _topk_kernel()(
            msgs.data_ptr(), err_state.data_ptr(), ids.data_ptr(), k, d,
            err_state.shape[0], tab["chunk_seg"].data_ptr(),
            tab["chunk_start"].data_ptr(), tab["chunk_len"].data_ptr(),
            tab["seg_k"].data_ptr(), tab["seg_chunk0"].data_ptr(), nseg,
            nchunk, scratch.data_ptr(), scratch[n_zeroed:].data_ptr(),
            keys.data_ptr(), sent.data_ptr(), new_err.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fed_topk_ef kernel launch failed: CUDA error "
                           f"{err}")
    topk_ef_launches += 1
    return sent, new_err
