"""Kernel B1: the fused ProdLDA decoder forward, in CUDA for Hopper.

Port of the TPU kernel ``topic_decoder_pallas``
(``repro/kernels/topic_decoder.py``); the source, with the note on what
bounds it on the card, is ``csrc/topic_decoder.cu``.  Forward only: the
service evaluates held-out documents through it, and training keeps the
materialized expression, whose gradient autograd takes.  Callers use
``ops.topic_decoder_loss``, which routes a CUDA tensor here and a CPU
tensor to ``ref.topic_decoder_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (``chip_smoke.py`` zeroes it
# before the service's main path and reads it after)
launches = 0

DOCS, WORDS = 32, 128           # kDocs, kWords of csrc/topic_decoder.cu

_fn = None
# per (device, stream): the kernel's arrival counters, one per document
# tile, 0 between calls (the last block of a tile resets its own), grown
# as needed.  Calls on one stream run one after another, so they can
# share a set; calls on two streams may overlap, so each stream has its
# own, and no call counts another's arrivals.
_counters = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("topic_decoder").topic_decoder_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def grid(b: int, v: int):
    """(document tiles, vocabulary tiles) of the one launch."""
    return -(-b // DOCS), -(-v // WORDS)


def _counter(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The counters of calls on ``stream``: zeroed on that stream when
    made, so the first call that uses them is ordered after the fill."""
    c = _counters.get((dev, stream))
    if c is None or c.numel() < n:
        c = torch.zeros((max(n, 64),), dtype=torch.int32, device=dev)
        _counters[(dev, stream)] = c
    return c


def topic_decoder_cuda(theta: torch.Tensor, beta: torch.Tensor,
                       bow: torch.Tensor,
                       dec_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """theta (B,K), beta (K,V), bow (B,V), dec_scale (V,) or None — all
    contiguous fp32 on one CUDA device -> per-doc recon loss (B,) fp32."""
    global launches
    dev = theta.device
    ts = [theta, beta, bow] + ([dec_scale] if dec_scale is not None else [])
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("topic_decoder_cuda needs every operand on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("topic_decoder_cuda takes fp32 operands, got "
                         f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("topic_decoder_cuda needs contiguous operands")
    if theta.dim() != 2 or beta.dim() != 2:
        raise ValueError("topic_decoder_cuda needs theta (B, K) and "
                         "beta (K, V)")
    b, k = theta.shape
    v = beta.shape[1]
    if beta.shape[0] != k or bow.shape != (b, v) or (
            dec_scale is not None and dec_scale.shape != (v,)):
        raise ValueError(
            f"topic_decoder_cuda shapes disagree: theta {tuple(theta.shape)}"
            f", beta {tuple(beta.shape)}, bow {tuple(bow.shape)}, dec_scale "
            f"{None if dec_scale is None else tuple(dec_scale.shape)}")
    if not (1 <= k and 1 <= v <= 65535 * WORDS and b < 2 ** 31):
        raise ValueError(f"topic_decoder_cuda takes K >= 1 and 1 <= V <= "
                         f"{65535 * WORDS}, got K={k}, V={v}")
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    doc_tiles, vocab_tiles = grid(b, v)
    # per (document, vocabulary tile) partial (m, l, S, NB), merged in the
    # same launch by the last block of each document tile to finish
    part = torch.empty((b, vocab_tiles, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter = _counter(dev, stream, doc_tiles)
    with torch.cuda.device(dev):
        err = _kernel()(theta.data_ptr(), beta.data_ptr(), bow.data_ptr(),
                        0 if dec_scale is None else dec_scale.data_ptr(),
                        out.data_ptr(), part.data_ptr(), counter.data_ptr(),
                        b, k, v, stream)
    if err:
        raise RuntimeError(f"topic_decoder kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
