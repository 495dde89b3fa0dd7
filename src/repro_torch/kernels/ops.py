"""Public wrappers of the port's kernels, with the device dispatch.

Model and service code import from here, never from the kernel modules.
Dispatch follows the tensor and has no knob: a CUDA tensor launches the
hand-written kernel (built from ``csrc/`` at first use; a build or launch
failure raises), a CPU tensor runs the plain version in ``ref.py``.
B5 and B6 are differentiable on both: a call that needs a gradient goes
through a ``torch.autograd.Function`` whose backward is the hand-written
backward kernel on a CUDA tensor (a build or launch failure raises; no
fallback) and the plain backward on a CPU tensor.  The backward passes
are ``torch.library`` operators with a CUDA and a CPU implementation:
inside ``torch.func`` transforms a Function's backward sees wrapped
tensors without storage, and an operator receives the plain tensors
under them.  Both Functions and both operators have ``vmap`` rules, so
``torch.func.vmap(grad(...))`` over a cohort of clients (the batched
cohort path) reaches the kernels: B5 and its backward fold the clients
into the batch axis (one launch a cohort), B6 and its backward run once
per client (each client has its own decay ``a``).  B1 is forward-only on
the card: a CUDA call that needs a gradient raises rather than return an
output autograd cannot see through.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fed_aggregate import (fed_dp_secure_apply_cuda,
                                               fed_topk_ef_cuda,
                                               fed_weighted_sum_cuda)
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.kernels.topic_decoder import topic_decoder_cuda

Stacked = Union[torch.Tensor, Mapping[str, torch.Tensor]]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def _needs_grad(*inputs) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.is_floating_point() and t.requires_grad
        for t in inputs)


def _refuse_grad(kernel: str, *inputs) -> None:
    """Raise where a forward-only kernel would be asked for a gradient:
    its output carries no ``grad_fn``, so a backward would silently skip
    it.  The plain versions (CPU tensors) stay differentiable."""
    if _needs_grad(*inputs):
        raise RuntimeError(
            f"{kernel} on a CUDA tensor is forward-only: an input requires "
            f"grad under grad mode, and the kernel has no backward. None "
            f"is planned: the reference's training never runs its decoder "
            f"kernel, so ProdLDA's train mode (A3) will run the plain "
            f"decode on the card. Call it under torch.no_grad(), or on CPU "
            f"tensors for the differentiable plain version")


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
    _refuse_grad("B1 topic_decoder", theta, beta, bow, dec_scale)
    return topic_decoder_cuda(
        theta.contiguous(), beta.contiguous(), bow.contiguous(),
        None if dec_scale is None else dec_scale.contiguous())


def fed_dp_secure_apply(x: torch.Tensor, *, noise=None, masks=None,
                        clip_coef=None, weights=None,
                        noise_scale: float = 0.0) -> torch.Tensor:
    """``x * clip_coef + noise_scale * noise + masks / max(weights, 1e-9)``
    over a flat ``(K, D)`` message slab, terms present only when given:
    ``dp`` passes (noise, clip_coef), ``secure`` passes (masks, weights).
    Kernel B3 on a CUDA tensor; bitwise the plain version either way."""
    if not _on_cuda(x):
        return ref.fed_dp_secure_apply_ref(x, noise, masks, clip_coef,
                                           weights, noise_scale)
    def on(t):
        return None if t is None else \
            t.to(x.device, torch.float32).contiguous()
    return fed_dp_secure_apply_cuda(on(x), on(noise), on(masks),
                                    on(clip_coef), on(weights), noise_scale)


def topk_segments(segments: Sequence[Tuple[int, int]], frac: float
                  ) -> List[Tuple[int, int, int]]:
    """``(offset, size, k_keep)`` per leaf segment, ``k_keep = max(int(frac
    * size), 1)`` — the reference's per-leaf count."""
    return [(int(off), int(n), max(int(frac * n), 1)) for off, n in segments]


def fed_topk_ef(msgs: torch.Tensor, err_state: torch.Tensor,
                ids: torch.Tensor, *, frac: float,
                segments: Sequence[Tuple[int, int]]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k with error feedback over a flat ``(K, D)`` message slab whose
    columns are the ``(offset, size)`` leaf segments: per row and
    segment, ``corrected = msg + err_state[ids]`` keeps exactly
    ``k_keep`` entries (``aggregation.topk_keep_mask``).  ``ids`` are
    ``(K,)`` rows of the ``(L, D)`` error memory, pre-clipped to
    ``[0, L)``.  Returns ``(sent, new_err)``; scattering ``new_err`` back
    (padded rows dropped) stays with the caller.  Kernel B4 on a CUDA
    tensor, one call for every segment; bitwise the plain version."""
    table = topk_segments(segments, frac)
    if not _on_cuda(msgs):
        err_rows = err_state[ids.to(torch.int64)]
        sent = torch.empty(msgs.shape, dtype=torch.float32)
        new_err = torch.empty(msgs.shape, dtype=torch.float32)
        for off, n, k_keep in table:
            s, e = ref.fed_topk_ef_ref(msgs[:, off:off + n],
                                       err_rows[:, off:off + n], k_keep)
            sent[:, off:off + n] = s
            new_err[:, off:off + n] = e
        return sent, new_err
    return fed_topk_ef_cuda(msgs.to(torch.float32).contiguous(),
                            err_state.contiguous(),
                            ids.to(msgs.device, torch.int32).contiguous(),
                            table)


# The backward kernels as operators of their own: the kernel on a CUDA
# tensor, the plain backward on a CPU tensor.  Under ``torch.func.vmap``
# (the batched cohort path) a Function's backward runs on batched
# tensors, which a ctypes call cannot read; the batching rules below
# hand each operator the plain tensors under them.
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
            "Tensor lse, Tensor dout, bool causal, int window, float scale) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_attention_bwd",
          lambda q, k, v, out, lse, dout, causal, window, scale:
          flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal,
                                   window=window, scale=scale), "CUDA")
_LIB.impl("flash_attention_bwd",
          lambda q, k, v, out, lse, dout, causal, window, scale:
          ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                      window=window, scale=scale), "CPU")
_LIB.define("ssd_scan_bwd(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, "
            "Tensor dy, Tensor states, Tensor? dh_last, int chunk) -> "
            "(Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.impl("ssd_scan_bwd",
          lambda x, dt, a, b, c, dy, states, dh_last, chunk:
          ssd_scan_bwd_cuda(x, dt, a, b, c, dy, states, dh_last,
                            chunk=chunk), "CUDA")
_LIB.impl("ssd_scan_bwd",
          lambda x, dt, a, b, c, dy, states, dh_last, chunk:
          tuple(ref.ssd_scan_bwd_ref(x, dt, a, b, c, dy, dh_last, chunk)),
          "CPU")


def _batch_first(t: Optional[torch.Tensor], dim: Optional[int], size: int
                 ) -> Optional[torch.Tensor]:
    """A vmapped operand with its vmap axis first; an operand without one
    (``dim`` None) broadcast along a new first axis of ``size``."""
    if t is None:
        return None
    if dim is None:
        return t.unsqueeze(0).expand((size,) + tuple(t.shape))
    return t.movedim(dim, 0)


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(K, B, ...) -> (K*B, ...): the vmap axis into the batch axis."""
    return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))


def _flash_bwd_vmap(info, in_dims, q, k, v, out, lse, dout, causal, window,
                    scale):
    """Every operand of B5's backward is per sequence, so the vmap axis
    folds into the batch axis: one call for the whole cohort."""
    ts = [_batch_first(t, d, info.batch_size)
          for t, d in zip((q, k, v, out, lse, dout), in_dims)]
    grads = torch.ops.repro_torch.flash_attention_bwd(
        *(_fold(t) for t in ts), causal, window, scale)
    return tuple(g.unflatten(0, ts[0].shape[:2]) for g in grads), (0, 0, 0)


def _ssd_bwd_vmap(info, in_dims, x, dt, a, b, c, dy, states, dh_last, chunk):
    """B6's backward sums ``da`` over the batch, and each member of the
    vmap axis (a client) has its own ``a``: one call per member."""
    ts = [_batch_first(t, d, info.batch_size)
          for t, d in zip((x, dt, a, b, c, dy, states, dh_last), in_dims)]
    grads = [torch.ops.repro_torch.ssd_scan_bwd(
        *(None if t is None else t[i] for t in ts), chunk)
        for i in range(info.batch_size)]
    return tuple(torch.stack(g) for g in zip(*grads)), (0,) * 5


torch.library.register_vmap("repro_torch::flash_attention_bwd",
                            _flash_bwd_vmap, lib=_LIB)
torch.library.register_vmap("repro_torch::ssd_scan_bwd", _ssd_bwd_vmap,
                            lib=_LIB)


class _FlashAttention(torch.autograd.Function):
    """B5 with its gradient: the forward also keeps each row's
    log-sum-exp, and the backward recomputes the probabilities from
    (q, k, v, out, lse), as the reference's ``_flash_vjp`` does.  Kernels
    on a CUDA tensor, the plain versions on a CPU tensor."""

    @staticmethod
    def forward(q, k, v, causal, window, scale):
        if _on_cuda(q):
            return flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        want_lse=True)
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                           window=window, scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, scale=scale)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, out, lse, dout, **ctx.mask)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale):
        """The vmap axis (the batched cohort's clients) folds into the
        batch axis, ``(K, B, S, H, D) -> (K*B, S, H, D)``: every operand
        is per sequence, so one launch serves the whole cohort."""
        ts = [_batch_first(t, d, info.batch_size)
              for t, d in zip((q, k, v), in_dims)]
        out, lse = _FlashAttention.apply(*(_fold(t) for t in ts), causal,
                                         window, scale)
        kb = ts[0].shape[:2]
        return (out.unflatten(0, kb), lse.unflatten(0, kb)), (0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,Hq,D), k/v (B,S,Hkv,D) -> (B,S,Hq,D) in q's dtype: softmax
    attention with a causal, sliding-window (``window`` > 0) or full
    mask, GQA by index, fp32 accumulation.  Kernel B5 on a CUDA tensor
    (read in place through its strides); a call that needs a gradient
    also keeps the row log-sum-exp for B5's backward kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, scale)[0]
    if not _on_cuda(q):
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                           window=window, scale=scale)[0]
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                scale=scale)


class _SSDScan(torch.autograd.Function):
    """B6 with its gradient: on a CUDA tensor the forward keeps the state
    entering each chunk and the backward kernel reads it; on a CPU tensor
    the backward is the plain one (autograd through ``ssd_scan_ref``, as
    the reference differentiates ``ssd_chunked``)."""

    @staticmethod
    def forward(x, dt, a, b, c, chunk):
        if _on_cuda(x):
            return ssd_scan_cuda(x, dt, a, b, c, chunk=chunk,
                                 keep_states=True)
        y, h_last = ref.ssd_scan_ref(x, dt, a, b, c, chunk)
        return y, h_last, h_last.new_empty((0,))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, a, b, c, chunk = inputs
        ctx.save_for_backward(x, dt, a, b, c, output[2])
        ctx.chunk = chunk
        ctx.mark_non_differentiable(output[2])
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dy, dh_last, _dstates):
        x, dt, a, b, c, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = torch.ops.repro_torch.ssd_scan_bwd(
            x, dt, a, b, c, dy, states, dh_last, ctx.chunk)
        return (*grads, None)

    @staticmethod
    def vmap(info, in_dims, x, dt, a, b, c, chunk):
        """One call per member of the vmap axis (a client of the batched
        cohort): ``a`` comes from each client's own ``A_log``, and the
        kernel takes one ``(H,)`` decay and sums ``da`` over its batch,
        so the clients cannot fold into the batch axis as B5's do."""
        ts = [_batch_first(t, d, info.batch_size)
              for t, d in zip((x, dt, a, b, c), in_dims)]
        outs = [_SSDScan.apply(*(t[i] for t in ts), chunk)
                for i in range(info.batch_size)]
        return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD scan from a zero state: x (B,S,H,P), dt (B,S,H), a
    (H,), b/c (B,S,N) -> (y (B,S,H,P) in x's dtype, h_last (B,H,P,N)
    fp32), over chunks of ``min(chunk, S)`` steps (a ragged tail is
    padded with dt = 0 steps, which leave the state unchanged).  Kernel
    B6 on a CUDA tensor, with its backward kernel when a gradient is
    needed (dt and a reach it through their cast to fp32)."""
    q = min(chunk, x.shape[1])
    if _needs_grad(x, dt, a, b, c):
        y, h_last, _ = _SSDScan.apply(x, dt.to(torch.float32),
                                      a.to(torch.float32), b, c, q)
        return y, h_last
    if not _on_cuda(x):
        return ref.ssd_scan_ref(x, dt, a, b, c, q)
    return ssd_scan_cuda(x, dt.to(torch.float32), a.to(torch.float32), b, c,
                         chunk=q)
