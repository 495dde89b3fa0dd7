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

The four federated wrappers take ``mesh`` (a ``parallel.sharding.
FedMesh``): their row operands are then row-sharded, each shard's rows go
through the kernel (or its plain version) on the shard's own device, and
a cross-row sum is the per-shard partials added in shard order on the
mesh's first device — the port's counterparts of the reference's
``shard_map`` islands.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
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
            f"kernel, so ProdLDA's train mode (A3) runs the plain "
            f"decode on the card. Call it under torch.no_grad(), or on CPU "
            f"tensors for the differentiable plain version")


def _weighted_sum_leaf(leaf: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    if not _on_cuda(leaf):
        return ref.fed_weighted_sum_ref(leaf, c)
    flat = leaf.reshape(leaf.shape[0], -1)
    return fed_weighted_sum_cuda(flat.contiguous(),
                                 c.to(leaf.device).contiguous()
                                 ).reshape(leaf.shape[1:])


def fed_weighted_sum(stacked: Stacked, coefs, *, mesh=None) -> Stacked:
    """NUMERATOR-only ``sum_k where(c_k > 0, c_k x_k, 0)`` over a stacked
    ``(K, ...)`` tensor, or per leaf over a dict of them — the
    staleness-discounted combine's numerator (the caller divides).

    With ``mesh`` (a ``parallel.sharding.FedMesh``) the K axis is
    row-sharded: ``stacked`` is a list of shards (or a whole tensor,
    split), each shard's partial numerator is B2 on its own device (the
    plain version on a CPU shard), and the partials are added in shard
    order on the mesh's first device (the port's ``psum``)."""
    c = torch.as_tensor(coefs, dtype=torch.float32)
    if mesh is not None:
        return mesh.psum([_weighted_sum_leaf(x, cd) for x, cd in
                          zip(mesh.rows(stacked), mesh.split(c))])
    if isinstance(stacked, torch.Tensor):
        return _weighted_sum_leaf(stacked, c)
    return {k: _weighted_sum_leaf(v, c) for k, v in stacked.items()}


def fed_weighted_combine(stacked: Stacked, weights, *, mesh=None) -> Stacked:
    """Eq. (2): ``sum_k w_k x_k / max(sum w, 1e-12)`` with zero-weight rows
    masked out (tensor or per leaf over a dict of stacked leaves).  With
    ``mesh``, the numerator as in :func:`fed_weighted_sum` and the
    denominator the ``psum`` of the per-shard weight sums, then the
    replicated division on the mesh's first device."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    if mesh is not None:
        total = torch.clamp(mesh.psum([torch.sum(p) for p in mesh.split(w)]),
                            min=1e-12)
    else:
        total = torch.clamp(torch.sum(w), min=1e-12)
    num = fed_weighted_sum(stacked, w, mesh=mesh)
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


def fed_dp_secure_apply(x, *, noise=None, masks=None, clip_coef=None,
                        weights=None, noise_scale: float = 0.0, mesh=None):
    """``x * clip_coef + noise_scale * noise + masks / max(weights, 1e-9)``
    over a flat ``(K, D)`` message slab, terms present only when given:
    ``dp`` passes (noise, clip_coef), ``secure`` passes (masks, weights).
    Kernel B3 on a CUDA tensor; bitwise the plain version either way.

    Strictly per row, so with ``mesh`` every operand is row-sharded (a
    list of shards, or a whole tensor, split) and each shard runs B3 on
    its own rows with no cross-shard term: the result, a list of shards,
    is bitwise the rows the unsharded call gives."""
    if mesh is not None:
        nz, mk, cc, wt = [[None] * mesh.size if t is None else mesh.rows(t)
                          for t in (noise, masks, clip_coef, weights)]
        return [fed_dp_secure_apply(xd, noise=nz[d], masks=mk[d],
                                    clip_coef=cc[d], weights=wt[d],
                                    noise_scale=noise_scale)
                for d, xd in enumerate(mesh.rows(x))]
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


def fed_topk_ef(msgs, err_state, ids, *, frac: float,
                segments: Sequence[Tuple[int, int]], mesh=None):
    """Top-k with error feedback over a flat ``(K, D)`` message slab whose
    columns are the ``(offset, size)`` leaf segments: per row and
    segment, ``corrected = msg + err_state[ids]`` keeps exactly
    ``k_keep`` entries (``aggregation.topk_keep_mask``).  ``ids`` are
    ``(K,)`` rows of the ``(L, D)`` error memory, pre-clipped to
    ``[0, L)``.  Returns ``(sent, new_err)``; scattering ``new_err`` back
    (padded rows dropped) stays with the caller.  Kernel B4 on a CUDA
    tensor, one call for every segment; bitwise the plain version.

    With ``mesh`` the K rows and the L rows of the error memory are both
    row-sharded (lists of shards, or whole tensors, split): the cohort's
    error rows are gathered by global id across the shards first, then
    each shard runs B4 on its own rows and their gathered memory, as the
    reference gathers outside its shard_map island.  Same math, no
    cross-row term; ``sent`` and ``new_err`` come back as lists of
    shards."""
    if mesh is not None:
        gathered = mesh.gather_rows(mesh.rows(err_state),
                                    np.asarray(ids, np.int64))
        pairs = [fed_topk_ef(m, e, torch.arange(m.shape[0],
                                                device=m.device),
                             frac=frac, segments=segments)
                 for m, e in zip(mesh.rows(msgs), gathered)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    ids = torch.as_tensor(ids)
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
            "Tensor lse, Tensor dout, bool causal, int window, float scale, "
            "Tensor? q_pos=None, Tensor? k_pos=None) -> (Tensor, Tensor, "
            "Tensor)")
_LIB.impl("flash_attention_bwd",
          lambda q, k, v, out, lse, dout, causal, window, scale, q_pos=None,
          k_pos=None: flash_attention_bwd_cuda(
              q, k, v, out, lse, dout, causal=causal, window=window,
              scale=scale, q_pos=q_pos, k_pos=k_pos), "CUDA")
_LIB.impl("flash_attention_bwd",
          lambda q, k, v, out, lse, dout, causal, window, scale, q_pos=None,
          k_pos=None: ref.flash_attention_bwd_ref(
              q, k, v, out, lse, dout, causal=causal, window=window,
              scale=scale, q_pos=q_pos, k_pos=k_pos), "CPU")
# h0 is the plain backward's: the kernel reads the entering state from the
# states the forward kept, chunk 0's being h0
_LIB.define("ssd_scan_bwd(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, "
            "Tensor dy, Tensor states, Tensor? dh_last, int chunk, "
            "Tensor? h0=None) -> (Tensor, Tensor, Tensor, Tensor, Tensor, "
            "Tensor)")
_LIB.impl("ssd_scan_bwd",
          lambda x, dt, a, b, c, dy, states, dh_last, chunk, h0=None:
          ssd_scan_bwd_cuda(x, dt, a, b, c, dy, states, dh_last,
                            chunk=chunk), "CUDA")
_LIB.impl("ssd_scan_bwd",
          lambda x, dt, a, b, c, dy, states, dh_last, chunk, h0=None:
          tuple(ref.ssd_scan_bwd_ref(x, dt, a, b, c, dy, dh_last, chunk,
                                     h0)), "CPU")


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


def _dims(in_dims, n: int):
    """An operator's ``in_dims``, its trailing defaulted operands (None
    where a call left them out) padded with None."""
    return tuple(in_dims) + (None,) * (n - len(in_dims))


def _flash_bwd_vmap(info, in_dims, q, k, v, out, lse, dout, causal, window,
                    scale, q_pos=None, k_pos=None):
    """Every operand of B5's backward is per sequence, so the vmap axis
    folds into the batch axis: one call for the whole cohort (batched
    positions (K, B, S) fold to (K*B, S) as q, k and v do)."""
    dims = _dims(in_dims, 11)
    ts = [_batch_first(t, d, info.batch_size)
          for t, d in zip((q, k, v, out, lse, dout, q_pos, k_pos),
                          dims[:6] + dims[9:])]
    folded = [None if t is None else _fold(t) for t in ts]
    grads = torch.ops.repro_torch.flash_attention_bwd(
        *folded[:6], causal, window, scale, *folded[6:])
    return tuple(g.unflatten(0, ts[0].shape[:2]) for g in grads), (0, 0, 0)


def _ssd_bwd_vmap(info, in_dims, x, dt, a, b, c, dy, states, dh_last, chunk,
                  h0=None):
    """B6's backward sums ``da`` over the batch, and each member of the
    vmap axis (a client) has its own ``a`` and ``h0``: one call per
    member."""
    dims = _dims(in_dims, 10)
    ts = [_batch_first(t, d, info.batch_size)
          for t, d in zip((x, dt, a, b, c, dy, states, dh_last, h0),
                          dims[:8] + dims[9:])]
    members = [[None if t is None else t[i] for t in ts]
               for i in range(info.batch_size)]
    grads = [torch.ops.repro_torch.ssd_scan_bwd(*m[:8], chunk, m[8])
             for m in members]
    return tuple(torch.stack(g) for g in zip(*grads)), (0,) * 6


def _flash_bwd_fake(q, k, v, out, lse, dout, causal, window, scale,
                    q_pos=None, k_pos=None):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _ssd_bwd_fake(x, dt, a, b, c, dy, states, dh_last, chunk, h0=None):
    bs, _, h, p = x.shape
    f32 = torch.promote_types(x.dtype, torch.float32)
    return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(a),
            torch.empty_like(b), torch.empty_like(c),
            x.new_empty((bs, h, p, b.shape[-1]), dtype=f32))


torch.library.register_fake("repro_torch::flash_attention_bwd",
                            _flash_bwd_fake, lib=_LIB)
torch.library.register_fake("repro_torch::ssd_scan_bwd", _ssd_bwd_fake,
                            lib=_LIB)
torch.library.register_vmap("repro_torch::flash_attention_bwd",
                            _flash_bwd_vmap, lib=_LIB)
torch.library.register_vmap("repro_torch::ssd_scan_bwd", _ssd_bwd_vmap,
                            lib=_LIB)


# The forwards as operators too: the kernel on a CUDA tensor, the plain
# version on a CPU tensor, and a fake implementation that allocates the
# kernel's outputs and computes nothing.  Through them the selective
# checkpoint policy of ``launch/steps.py`` sees B5 and B6 as one
# operator each (never the ``empty`` outputs a ctypes launch writes
# into), ``FakeTensorMode`` sizes them at the kernel's O(S D) footprint
# (the plain version's score matrix is O(S^2)), and DTensor shards them
# by the rules below.  ``want_lse`` / ``keep_states`` off give an empty
# (0,) tensor in that output's place.  Their gradient is the Functions'
# further down (``torch.func`` cannot run an operator's generated
# autograd Function), so the operators register none.
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, float scale, Tensor? q_pos=None, "
            "Tensor? k_pos=None, bool want_lse=True) -> (Tensor, Tensor)")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, "
            "int chunk, Tensor? h0=None, bool keep_states=False) -> "
            "(Tensor, Tensor, Tensor)")


def _flash_fwd_cuda(q, k, v, causal, window, scale, q_pos=None, k_pos=None,
                    want_lse=True):
    got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=scale, want_lse=want_lse, q_pos=q_pos,
                               k_pos=k_pos)
    return got if want_lse else (got, q.new_empty((0,), dtype=torch.float32))


def _flash_fwd_cpu(q, k, v, causal, window, scale, q_pos=None, k_pos=None,
                   want_lse=True):
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                           window=window, scale=scale,
                                           q_pos=q_pos, k_pos=k_pos)
    return out, lse if want_lse else lse.new_empty((0,))


def _flash_fwd_fake(q, k, v, causal, window, scale, q_pos=None, k_pos=None,
                    want_lse=True):
    b, s, h, _ = q.shape
    lse = (b, h, s) if want_lse else (0,)
    # the kernel writes out contiguous; the plain version heads-major
    out = q.new_empty((b, s, h, v.shape[-1])) if q.device.type != "cpu" \
        else q.new_empty((b, h, s, v.shape[-1])).transpose(1, 2)
    return out, q.new_empty(lse, dtype=torch.float32)


def _ssd_fwd_cuda(x, dt, a, b, c, chunk, h0=None, keep_states=False):
    got = ssd_scan_cuda(x, dt, a, b, c, chunk=chunk, h0=h0,
                        keep_states=keep_states)
    return got if keep_states else \
        (*got, x.new_empty((0,), dtype=torch.float32))


def _ssd_fwd_cpu(x, dt, a, b, c, chunk, h0=None, keep_states=False):
    y, *rest = ref.ssd_scan_ref(x, dt, a, b, c, chunk, h0,
                                keep_states=keep_states)
    # a ragged tail leaves y a slice of the padded scan: contiguous, as
    # the kernel writes it
    y = y.contiguous()
    return (y, *rest) if keep_states else \
        (y, rest[0], rest[0].new_empty((0,)))


def _ssd_fwd_fake(x, dt, a, b, c, chunk, h0=None, keep_states=False):
    bs, s, h, p = x.shape
    n = b.shape[-1]
    f32 = torch.promote_types(x.dtype, torch.float32)
    states = (bs, h, -(-s // chunk), p, n) if keep_states else (0,)
    return (x.new_empty(x.shape), x.new_empty((bs, h, p, n), dtype=f32),
            x.new_empty(states, dtype=f32))


_LIB.impl("flash_attention", _flash_fwd_cuda, "CUDA")
_LIB.impl("flash_attention", _flash_fwd_cpu, "CPU")
_LIB.impl("ssd_scan", _ssd_fwd_cuda, "CUDA")
_LIB.impl("ssd_scan", _ssd_fwd_cpu, "CPU")
torch.library.register_fake("repro_torch::flash_attention", _flash_fwd_fake,
                            lib=_LIB)
torch.library.register_fake("repro_torch::ssd_scan", _ssd_fwd_fake, lib=_LIB)


def _flash_fwd_vmap(info, in_dims, q, k, v, causal, window, scale,
                    q_pos=None, k_pos=None, want_lse=True):
    """B5's forward folds the vmap axis into the batch axis, as its
    backward does: one call for the cohort."""
    dims = _dims(in_dims, 9)
    ts = [_batch_first(t, d, info.batch_size)
          for t, d in zip((q, k, v, q_pos, k_pos), dims[:3] + dims[6:8])]
    out, lse = torch.ops.repro_torch.flash_attention(
        *(_fold(t) for t in ts[:3]), causal, window, scale,
        *(None if t is None else _fold(t) for t in ts[3:]), want_lse)
    kb = ts[0].shape[:2]
    return (out.unflatten(0, kb),
            lse.unflatten(0, kb) if want_lse else
            lse.expand((info.batch_size, 0))), (0, 0)


def _ssd_fwd_vmap(info, in_dims, x, dt, a, b, c, chunk, h0=None,
                  keep_states=False):
    """One call per member of the vmap axis, as B6's backward."""
    dims = _dims(in_dims, 8)
    ts = [_batch_first(t, d, info.batch_size)
          for t, d in zip((x, dt, a, b, c, h0), dims[:5] + dims[6:7])]
    outs = [torch.ops.repro_torch.ssd_scan(
        *(None if t is None else t[i] for t in ts[:5]), chunk,
        None if ts[5] is None else ts[5][i], keep_states)
        for i in range(info.batch_size)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


torch.library.register_vmap("repro_torch::flash_attention", _flash_fwd_vmap,
                            lib=_LIB)
torch.library.register_vmap("repro_torch::ssd_scan", _ssd_fwd_vmap, lib=_LIB)


def _card_positions(pos: Optional[torch.Tensor], q: torch.Tensor
                    ) -> Optional[torch.Tensor]:
    """A batch's positions as B5's kernels read them: int32 on q's device,
    cast once from the batch's int64 (the plain version compares them to
    the same mask).  Any other dtype passes through, for the kernel's
    wrapper to refuse."""
    if pos is None:
        return pos
    if pos.dtype == torch.int64:
        pos = pos.to(q.device, torch.int32)
    return pos.contiguous()


class _FlashAttention(torch.autograd.Function):
    """B5 with its gradient: the forward also keeps each row's
    log-sum-exp, and the backward recomputes the probabilities from
    (q, k, v, out, lse) at the same positions, as the reference's
    ``_flash_vjp`` does.  Kernels on a CUDA tensor, the plain versions on
    a CPU tensor."""

    @staticmethod
    def forward(q, k, v, q_pos, k_pos, causal, window, scale):
        return torch.ops.repro_torch.flash_attention(
            q, k, v, causal, window, scale, q_pos, k_pos, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, q_pos, k_pos, causal, window, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.mask = dict(causal=causal, window=window, scale=scale)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, out, lse, dout, **ctx.mask, q_pos=q_pos, k_pos=k_pos)
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_pos, k_pos, causal, window, scale):
        """The vmap axis (the batched cohort's clients) folds into the
        batch axis, ``(K, B, S, H, D) -> (K*B, S, H, D)`` and batched
        positions ``(K, B, S) -> (K*B, S)``: every operand is per
        sequence, so one launch serves the whole cohort."""
        ts = [_batch_first(t, d, info.batch_size)
              for t, d in zip((q, k, v, q_pos, k_pos), in_dims)]
        out, lse = _FlashAttention.apply(
            *(None if t is None else _fold(t) for t in ts), causal, window,
            scale)
        kb = ts[0].shape[:2]
        return (out.unflatten(0, kb), lse.unflatten(0, kb)), (0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    q_pos: Optional[torch.Tensor] = None,
                    k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,S,Hq,D), k (B,S,Hkv,D), v (B,S,Hkv,Dv) -> (B,S,Hq,Dv) in q's
    dtype: softmax attention with a causal, sliding-window (``window`` >
    0) or full mask, GQA by index, fp32 accumulation; v's head dim may
    differ from q's and k's (MLA's prefill).  ``q_pos``, ``k_pos`` (B,S)
    are the tokens' positions (``None``: ``arange(S)``): the mask compares
    them, a key at a negative position (a left pad) is never attended,
    and a query that may attend no key gives 0.  Kernel B5 on a CUDA
    tensor (read in place through its strides, the positions as int32); a
    call that needs a gradient also keeps the row log-sum-exp for B5's
    backward kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q_pos, k_pos = _card_positions(q_pos, q), _card_positions(k_pos, q)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window,
                                     scale)[0]
    return torch.ops.repro_torch.flash_attention(
        q, k, v, causal, window, scale, q_pos, k_pos, False)[0]


class _SSDScan(torch.autograd.Function):
    """B6 with its gradient, from the state ``h0`` (or zero): on a CUDA
    tensor the forward keeps the state entering each chunk (chunk 0's is
    h0) and the backward kernel reads it; on a CPU tensor the backward is
    the plain one (autograd through ``ssd_scan_ref``, as the reference
    differentiates ``ssd_chunked``).  Both give ``dh0``, the gradient of
    the state entering chunk 0."""

    @staticmethod
    def forward(x, dt, a, b, c, h0, chunk):
        # the backward kernel reads the kept states; the plain backward
        # differentiates the plain scan again and ignores them
        return torch.ops.repro_torch.ssd_scan(x, dt, a, b, c, chunk, h0,
                                              True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, a, b, c, h0, chunk = inputs
        ctx.save_for_backward(x, dt, a, b, c, output[2], h0)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(output[2])
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dy, dh_last, _dstates):
        x, dt, a, b, c, states, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        *grads, dh0 = torch.ops.repro_torch.ssd_scan_bwd(
            x, dt, a, b, c, dy, states, dh_last, ctx.chunk, h0)
        return (*grads, None if h0 is None else dh0, None)

    @staticmethod
    def vmap(info, in_dims, x, dt, a, b, c, h0, chunk):
        """One call per member of the vmap axis (a client of the batched
        cohort, with its own ``h0``): ``a`` comes from each client's own
        ``A_log``, and the kernel takes one ``(H,)`` decay and sums ``da``
        over its batch, so the clients cannot fold into the batch axis as
        B5's do."""
        ts = [_batch_first(t, d, info.batch_size)
              for t, d in zip((x, dt, a, b, c, h0), in_dims)]
        outs = [_SSDScan.apply(*(None if t is None else t[i] for t in ts),
                               chunk)
                for i in range(info.batch_size)]
        return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD scan from the state ``h0`` (B,H,P,N) (``None``: zero):
    x (B,S,H,P), dt (B,S,H), a (H,), b/c (B,S,N) -> (y (B,S,H,P) in x's
    dtype, h_last (B,H,P,N) fp32), over chunks of ``min(chunk, S)`` steps
    (a ragged tail is padded with dt = 0 steps, which leave the state
    unchanged).  Kernel B6 on a CUDA tensor, with its backward kernel
    when a gradient is needed (dt, a and h0 reach it through their cast
    to fp32; h0 gets ``dh0``)."""
    q = min(chunk, x.shape[1])
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    dt, a = dt.to(torch.float32), a.to(torch.float32)
    if _needs_grad(x, dt, a, b, c, h0):
        y, h_last, _ = _SSDScan.apply(x, dt, a, b, c, h0, q)
        return y, h_last
    y, h_last, _ = torch.ops.repro_torch.ssd_scan(x, dt, a, b, c, q, h0,
                                                  False)
    return y, h_last


# ---------------------------------------------------------------------------
# DTensor sharding rules of B5, B6 and their backwards
# ---------------------------------------------------------------------------
# Every operand of B5 and B6 is per sequence and, but for B6's (H,) decay
# and its shared b/c, per head: a mesh dim may shard the batch (dim 0 of
# every sequence operand) or the heads, and sequence and head dims stay
# whole.  B5 shards query and kv heads on the same mesh dim only when
# every mesh dim divides the kv heads, so that each shard's queries meet
# their own group's keys (with one kv head, MQA, the keys stay whole and
# the queries split).  B6-bwd's ``da`` sums over the batch and its
# ``db``/``dc`` over the heads: those come out ``Partial``.
def _divides(n: int, mesh) -> bool:
    return all(n % s == 0 for s in mesh.shape)


def _opt(spec, placement):
    """The placement of an optional tensor operand (None where absent)."""
    return None if spec is None else placement


def _flash_head_split(q, k) -> str:
    """"kv": q and kv heads split together; "q": q split, kv whole (MQA);
    "": the heads stay whole."""
    hq, hkv = q.tensor_meta.shape[2], k.tensor_meta.shape[2]
    if _divides(hkv, q.mesh) and _divides(hq, q.mesh):
        return "kv"
    if hkv == 1 and _divides(hq, q.mesh):
        return "q"
    return ""


def _flash_fwd_rules(q, k, v, causal, window, scale, q_pos=None,
                     k_pos=None, want_lse=True):
    from torch.distributed.tensor import Replicate, Shard
    r, s0 = Replicate(), Shard(0)
    lse_on = Shard(0) if want_lse else Replicate()
    rules = [([r, r], [r, r, r, None, None, None, _opt(q_pos, r),
                       _opt(k_pos, r), None]),
             ([s0, lse_on], [s0, s0, s0, None, None, None, _opt(q_pos, s0),
                             _opt(k_pos, s0), None])]
    split = _flash_head_split(q, k)
    if split:
        kv = Shard(2) if split == "kv" else r
        rules.append(([Shard(2), Shard(1) if want_lse else r],
                      [Shard(2), kv, kv, None, None, None, _opt(q_pos, r),
                       _opt(k_pos, r), None]))
    return rules


def _flash_bwd_rules(q, k, v, out, lse, dout, causal, window, scale,
                     q_pos=None, k_pos=None):
    from torch.distributed.tensor import Partial, Replicate, Shard
    r, s0 = Replicate(), Shard(0)
    rules = [([r, r, r], [r] * 6 + [None] * 3 + [_opt(q_pos, r),
                                                 _opt(k_pos, r)]),
             ([s0, s0, s0], [s0] * 6 + [None] * 3 + [_opt(q_pos, s0),
                                                     _opt(k_pos, s0)])]
    split = _flash_head_split(q, k)
    if split == "kv":
        s2 = Shard(2)
        rules.append(([s2, s2, s2], [s2, s2, s2, s2, Shard(1), s2]
                      + [None] * 3 + [_opt(q_pos, r), _opt(k_pos, r)]))
    elif split == "q":
        # each query shard's gradient of the one kv head is a partial sum
        s2 = Shard(2)
        rules.append(([s2, Partial(), Partial()],
                      [s2, r, r, s2, Shard(1), s2] + [None] * 3
                      + [_opt(q_pos, r), _opt(k_pos, r)]))
    return rules


def _ssd_fwd_rules(x, dt, a, b, c, chunk, h0=None, keep_states=False):
    from torch.distributed.tensor import Replicate, Shard
    r, s0 = Replicate(), Shard(0)
    kept = s0 if keep_states else r
    rules = [([r, r, r], [r] * 5 + [None, _opt(h0, r), None]),
             ([s0, s0, kept], [s0, s0, r, s0, s0, None, _opt(h0, s0),
                               None])]
    if _divides(x.tensor_meta.shape[2], x.mesh):
        rules.append(([Shard(2), Shard(1), Shard(1) if keep_states else r],
                      [Shard(2), Shard(2), s0, r, r, None,
                       _opt(h0, Shard(1)), None]))
    return rules


def _ssd_bwd_rules(x, dt, a, b, c, dy, states, dh_last, chunk, h0=None):
    from torch.distributed.tensor import Partial, Replicate, Shard
    r, s0, p = Replicate(), Shard(0), Partial()
    kept = r if states.tensor_meta.shape[0] == 0 else s0
    rules = [([r] * 6, [r] * 7 + [_opt(dh_last, r), None, _opt(h0, r)]),
             ([s0, s0, p, s0, s0, s0],
              [s0, s0, r, s0, s0, s0, kept, _opt(dh_last, s0), None,
               _opt(h0, s0)])]
    if _divides(x.tensor_meta.shape[2], x.mesh):
        h1 = Shard(1)
        rules.append(([Shard(2), Shard(2), s0, p, p, h1],
                      [Shard(2), Shard(2), s0, r, r, Shard(2),
                       r if kept == r else h1, _opt(dh_last, h1), None,
                       _opt(h0, h1)]))
    return rules


_RULES_REGISTERED = []


def register_dtensor_rules() -> None:
    """Register the four rules with DTensor, once.  Called by whatever
    builds DTensors (``parallel/sharding.py``); importing DTensor costs
    ~0.7 s, which a process that never shards does not pay."""
    if _RULES_REGISTERED:
        return
    from torch.distributed.tensor.experimental import register_sharding
    for op, rules in ((torch.ops.repro_torch.flash_attention.default,
                       _flash_fwd_rules),
                      (torch.ops.repro_torch.flash_attention_bwd.default,
                       _flash_bwd_rules),
                      (torch.ops.repro_torch.ssd_scan.default,
                       _ssd_fwd_rules),
                      (torch.ops.repro_torch.ssd_scan_bwd.default,
                       _ssd_bwd_rules)):
        register_sharding(op)(rules)
    _RULES_REGISTERED.append(True)


# ---------------------------------------------------------------------------
# FLOP formulas of B5, B6 and their backwards, for FlopCounterMode
# ---------------------------------------------------------------------------
def _flash_fwd_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                     **kwargs) -> int:
    """Scores and ``p @ v`` over the full S x S square (the analytic
    model's convention): ``2 B H S S (D + Dv)``."""
    b, s, h, d = q_shape
    return 2 * b * h * s * k_shape[1] * (d + v_shape[-1])


def _flash_bwd_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                     **kwargs) -> int:
    """The recomputed scores, dV, dP, dQ and dK: ``2 B H S S (3D + 2Dv)``."""
    b, s, h, d = q_shape
    return 2 * b * h * s * k_shape[1] * (3 * d + 2 * v_shape[-1])


def _ssd_fwd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk,
                   *args, out_shape=None, **kwargs) -> int:
    """The SSD core per token (the analytic model's ``_ssd_flops``): the
    chunk's C B^T row, its W @ x, and the state in and out."""
    bs, s, h, p = x_shape
    n = b_shape[-1]
    q = min(chunk, s)
    t = bs * s
    return 2 * t * q * n + 2 * t * q * h * p + 4 * t * n * h * p


def _ssd_bwd_flops(*args, out_shape=None, **kwargs) -> int:
    return 2 * _ssd_fwd_flops(*args[:6])


_FLOPS_REGISTERED = []


def register_flop_formulas() -> None:
    """Teach ``torch.utils.flop_counter.FlopCounterMode`` the four
    operators' work, once (the module costs ~1.5 s to import, so only a
    caller that counts pays it)."""
    if _FLOPS_REGISTERED:
        return
    from torch.utils.flop_counter import register_flop_formula
    for op, fn in ((torch.ops.repro_torch.flash_attention, _flash_fwd_flops),
                   (torch.ops.repro_torch.flash_attention_bwd,
                    _flash_bwd_flops),
                   (torch.ops.repro_torch.ssd_scan, _ssd_fwd_flops),
                   (torch.ops.repro_torch.ssd_scan_bwd, _ssd_bwd_flops)):
        register_flop_formula(op)(fn)
    _FLOPS_REGISTERED.append(True)
