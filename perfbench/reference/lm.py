"""Plain PyTorch forward pass and loss of the benchmark's LM configurations.

float32 throughout, written from the published descriptions and kept
apart from the program under test (it imports nothing of it):

* a token embedding, ``num_layers`` blocks, a final RMSNorm and the LM
  head (or the tied embedding), the mean next-token cross-entropy;
* ``kind == "hybrid"`` (Hymba, arXiv:2411.13676, sliding-window path):
  ``x += 1/2 (beta_a RMSNorm(attn(h)) + beta_m RMSNorm(ssm(h)))`` with
  ``h = RMSNorm(x)``, then ``x += SwiGLU(RMSNorm(x))``; the attention
  is grouped-query, rotary (rotate-half), causal within a sliding window
  (key ``k`` is seen from query ``q`` when ``q - window < k <= q``),
  with the scores materialized;
* ``kind == "ssm"`` (Mamba-2, arXiv:2405.21060): ``x += mamba2(RMSNorm(x))``;
  the SSD scan in its chunked dual form, the decays within a chunk from a
  masked cumulative sum (no difference of large cumulative sums).

Weights are a tree ``{"embed": {"table"}, "lm_head": {"w"}, "final_norm":
{"scale"}, "layers": [...]}`` with the per-layer leaves named as the
benchmark makes them (``perfbench/fedbench/inputs.py``); ``x @ w`` with
``w`` stored (in, out).

``Products`` carries the precision of every matrix product: ``"fp32"``,
or ``"tf32"`` (the control): on a CUDA device PyTorch's TF32 switch, on
the CPU each operand rounded to TF32's 10-bit mantissa first.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest
    even; what a tensor core reads of an fp32 operand.  The gradient
    passes through as it is."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


class Products:
    """Matrix products at a stated precision (module docstring)."""

    def __init__(self, precision: str = "fp32", device="cpu"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}: fp32 or tf32")
        self.precision = precision
        self.emulate = precision == "tf32" \
            and torch.device(device).type != "cuda"

    @contextlib.contextmanager
    def active(self):
        """Within the block the CUDA products run at this precision."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        on = self.precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    def _ops(self, *xs):
        return tuple(round_tf32(x) for x in xs) if self.emulate else xs

    def mm(self, a, b):
        a, b = self._ops(a, b)
        return a @ b

    def einsum(self, eq, a, b):
        a, b = self._ops(a, b)
        return torch.einsum(eq, a, b)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta):
    """Rotate-half rotary embedding at positions ``0..S-1``; x (B,S,H,D)."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, cfg, h, pr: Products):
    b, s, _ = h.shape
    hq, hkv, d = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    g = hq // hkv
    q = rope(pr.mm(h, p["wq"]).view(b, s, hq, d), cfg["rope_theta"])
    k = rope(pr.mm(h, p["wk"]).view(b, s, hkv, d), cfg["rope_theta"])
    v = pr.mm(h, p["wv"]).view(b, s, hkv, d)
    scores = pr.einsum("bqhgd,bkhd->bhgqk", q.view(b, s, hkv, g, d), k) \
        * d ** -0.5
    pos = torch.arange(s, device=h.device)
    seen = pos[None, :] <= pos[:, None]
    if cfg.get("sliding_window"):
        seen = seen & (pos[None, :] > pos[:, None] - cfg["sliding_window"])
    probs = torch.softmax(scores.masked_fill(~seen, float("-inf")), dim=-1)
    out = pr.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, s, hq * d)
    return pr.mm(out, p["wo"])


def _segsum(a):
    """a (..., Q) -> (..., Q, Q): ``sum_{j<r<=i} a_r`` at [i, j] for
    i >= j, -inf above the diagonal; each entry a sum of its own terms."""
    q = a.shape[-1]
    rep = a[..., :, None].expand(a.shape + (q,))          # [r, j] = a_r
    below = torch.tril(torch.ones(q, q, dtype=torch.bool, device=a.device),
                       -1)
    seg = torch.cumsum(rep.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(q, q, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a_neg, bm, cm, chunk, pr: Products):
    """y_t = sum_{s<=t} (C_t . B_s) exp(sum_{s<r<=t} dt_r a) dt_s x_s from a
    zero state.  x (B,S,H,P), dt (B,S,H), a_neg (H,), bm/cm (B,S,N)."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, bm, cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, bm, cm))
    nc = x.shape[1] // chunk
    x = x.reshape(b, nc, chunk, h, p)
    bm = bm.reshape(b, nc, chunk, n)
    cm = cm.reshape(b, nc, chunk, n)
    dth = dt.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)      # (B,H,c,Q)
    seg = _segsum(dth * a_neg[None, :, None, None])           # (B,H,c,Q,Q)
    cb = pr.einsum("bcin,bcjn->bcij", cm, bm)                 # (B,c,Q,Q)
    w = cb[:, None] * torch.exp(seg) * dth[..., None, :]
    y = pr.einsum("bhcij,bcjhp->bcihp", w, x)
    # the state each chunk leaves, then the states entering the chunks
    to_end = torch.exp(seg[..., -1, :]) * dth                 # (B,H,c,Q)
    xw = x * to_end.permute(0, 2, 3, 1)[..., None]
    states = pr.einsum("bcjn,bcjhp->bchpn", bm, xw)
    whole = torch.exp(torch.sum(dth * a_neg[None, :, None, None], dim=-1))
    state = torch.zeros(b, h, p, n, dtype=x.dtype, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = whole[:, :, c, None, None] * state + states[:, c]
    hs = torch.stack(entering, dim=1)                         # (B,c,H,P,N)
    from_start = torch.exp(torch.cumsum(dth * a_neg[None, :, None, None],
                                        dim=-1))              # (B,H,c,Q)
    y_in = pr.einsum("bcin,bchpn->bcihp", cm, hs)
    y = y + y_in * from_start.permute(0, 2, 3, 1)[..., None]
    return y.reshape(b, nc * chunk, h, p)[:, :s]


def mamba2(p, cfg, h, pr: Products):
    b, s, d = h.shape
    n, hp = cfg["ssm_state_dim"], cfg["ssm_head_dim"]
    d_in = cfg["ssm_expand"] * d
    nh = d_in // hp
    z, xs, bm, cm, dt = torch.split(pr.mm(h, p["in_proj"]),
                                    [d_in, d_in, n, n, nh], dim=-1)
    conv_in = torch.cat([xs, bm, cm], dim=-1)
    width = p["conv_w"].shape[0]
    padded = F.pad(conv_in, (0, 0, width - 1, 0))
    conv = p["conv_b"] + sum(padded[:, i:i + s] * p["conv_w"][i]
                             for i in range(width))
    xs, bm, cm = torch.split(F.silu(conv), [d_in, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    xh = xs.reshape(b, s, nh, hp)
    y = ssd(xh, dt, -torch.exp(p["A_log"]), bm, cm, cfg["ssm_chunk_size"],
            pr)
    y = (y + p["D"][:, None] * xh).reshape(b, s, d_in)
    y = rmsnorm(y * F.silu(z), p["norm"]["scale"], cfg["norm_eps"])
    return pr.mm(y, p["out_proj"])


def _block(lp, cfg, x, pr: Products):
    eps = cfg["norm_eps"]
    if cfg["kind"] == "ssm":
        return x + mamba2(lp["mixer"], cfg, rmsnorm(x, lp["norm"]["scale"],
                                                    eps), pr)
    if cfg["kind"] != "hybrid":
        raise ValueError(f"kind {cfg['kind']!r} has no plain reference here")
    mix = lp["mixer"]
    h = rmsnorm(x, lp["attn_norm"]["scale"], eps)
    a = rmsnorm(attention(mix["attn"], cfg, h, pr), mix["attn_norm"]["scale"],
                eps) * mix["beta_attn"]
    m = rmsnorm(mamba2(mix["ssm"], cfg, h, pr), mix["ssm_norm"]["scale"],
                eps) * mix["beta_ssm"]
    x = x + 0.5 * (a + m)
    h = rmsnorm(x, lp["ffn_norm"]["scale"], eps)
    f = lp["ffn"]
    return x + pr.mm(F.silu(pr.mm(h, f["w_gate"])) * pr.mm(h, f["w_up"]),
                     f["w_down"])


def mean_token_loss(params: Mapping[str, Any], cfg: Dict[str, Any],
                    docs: torch.Tensor, pr: Products) -> torch.Tensor:
    """Mean next-token cross-entropy of documents ``docs`` (B, S + 1)."""
    tokens, labels = docs[:, :-1], docs[:, 1:]
    x = params["embed"]["table"][tokens]
    for lp in params["layers"]:
        x = _block(lp, cfg, x, pr)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    head = params["embed"]["table"].t() if cfg["tie_embeddings"] \
        else params["lm_head"]["w"]
    logits = pr.mm(x, head)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
