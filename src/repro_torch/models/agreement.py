"""One LM config run from the same weights on two devices, for holding
the card's kernels against the CPU's plain paths.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` both hold the reduced
dense-zoo configs card against CPU through :func:`card_vs_cpu`: fp32
weights from the reference's init at seed 0, with the constant-initialized
leaves (biases, LayerNorm shifts) drawn anew so that they act; a prefill
over 96 tokens and 4 teacher-forced decode steps (an encoder-only config:
the forward over 96 frames); B5's launches counted over the prefill (or
forward) and over the decode steps.

A MoE config routes each token to its top-k experts, and a token whose
k-th and (k+1)-th probabilities nearly tie may pick another expert on
the card than on the CPU, so :func:`card_vs_cpu` compares the expert
sets first (:func:`routing_flips`): a token whose set differs is a
documented flip only where that gap is within ``gap_tol`` on either
device, and its row (one routing group, and the row its attention
carries the change along) is left out of the logits bound from then on;
any other difference is reported.  :func:`grads_card_vs_cpu` holds the
training objective the same way: ``train_loss`` and every gradient leaf
over a 2 x 96 training batch, through B5's backward kernel on the card,
the rows a flip reached left out of the batch on both devices.  Both
take ``pads``: a batch of left-padded rows with their ``positions``.
:func:`ssm_state_card_vs_cpu` holds a Mamba-2 layer from a carried state
(B6 from ``h0``, its backward's ``dh0``) card against CPU.
:func:`dense_mixture` is the plain version of a MoE layer: every expert
on every token, weighted by the renormalized top-k gates.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.data.lm_data import synthetic_lm_batch
from repro_torch.kernels import flash_attention
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import moe

# the leaves the reference initializes to a constant
CONSTANT_LEAVES = ("bq", "bk", "bv", "b_up", "b_down", "bias")
PROMPT, STEPS = 96, 4


def tree_to(tree, dev):
    """A params tree (dicts and lists of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def init_acting(cfg: ModelConfig, seed: int = 1) -> dict:
    """fp32 CPU params of ``cfg`` from key 0, the constant leaves of every
    layer moved by 0.1 x a normal draw from ``seed``."""
    params = tfm.init_params(prng.PRNGKey(0), cfg)
    g = torch.Generator().manual_seed(seed)
    for lp in params["layers"]:
        for part in lp.values():
            for name, leaf in part.items():
                if name in CONSTANT_LEAVES:
                    leaf += 0.1 * torch.randn(leaf.shape, generator=g)
    return params


def left_pad_positions(pads: Sequence[int], s: int) -> np.ndarray:
    """(len(pads), s) positions ``arange(s) - pad`` of left-padded rows."""
    return np.stack([np.arange(s) - p for p in pads])


def run(params: dict, cfg: ModelConfig, dev, seed: int = 1,
        pads: Sequence[int] = ()
        ) -> Tuple[List[torch.Tensor], Tuple[int, int]]:
    """Logits (on the CPU) of the prefill and each decode step, or of the
    encoder forward, and B5's launches (prefill or forward, decode).
    With ``pads`` (one a row of the batch of 2) the batch carries the
    left-padded rows' ``positions``."""
    c0 = flash_attention.launches
    extra = {"positions": torch.from_numpy(left_pad_positions(
        pads, PROMPT)).to(dev)} if pads else {}
    if cfg.encoder_only:
        frames = synthetic_lm_batch(cfg, 2, PROMPT, seed=seed)
        logits, _ = tfm.forward_train(params, cfg, {
            **{k: torch.from_numpy(v).to(dev) for k, v in frames.items()},
            **extra}, dtype=torch.float32)
        return [logits.cpu()], (flash_attention.launches - c0, 0)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, PROMPT + STEPS)))
    logits, cache = tfm.prefill(params, cfg,
                                {"tokens": toks[:, :PROMPT].to(dev), **extra},
                                dtype=torch.float32, max_len=PROMPT + STEPS)
    outs, c1 = [logits.cpu()], flash_attention.launches
    for i in range(STEPS):
        step, cache = tfm.decode_step(
            params, cfg, cache, toks[:, PROMPT + i:PROMPT + i + 1].to(dev),
            dtype=torch.float32)
        outs.append(step.cpu())
    return outs, (c1 - c0, flash_attention.launches - c1)


def card_vs_cpu(cfg: ModelConfig, dev="cuda", seed: int = 1,
                gap_tol: float = 1e-5, pads: Sequence[int] = ()
                ) -> Dict[str, object]:
    """``cfg`` on the CPU and on ``dev`` from the same weights, on tokens
    or frames drawn from ``seed``: each output's max |dev - cpu| /
    max(|cpu|, 1) (``devs``) over the rows no routing flip reached (all
    rows without MoE layers; empty if flips reached every row), the
    flips and the rows left out, ``strays`` (expert sets that differ
    without a near-tie: a fault), B5's launches on each (``launches``),
    and the weights on ``dev`` (``params``).  ``pads``: left-padded rows
    (:func:`run`)."""
    cpu = init_acting(cfg)
    on_dev = tree_to(cpu, dev)
    with moe.record_routes() as routes_c:
        out_c, n_c = run(cpu, cfg, "cpu", seed, pads)
    with moe.record_routes() as routes_d:
        out_d, n_d = run(on_dev, cfg, dev, seed, pads)
    flips, rows, strays = routing_flips(routes_c, routes_d, gap_tol)
    keep = [r for r in range(out_c[0].shape[0]) if r not in rows]
    devs = [float((d[keep] - c[keep]).abs().max())
            / max(float(c[keep].abs().max()), 1.0)
            for c, d in zip(out_c, out_d)] if keep else []
    return {"devs": devs, "flips": flips, "rows_left_out": sorted(rows),
            "strays": strays, "launches": {"cpu": n_c, "dev": n_d},
            "params": on_dev}

def _rows(name: str, v: np.ndarray, keep: List[int]) -> np.ndarray:
    """Batch entry ``name`` at rows ``keep`` (M-RoPE's positions are
    (3, B, S))."""
    return np.ascontiguousarray(v[:, keep] if name == "mrope_positions"
                                else v[keep])


def grads_card_vs_cpu(cfg: ModelConfig, dev="cuda", seed: int = 1,
                      gap_tol: float = 1e-5, pads: Sequence[int] = ()
                      ) -> Dict[str, object]:
    """``train_loss`` and its gradient with respect to every leaf of
    ``cfg``'s fp32 weights (:func:`init_acting`) on the CPU and on
    ``dev``, over ``synthetic_lm_batch(cfg, 2, 96, seed=seed)``.  A
    forward pass on each device first finds the routing flips
    (:func:`routing_flips`); the rows they reached leave the batch on
    both devices.  Returns the loss's |dev - cpu| / |cpu| (``loss_dev``),
    each leaf's max |dev - cpu| / max |cpu| (``grad_devs``, by the
    layer-stacked name of ``tfm.stack_layers``), the flips, the rows left
    out, the ``strays``, and B5's forward and backward launches on each
    (``launches``: (forward, backward)).  With ``pads`` the batch carries
    the left-padded rows' ``positions``."""
    cpu = init_acting(cfg)
    batch = synthetic_lm_batch(cfg, 2, PROMPT, seed=seed)
    if pads:
        batch["positions"] = left_pad_positions(pads, PROMPT)
    routes = []
    for where in ("cpu", dev):
        params = cpu if where == "cpu" else tree_to(cpu, dev)
        with torch.no_grad(), moe.record_routes() as r:
            tfm.forward_train(params, cfg, {
                k: torch.from_numpy(v).to(where) for k, v in batch.items()},
                dtype=torch.float32)
        routes.append(r)
    flips, rows, strays = routing_flips(routes[0], routes[1], gap_tol)
    keep = [r for r in range(2) if r not in rows]
    out = {"flips": flips, "rows_left_out": sorted(rows), "strays": strays,
           "loss_dev": None, "grad_devs": {}, "launches": {}}
    if not keep:
        return out
    got = {}
    for where in ("cpu", dev):
        params = tfm.stack_layers(cpu if where == "cpu"
                                  else tree_to(cpu, dev))
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        c0 = (flash_attention.launches, flash_attention.bwd_launches)
        with torch.enable_grad():
            loss = tfm.train_loss(
                tfm.unstack_layers(leaves), cfg,
                {k: torch.from_numpy(_rows(k, v, keep)).to(where)
                 for k, v in batch.items()}, dtype=torch.float32)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        out["launches"][where if where == "cpu" else "dev"] = (
            flash_attention.launches - c0[0],
            flash_attention.bwd_launches - c0[1])
        got[where] = (float(loss.detach()), {k: g.cpu() for k, g
                                     in zip(leaves, grads)})
    (lc, gc), (ld, gd) = got["cpu"], got[dev]
    out["loss_dev"] = abs(ld - lc) / max(abs(lc), 1e-30)
    out["grad_devs"] = {k: float((gd[k] - g).abs().max())
                        / max(float(g.abs().max()), 1e-30)
                        for k, g in gc.items()}
    return out


def ssm_state_card_vs_cpu(cfg: ModelConfig, dev="cuda", seed: int = 1
                          ) -> Dict[str, object]:
    """The first layer's ``mamba2_apply`` of an SSM config from a carried
    ``ssm_state`` (a continued sequence: B6 from ``h0``) over 2 x 96
    steps, on the CPU and on ``dev`` from the same weights and draws:
    max |dev - cpu| / max(|cpu|, 1) of y and the returned state, and of
    the gradient with respect to ``ssm_state`` through B6's backward
    (``dh0``), and B6's forward and backward launches on ``dev``."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.models.layers import mamba2
    lp = init_acting(cfg)["layers"][0]["mixer"]
    _, nh, _ = mamba2.mamba2_dims(cfg)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, PROMPT, cfg.d_model), generator=g)
    state = 0.5 * torch.randn((2, nh, cfg.ssm.head_dim, cfg.ssm.state_dim),
                              generator=g)
    wy, wh = torch.randn(x.shape, generator=g), torch.randn(state.shape,
                                                            generator=g)
    got, launches = {}, (0, 0)
    for where in ("cpu", dev):
        c0 = (ssd_scan.launches, ssd_scan.bwd_launches)
        st = state.to(where).requires_grad_(True)
        with torch.enable_grad():
            y, (_, h_last) = mamba2.mamba2_apply(
                tree_to(lp, where), cfg, x.to(where), ssm_state=st)
            loss = torch.sum(y * wy.to(where)) \
                + torch.sum(h_last * wh.to(where))
            (dst,) = torch.autograd.grad(loss, st)
        got[where] = [t.detach().cpu() for t in (y, h_last, dst)]
        launches = (ssd_scan.launches - c0[0], ssd_scan.bwd_launches - c0[1])
    return {"devs": [float((d - c).abs().max()) / max(float(c.abs().max()),
                                                      1.0)
                     for c, d in zip(got["cpu"], got[dev])],
            "launches": launches}


def dense_mixture(params: dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    """A MoE layer's plain version, with no groups and no capacity:
    ``silu(x W_g) * (x W_u) W_d`` of every expert on every token, weighted
    by the token's top-k gates (renormalized when k > 1, zero outside its
    top k), plus the shared expert.  ``moe.moe_apply`` gives this when
    nothing drops."""
    d, k = x.shape[-1], cfg.moe.top_k
    xt = x.reshape(-1, d)
    probs = F.softmax(torch.matmul(xt.to(torch.float32),
                                   params["router"].to(torch.float32)), -1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = ranked[:, :k], order[:, :k]
    if k > 1:
        gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(xt)
    for e in range(cfg.moe.num_experts):
        h = F.silu(xt @ params["w_gate"][e].to(x.dtype)) \
            * (xt @ params["w_up"][e].to(x.dtype))
        w = torch.where(ids == e, gates, 0.0).sum(-1)
        y = y + w[:, None].to(x.dtype) * (h @ params["w_down"][e].to(x.dtype))
    if "shared" in params:
        sp = params["shared"]
        y = y + (F.silu(xt @ sp["w_gate"].to(x.dtype))
                 * (xt @ sp["w_up"].to(x.dtype))) @ sp["w_down"].to(x.dtype)
    return y.reshape(x.shape)


def routing_flips(ref_routes, dev_routes, gap_tol: float):
    """Walk two runs' routes (``moe.record_routes``, the same calls in the
    same order, one routing group a row): ``(flips, rows, strays)`` — the
    tokens whose expert sets differ where their k-th and (k+1)-th
    probabilities are within ``gap_tol`` on either device, the rows such a
    flip reached (left out from then on: their hidden states and drops
    may differ after it), and the differing tokens of untouched rows
    without such a tie, as ``(call, row, position, gap)``."""
    flips, rows, strays = 0, set(), []
    for call, (a, b) in enumerate(zip(ref_routes, dev_routes)):
        sets_a = torch.sort(a["experts"].cpu(), dim=-1).values
        sets_b = torch.sort(b["experts"].cpu(), dim=-1).values
        gap = torch.minimum(a["gap"].cpu(), b["gap"].cpu())
        new = set()
        for row, pos in (sets_a != sets_b).any(-1).nonzero().tolist():
            if row in rows:
                continue
            if float(gap[row, pos]) <= gap_tol:
                flips += 1
                new.add(row)
            else:
                strays.append((call, row, pos, float(gap[row, pos])))
        rows |= new
    return flips, rows, strays

