"""One LM config run from the same weights on two devices, for holding
the card's kernels against the CPU's plain paths.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` both hold the reduced
dense-zoo configs card against CPU through :func:`card_vs_cpu`: fp32
weights from the reference's init at seed 0, with the constant-initialized
leaves (biases, LayerNorm shifts) drawn anew so that they act; a prefill
over 96 tokens and 4 teacher-forced decode steps (an encoder-only config:
the forward over 96 frames); B5's launches counted over the prefill (or
forward) and over the decode steps.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.data.lm_data import synthetic_lm_batch
from repro_torch.kernels import flash_attention
from repro_torch.models import transformer as tfm

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


def run(params: dict, cfg: ModelConfig, dev, seed: int = 1
        ) -> Tuple[List[torch.Tensor], Tuple[int, int]]:
    """Logits (on the CPU) of the prefill and each decode step, or of the
    encoder forward, and B5's launches (prefill or forward, decode)."""
    c0 = flash_attention.launches
    if cfg.encoder_only:
        frames = synthetic_lm_batch(cfg, 2, PROMPT, seed=seed)
        logits, _ = tfm.forward_train(params, cfg, {
            k: torch.from_numpy(v).to(dev) for k, v in frames.items()},
            dtype=torch.float32)
        return [logits.cpu()], (flash_attention.launches - c0, 0)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, PROMPT + STEPS)))
    logits, cache = tfm.prefill(params, cfg,
                                {"tokens": toks[:, :PROMPT].to(dev)},
                                dtype=torch.float32, max_len=PROMPT + STEPS)
    outs, c1 = [logits.cpu()], flash_attention.launches
    for i in range(STEPS):
        step, cache = tfm.decode_step(
            params, cfg, cache, toks[:, PROMPT + i:PROMPT + i + 1].to(dev),
            dtype=torch.float32)
        outs.append(step.cpu())
    return outs, (c1 - c0, flash_attention.launches - c1)


def card_vs_cpu(cfg: ModelConfig, dev="cuda", seed: int = 1
                ) -> Dict[str, object]:
    """``cfg`` on the CPU and on ``dev`` from the same weights, on tokens
    or frames drawn from ``seed``: each output's max |dev - cpu| /
    max(|cpu|, 1) (``devs``), B5's launches on each (``launches``), and the
    weights on ``dev`` (``params``)."""
    cpu = init_acting(cfg)
    on_dev = tree_to(cpu, dev)
    (out_c, n_c), (out_d, n_d) = (run(cpu, cfg, "cpu", seed),
                                  run(on_dev, cfg, dev, seed))
    devs = [float((d - c).abs().max()) / max(float(c.abs().max()), 1.0)
            for c, d in zip(out_c, out_d)]
    return {"devs": devs, "launches": {"cpu": n_c, "dev": n_d},
            "params": on_dev}
