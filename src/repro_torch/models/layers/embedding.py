"""Token embeddings, the LM head and the modality inputs (the
reference's ``embedding.py``).  The audio feature extractor and the ViT
are stubs there as here: callers pass precomputed frame or patch
embeddings; ``merge_patch_embeds`` (Qwen2-VL's early fusion) and
``masked_prediction_embed`` (HuBERT's masked frames) are real."""
from __future__ import annotations

import torch

from repro_torch.models.layers.init import dense_init, embed_init


def embedding_init(key, vocab_size: int, d_model: int) -> dict:
    return {"table": embed_init(key, (vocab_size, d_model), scale=0.02)}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather, then cast: the same bits as the reference's cast-then-gather
    return torch.nn.functional.embedding(tokens, params["table"]).to(dtype)


def lm_head_init(key, d_model: int, vocab_size: int) -> dict:
    return {"w": dense_init(key, (d_model, vocab_size))}


def lm_head(params, x: torch.Tensor) -> torch.Tensor:
    # logits in fp32 for a numerically stable softmax
    return torch.matmul(x.to(torch.float32), params["w"].to(torch.float32))


def lm_head_tied(embed_params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.to(torch.float32),
                        embed_params["table"].to(torch.float32).t())


def merge_patch_embeds(tok_embeds: torch.Tensor, patch_embeds: torch.Tensor,
                       patch_positions: torch.Tensor) -> torch.Tensor:
    """Scatter patch embeddings into the token sequence (early fusion).

    tok_embeds (B, S, D); patch_embeds (B, P, D); patch_positions (B, P)
    indices into S.  A negative position means "no patch": it is clamped
    to slot 0 and contributes nothing, so slot 0's token survives.  A
    slot that a patch lands on loses its token embedding; patches that
    land on one slot add up (the reference's ``.at[p].min`` of a keep
    mask and ``.at[p].add`` of the patches)."""
    b, s, d = tok_embeds.shape
    valid = patch_positions >= 0
    pos = torch.clamp(patch_positions, 0, s - 1).to(torch.int64)
    updates = torch.where(valid[..., None],
                          patch_embeds.to(tok_embeds.dtype),
                          torch.zeros((), dtype=tok_embeds.dtype,
                                      device=tok_embeds.device))
    keep = torch.ones((b, s), dtype=tok_embeds.dtype,
                      device=tok_embeds.device).scatter_reduce(
        1, pos, torch.where(valid, 0.0, 1.0).to(tok_embeds.dtype), "amin")
    rows = (torch.arange(b, device=pos.device)[:, None] * s + pos).reshape(-1)
    added = torch.zeros((b * s, d), dtype=tok_embeds.dtype,
                        device=tok_embeds.device).index_add(
        0, rows, updates.reshape(-1, d)).reshape(b, s, d)
    return tok_embeds * keep[..., None] + added


def masked_prediction_embed(params, frame_embeds: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """HuBERT's input: masked frames (mask (B, S) True) replaced by the
    learned ``mask_embed``."""
    m = params["mask_embed"].to(frame_embeds.dtype)
    return torch.where(mask[..., None], m, frame_embeds)
