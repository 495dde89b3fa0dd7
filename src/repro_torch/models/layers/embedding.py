"""Token embeddings and the LM head (the text path of the reference's
``embedding.py``; the modality frontends join with ROADMAP.md A16)."""
from __future__ import annotations

import torch

from repro_torch.models.layers.init import dense_init, embed_init


def embedding_init(vocab_size: int, d_model: int, *, generator,
                   device) -> dict:
    return {"table": embed_init((vocab_size, d_model), generator=generator,
                                device=device, scale=0.02)}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather, then cast: the same bits as the reference's cast-then-gather
    return torch.nn.functional.embedding(tokens, params["table"]).to(dtype)


def lm_head_init(d_model: int, vocab_size: int, *, generator,
                 device) -> dict:
    return {"w": dense_init((d_model, vocab_size), generator=generator,
                            device=device)}


def lm_head(params, x: torch.Tensor) -> torch.Tensor:
    # logits in fp32 for a numerically stable softmax
    return torch.matmul(x.to(torch.float32), params["w"].to(torch.float32))


def lm_head_tied(embed_params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.to(torch.float32),
                        embed_params["table"].to(torch.float32).t())
