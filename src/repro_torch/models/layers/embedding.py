"""Token embeddings and the LM head (the text path of the reference's
``embedding.py``; the modality frontends join with ROADMAP.md A16)."""
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
