"""Embedding helpers shared by the trainers."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn


def l2_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    # tf.nn.l2_normalize floors the squared SUM at epsilon (not epsilon^2):
    # x * rsqrt(max(sum(x^2), eps)); near-zero vectors stay near zero
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


def make_embed_fn(model: nn.Module, normalized: bool = True) -> Callable:
    """Eval-mode, no-grad embedding function ``embed(x)``; it restores the
    module's train/eval mode on return."""

    def embed(x: torch.Tensor) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                emb = model(x)
        finally:
            model.train(was_training)
        return l2_normalize(emb) if normalized else emb

    return embed


def embed_in_chunks(embed_fn: Callable, events, device: torch.device,
                    chunk: int = 256) -> torch.Tensor:
    """Embed a host array or a tensor ``chunk`` rows at a time; returns the
    embeddings on ``device``."""
    out = []
    for start in range(0, events.shape[0], chunk):
        block = events[start:start + chunk]
        if isinstance(block, np.ndarray):
            block = torch.from_numpy(np.ascontiguousarray(block))
        out.append(embed_fn(block.to(device)))
    return torch.cat(out, dim=0)
