"""Pairwise-distance math through one matrix product (Gram expansion)."""

from __future__ import annotations

import torch

_EPS = 1e-12  # the reference's sqrt epsilon


def pairwise_distance(a: torch.Tensor, b: torch.Tensor,
                      metric: str = "squaredeuclidean") -> torch.Tensor:
    """[N, d] x [M, d] -> [N, M] f32 distances, |a|^2 + |b|^2 - 2 a.b
    clamped at zero (the Gram expansion's cancellation error)."""
    a = a.float()
    b = b.float()
    sq = torch.clamp((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
                     - 2.0 * (a @ b.T), min=0.0)
    if metric == "squaredeuclidean":
        return sq
    if metric == "euclidean":
        return torch.sqrt(sq + _EPS)
    raise NotImplementedError(f"unknown metric: {metric}")
