"""Pairwise-distance math: through one matrix product (Gram expansion),
or from exact differences (``all_diffs`` / ``cdist``, the reference's
form, kept for the host miner that decides semi-hard ties as it does)."""

from __future__ import annotations

import torch

_EPS = 1e-12  # the reference's sqrt epsilon


def all_diffs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All pairwise differences a[i] - b[j] -> [N, M, d]: O(N M d)
    memory."""
    return a[:, None, :] - b[None, :, :]


def cdist(diff: torch.Tensor, metric: str = "squaredeuclidean"
          ) -> torch.Tensor:
    """Reduce a difference tensor to distances along its last axis."""
    if metric == "squaredeuclidean":
        return (diff * diff).sum(dim=-1)
    if metric == "euclidean":
        return torch.sqrt((diff * diff).sum(dim=-1) + _EPS)
    if metric == "l1":
        return diff.abs().sum(dim=-1)
    raise NotImplementedError(f"unknown metric: {metric}")


def cdist_rows(a: torch.Tensor, b: torch.Tensor,
               metric: str = "squaredeuclidean",
               chunk: int = 64) -> torch.Tensor:
    """``cdist(all_diffs(a, b), metric)`` ``chunk`` rows of ``a`` at a
    time: the same exact differences without the whole [N, M, d]
    tensor."""
    return torch.cat([cdist(all_diffs(a[i:i + chunk], b), metric)
                      for i in range(0, a.shape[0], chunk)])


def pairwise_distance(a: torch.Tensor, b: torch.Tensor,
                      metric: str = "squaredeuclidean") -> torch.Tensor:
    """[N, d] x [M, d] -> [N, M] f32 distances, |a|^2 + |b|^2 - 2 a.b
    clamped at zero (the Gram expansion's cancellation error); l1 has no
    product form and takes the differences."""
    if metric == "l1":
        return cdist(all_diffs(a, b), "l1")
    a = a.float()
    b = b.float()
    sq = torch.clamp((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
                     - 2.0 * (a @ b.T), min=0.0)
    if metric == "squaredeuclidean":
        return sq
    if metric == "euclidean":
        return torch.sqrt(sq + _EPS)
    raise NotImplementedError(f"unknown metric: {metric}")
