"""Metric-learning losses: the triplet family, and the batch-structured
losses over a full distance matrix (the oracles of the fused kernels)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_POS_INF = 1e30
_NEG_INF = -1e30


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).sum(dim=1)


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor,
                 negative: torch.Tensor, alpha=0.2) -> torch.Tensor:
    """max(|a-p|^2 - |a-n|^2 + alpha, 0), mean over the batch; ``alpha``
    may be a scalar or a per-triplet [N] tensor."""
    basic = _sq_dist(anchor, positive) - _sq_dist(anchor, negative) + alpha
    return torch.clamp(basic, min=0.0).mean()


def triplet_loss_masked(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, mask: torch.Tensor,
                        alpha=0.2) -> torch.Tensor:
    """Triplet loss over a fixed-size padded triplet batch: the mean over
    the triplets whose ``mask`` is 1, and 0 when none is."""
    basic = torch.clamp(_sq_dist(anchor, positive)
                        - _sq_dist(anchor, negative) + alpha, min=0.0)
    return (basic * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def weighted_triplet_loss_per_triplet(
        anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
        prob_pos: torch.Tensor, prob_neg: torch.Tensor,
        alpha: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-triplet [N] soft 4-way weighted loss (see
    :func:`weighted_triplet_loss`); returns (loss_vec, [N, 4] weights)."""

    def hinge(anc, pos, neg, a):
        return torch.clamp(_sq_dist(anc, pos) - _sq_dist(anc, neg) + a,
                           min=0.0)

    w1 = prob_pos * (1.0 - prob_neg)
    w2 = (1.0 - prob_pos) * prob_neg
    w3 = prob_pos * prob_neg
    w4 = (1.0 - prob_pos) * (1.0 - prob_neg)
    loss = (
        w1 * hinge(anchor, positive, negative, alpha)
        + w2 * hinge(anchor, negative, positive, alpha)
        + w3 * 0.5 * (hinge(anchor, positive, anchor, -alpha * 2)
                      + hinge(anchor, negative, anchor, -alpha * 2))
        + w4 * 0.5 * (hinge(anchor, anchor, positive, alpha * 2)
                      + hinge(anchor, anchor, negative, alpha * 2))
    )
    return loss, torch.stack([w1, w2, w3, w4], dim=1)


def weighted_triplet_loss(anchor: torch.Tensor, positive: torch.Tensor,
                          negative: torch.Tensor, prob_pos: torch.Tensor,
                          prob_neg: torch.Tensor, alpha: float = 0.2
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft 4-way triplet loss weighted by pair-similarity confidences.

    With p1 = P(anchor~positive), p2 = P(anchor~negative):
      w1 = p1(1-p2) * L(A,B,C),  w2 = (1-p1)p2 * L(A,C,B),
      w3 = p1 p2    * [L(A,B,A; -2a) + L(A,C,A; -2a)]/2,
      w4 = (1-p1)(1-p2) * [L(A,A,B; 2a) + L(A,A,C; 2a)]/2.
    Returns (mean loss, [N, 4] stacked weights)."""
    loss, weights = weighted_triplet_loss_per_triplet(
        anchor, positive, negative, prob_pos, prob_neg, alpha)
    return loss.mean(), weights


def _pair_masks(pids: torch.Tensor):
    """(positive_mask, negative_mask) from a label vector: positive is
    label equality off the diagonal, negative is label inequality."""
    pids = pids.reshape(-1)
    same = pids[:, None] == pids[None, :]
    eye = torch.eye(pids.shape[0], dtype=torch.bool, device=pids.device)
    return same & ~eye, ~same


def batch_hard(dists: torch.Tensor, pids: torch.Tensor, margin="soft",
               weighted: bool = True):
    """Batch-hard triplet loss ("In Defense of the Triplet Loss") over a
    dense [N, N] distance matrix; the second oracle of the fused kernels.

    For each anchor: furthest positive minus closest negative; softplus for
    margin == "soft", else hinge at ``margin``.  ``weighted`` reweights
    anchors by their negative count and masks out background (pid == 0)
    anchors.  Returns (loss, num_active, diff, weights, furthest_positive,
    closest_negative).
    """
    pids = pids.reshape(-1)
    n = dists.shape[0]
    positive_mask, negative_mask = _pair_masks(pids)

    # the reference multiplies by the mask (not a masked max): anchors with
    # no positive contribute 0, since dists >= 0
    furthest_positive = (dists * positive_mask.to(dists.dtype)).max(1).values
    closest_negative = torch.where(
        negative_mask, dists, torch.full_like(dists, _POS_INF)).min(1).values

    diff = furthest_positive - closest_negative
    if margin == "soft":
        diff = F.softplus(diff)
    else:
        diff = torch.clamp(diff + margin, min=0.0)

    foreground_mask = (pids != 0).to(dists.dtype)
    foreground_num = foreground_mask.sum()
    if weighted:
        weights = negative_mask.to(dists.dtype).sum(1) * foreground_mask
        weights = weights / weights.sum()
    else:
        weights = torch.full((n,), 1.0 / n, dtype=dists.dtype,
                             device=dists.device)

    loss = (diff * weights).sum()
    num_active = ((diff * foreground_mask) > 1e-5).to(dists.dtype).sum()
    num_active = num_active / foreground_num
    return loss, num_active, diff, weights, furthest_positive, closest_negative


def lifted_loss(dists: torch.Tensor, pids: torch.Tensor, margin: float,
                weighted: bool = True):
    """Lifted-structured loss over a dense [N, N] distance matrix; the
    second oracle of the fused lifted kernels.

    The reference takes logsumexp over ``dists * positive_mask`` along the
    full row, so masked-out entries (the self pair included) contribute
    exp(0) = 1; that is the trained objective and is kept.  The negative
    side is a masked logsumexp of (margin - dists).  Returns (loss,
    num_active = 1, diff, weights, furthest_positive, closest_negative).
    """
    pids = pids.reshape(-1)
    n = dists.shape[0]
    positive_mask, negative_mask = _pair_masks(pids)

    furthest_positive = torch.logsumexp(
        dists * positive_mask.to(dists.dtype), dim=1)
    closest_negative = torch.logsumexp(
        torch.where(negative_mask, margin - dists,
                    torch.full_like(dists, _NEG_INF)), dim=1)

    diff = torch.clamp(furthest_positive + closest_negative, min=0.0)

    foreground_mask = (pids != 0).to(dists.dtype)
    if weighted:
        weights = negative_mask.to(dists.dtype).sum(1) * foreground_mask
        weights = weights / weights.sum()
    else:
        weights = torch.full((n,), 1.0 / n, dtype=dists.dtype,
                             device=dists.device)

    loss = (diff * weights).sum()
    num_active = torch.ones((), dtype=dists.dtype, device=dists.device)
    return loss, num_active, diff, weights, furthest_positive, closest_negative
