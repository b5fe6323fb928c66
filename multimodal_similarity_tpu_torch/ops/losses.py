"""Batch-structured losses over a full distance matrix."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_POS_INF = 1e30
_NEG_INF = -1e30


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
