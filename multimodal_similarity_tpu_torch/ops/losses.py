"""Batch-structured losses over a full distance matrix."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_POS_INF = 1e30


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
    same = pids[:, None] == pids[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=dists.device)
    positive_mask = same & ~eye
    negative_mask = ~same

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
