"""Metric-learning losses: the triplet family, the batch-structured
losses over a full distance matrix (the oracles of the fused kernels), and
the Deep CCA and classification losses."""

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


def _relu_even(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) whose gradient splits evenly where x == 0, as
    ``jnp.maximum`` does (``clamp`` passes all of it).  The losses below
    also reduce with ``amin`` / ``amax``, which split the gradient evenly
    among tied entries as ``jnp.min`` / ``jnp.max`` do: duplicated rows tie
    exactly."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def npairs_loss(labels: torch.Tensor, embeddings_anchor: torch.Tensor,
                embeddings_positive: torch.Tensor,
                reg_lambda: float = 0.002) -> torch.Tensor:
    """N-pairs loss (tf.contrib metric_learning ``npairs_loss``): cross
    entropy between the anchor-positive similarity logits and the
    row-normalised label-equality matrix, plus 0.25 reg_lambda (mean |a|^2
    + mean |p|^2)."""
    labels = labels.reshape(-1)
    reg_anchor = (embeddings_anchor ** 2).sum(1).mean()
    reg_positive = (embeddings_positive ** 2).sum(1).mean()
    l2loss = 0.25 * reg_lambda * (reg_anchor + reg_positive)
    similarity = embeddings_anchor.float() @ embeddings_positive.float().T
    labels_equal = (labels[:, None] == labels[None, :]).to(similarity.dtype)
    targets = labels_equal / labels_equal.sum(1, keepdim=True)
    xent = -(targets * F.log_softmax(similarity, dim=1)).sum(1)
    return xent.mean() + l2loss


def triplet_semihard_loss(labels: torch.Tensor, embeddings: torch.Tensor,
                          margin: float = 1.0) -> torch.Tensor:
    """Semi-hard triplet loss (tf.contrib metric_learning).

    For every anchor-positive pair (i, j): the negative n with the
    smallest D(i, n) among those with D(i, n) > D(i, j) strictly
    ("outside"); when none is, the furthest negative ("inside").  Hinge at
    ``margin``, averaged over the positive pairs.  Distances are the
    euclidean ones of the Gram expansion, with contrib's guard: the sqrt of
    a non-positive square gets 1e-16 added and the result zeroed."""
    labels = labels.reshape(-1)
    x = embeddings.float()
    sq = (x * x).sum(1)
    pdist_sq = _relu_even(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T))
    error_mask = pdist_sq > 0.0
    pdist = torch.sqrt(pdist_sq + torch.where(error_mask, 0.0, 1e-16))
    pdist = pdist * error_mask.to(pdist.dtype)

    adjacency = labels[:, None] == labels[None, :]
    adjacency_not = ~adjacency
    n = labels.shape[0]

    # pair (i, j): among negatives k of anchor i, the smallest pdist[i, k]
    # with pdist[i, k] > pdist[i, j]; mask[i, j, k]
    greater = pdist[:, None, :] > pdist[:, :, None]
    mask_outside = adjacency_not[:, None, :] & greater
    neg_outside = torch.where(mask_outside, pdist[:, None, :],
                              torch.full_like(pdist[:, None, :], _POS_INF)
                              ).amin(2)
    has_outside = mask_outside.any(2)
    neg_inside = torch.where(adjacency_not, pdist,
                             torch.full_like(pdist, _NEG_INF)).amax(1)
    semi_hard = torch.where(has_outside, neg_outside,
                            neg_inside[:, None].expand(n, n))
    loss_mat = margin + pdist - semi_hard

    eye = torch.eye(n, dtype=torch.bool, device=labels.device)
    mask_positives = (adjacency & ~eye).to(loss_mat.dtype)
    num_positives = torch.clamp(mask_positives.sum(), min=1e-16)
    return _relu_even(loss_mat * mask_positives).sum() / num_positives


def _entropy_terms(joint: torch.Tensor, dims=(-2, -1)):
    """(MI, H(a), H(b)) of joint distributions over their last two axes."""
    pa = joint.sum(dims[1])
    pb = joint.sum(dims[0])
    log_pa = torch.log(torch.where(pa > 0, pa, torch.ones_like(pa)))
    log_pb = torch.log(torch.where(pb > 0, pb, torch.ones_like(pb)))
    log_j = torch.log(torch.where(joint > 0, joint, torch.ones_like(joint)))
    mi = torch.where(joint > 0,
                     joint * (log_j - log_pa[..., :, None]
                              - log_pb[..., None, :]),
                     torch.zeros_like(joint)).sum(dims)
    return mi, -(pa * log_pa).sum(-1), -(pb * log_pb).sum(-1)


def _nmi(mi, ha, hb):
    both_single = (ha < 1e-12) & (hb < 1e-12)
    return torch.where(both_single, torch.ones_like(mi),
                       mi / torch.clamp(torch.sqrt(ha * hb), min=1e-10))


def normalized_mutual_information(assign_a: torch.Tensor,
                                  assign_b: torch.Tensor,
                                  n: int) -> torch.Tensor:
    """NMI between two integer labelings with values in [0, n), with the
    geometric average (MI / sqrt(H(a) H(b)), sklearn's
    ``normalized_mutual_info_score`` of the tf.contrib era): 1.0 when both
    are one cluster, 0 when exactly one is."""
    eye = torch.arange(n, device=assign_a.device)
    a_oh = (assign_a.reshape(-1)[:, None] == eye[None, :]).float()
    b_oh = (assign_b.reshape(-1)[:, None] == eye[None, :]).float()
    joint = (a_oh.T @ b_oh) / a_oh.shape[0]
    return _nmi(*_entropy_terms(joint))


def _batched_candidate_nmi(d: torch.Tensor, min_d: torch.Tensor,
                           nearest: torch.Tensor, class_id: torch.Tensor,
                           chunk: int = 16) -> torch.Tensor:
    """For every candidate facility j, the NMI between the true classes and
    the assignment after adding j to the facility set (a point moves to j
    iff strictly closer than its current facility).  Walks the candidates
    ``chunk`` at a time: O(chunk n^2) memory.  Returns [n]."""
    n = d.shape[0]
    eye = torch.arange(n, device=d.device)
    b_oh = (class_id[:, None] == eye[None, :]).float()          # [i, b]
    out = []
    for start in range(0, n, chunk):
        js = eye[start:start + chunk]                            # [c]
        moved = d[:, js] < min_d[:, None]                        # [i, c]
        assign = torch.where(moved, js[None, :], nearest[:, None])
        a_oh = (assign[:, :, None] == eye[None, None, :]).float()  # [i,c,a]
        joint = torch.einsum("ija,ib->jab", a_oh, b_oh) / n
        out.append(_nmi(*_entropy_terms(joint)))
    return torch.cat(out)


def cluster_loss(labels: torch.Tensor, embeddings: torch.Tensor,
                 margin_multiplier: float = 1.0,
                 enable_pam_finetuning: bool = True) -> torch.Tensor:
    """Facility-location clustering loss (tf.contrib metric_learning
    ``cluster_loss`` with margin_type 'nmi'), as the JAX package computes
    it: (1) loss-augmented greedy facility selection, K = the number of
    distinct labels, each step adding the candidate with the largest
    energy + margin_multiplier (1 - NMI); (2) one PAM sweep re-picking each
    cluster's medoid among its members by the same score; (3) the hinge of
    the augmented predicted score against the oracle per-class best-medoid
    score.  Selections are index decisions on detached distances: the
    first maximum (``argmax``), ties to the lowest index; the gradient
    flows through the distances of the fixed selection."""
    labels = labels.reshape(-1)
    n = labels.shape[0]
    x = embeddings.float()
    sq = (x * x).sum(1)
    d = _relu_even(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T))
    idx = torch.arange(n, device=d.device)

    one_hot_classes = labels[:, None] == labels[None, :]
    class_first = torch.where(one_hot_classes, idx[None, :],
                              torch.full_like(one_hot_classes, n,
                                              dtype=idx.dtype)).min(1).values
    is_first = class_first == idx
    num_classes = int(is_first.sum())

    d_sg = d.detach()
    mm = float(margin_multiplier)

    def augmented_score(min_d, nearest):
        energy = -torch.minimum(min_d[:, None], d_sg).sum(0)
        nmi = _batched_candidate_nmi(d_sg, min_d, nearest, class_first)
        return energy + mm * (1.0 - nmi)

    # (1) loss-augmented greedy facility selection
    min_d = torch.full((n,), _POS_INF, device=d.device)
    nearest = torch.zeros(n, dtype=torch.int64, device=d.device)
    chosen = torch.full((n,), -1, dtype=torch.int64, device=d.device)
    for k in range(num_classes):
        score = torch.where(torch.isin(idx, chosen),
                            torch.full_like(min_d, -_POS_INF),
                            augmented_score(min_d, nearest))
        j = torch.argmax(score)
        nearest = torch.where(d_sg[:, j] < min_d, j, nearest)
        min_d = torch.minimum(min_d, d_sg[:, j])
        chosen[k] = j

    # (2) one PAM sweep: re-pick each slot's medoid among its cluster's
    # members (itself included) by the same score
    if enable_pam_finetuning:
        for m in range(num_classes):
            slot_valid = (idx < num_classes) & (idx != m)
            safe = torch.clamp(chosen, min=0)
            d_ch = torch.where(slot_valid[None, :], d_sg[:, safe],
                               torch.full_like(d_sg, _POS_INF))
            other_min = d_ch.min(1).values
            other_near = safe[torch.argmin(d_ch, dim=1)]
            score = augmented_score(other_min, other_near)
            member = d_sg[:, chosen[m]] <= other_min
            score = torch.where(member, score,
                                torch.full_like(score, -_POS_INF))
            j = torch.argmax(score)
            min_d = torch.minimum(other_min, d_sg[:, j])
            nearest = torch.where(d_sg[:, j] < other_min, j, other_near)
            chosen[m] = j

    # (3) the predicted score of the fixed facility set, differentiable
    score_pred = -d[idx, nearest].sum()
    margin = mm * (1.0 - normalized_mutual_information(nearest, class_first,
                                                       n))
    # oracle: each class's best medoid, medoid_cost[j] = the distance from
    # j's class members to j
    medoid_cost = torch.where(one_hot_classes, d, torch.zeros_like(d)).sum(0)
    best_per_class = torch.where(
        one_hot_classes, medoid_cost[None, :],
        torch.full_like(d, _POS_INF)).amin(1)
    score_gt = -torch.where(is_first, best_per_class,
                            torch.zeros_like(best_per_class)).sum()
    return _relu_even(score_pred + margin - score_gt)


# ---------------------------------------------------------------------------
# DCCA and classification
# ---------------------------------------------------------------------------

def _inv_sqrt(s: torch.Tensor) -> torch.Tensor:
    """S^-1/2 from ``torch.linalg.eigh``; eigenvalues at or under 1e-12
    get a zero weight (the reference drops those directions).  The inner
    ``where`` keeps the gradient of the dropped branch finite."""
    d, v = torch.linalg.eigh(s)
    valid = d > 1e-12
    d_isqrt = torch.where(
        valid, 1.0 / torch.sqrt(torch.where(valid, d, torch.ones_like(d))),
        torch.zeros_like(d))
    return (v * d_isqrt[None, :]) @ v.T


def dcca_loss(x1: torch.Tensor, x2: torch.Tensor, k: int = 0,
              rcov1: float = 1e-4, rcov2: float = 1e-4) -> torch.Tensor:
    """Deep CCA correlation loss: minus the sum of the top ``k`` canonical
    correlations of the two views (all of them when ``k`` is 0).

    Mean-centre both views, form the ``rcov``-regularised covariances over
    n - 1, whiten with eigh-based inverse square roots, and sum the top
    singular values of the whitened cross-covariance."""
    n = x1.shape[0]
    d1, d2 = x1.shape[1], x2.shape[1]
    if k == 0:
        k = min(d1, d2)
    x1 = x1 - x1.mean(dim=0, keepdim=True)
    x2 = x2 - x2.mean(dim=0, keepdim=True)
    denom = float(n - 1)
    s11 = x1.T @ x1 / denom + rcov1 * torch.eye(d1, dtype=x1.dtype,
                                                device=x1.device)
    s22 = x2.T @ x2 / denom + rcov2 * torch.eye(d2, dtype=x2.dtype,
                                                device=x2.device)
    s12 = x1.T @ x2 / denom
    t = _inv_sqrt(s11) @ s12 @ _inv_sqrt(s22)
    return -torch.linalg.svdvals(t)[:k].sum()


def classification_loss(logits: torch.Tensor, labels: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean softmax cross entropy and accuracy over the batch."""
    labels = labels.reshape(-1).long()
    log_probs = F.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(1, labels[:, None])[:, 0]
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return nll.mean(), acc
