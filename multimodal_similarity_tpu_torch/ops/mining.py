"""Triplet mining and batch selection.

Two tiers, as in the JAX package's ``ops/mining.py``:

1. **Host miners** (``select_triplets_facenet``, ``select_triplets_random``,
   ``select_batch_balanced``): copies of the JAX package's NumPy functions;
   the same ``random.Random`` state gives the same indices.
2. **Device miner** (``mine_semihard_triplets`` and its row-wise
   ``..._from_embeddings``): shape-static semi-hard sampling with a
   validity mask.  ``jax.random.categorical`` is Gumbel-max, so the port
   draws three Gumbel arrays (anchors, positives, one per negative draw)
   from an explicit ``torch.Generator`` and takes the first maximum, as
   ``jnp.argmax`` does; fed the JAX draws, :func:`_mine` picks the same
   indices.
3. **Hard + structure miners** (``mine_hard_structure_triplets`` and its
   row-wise form): hard positives and negatives from a pseudo-similarity,
   and structure triplets with per-class margins, shape-static with masks.
   Four Gumbel arrays (anchors, hard positives, hard negatives, far
   negatives) come from one draw, ``_draw_structure_gumbels``, in the
   order of the JAX miner's ``split(key, 4)``.
"""

from __future__ import annotations

import itertools
import random
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_similarity_tpu_torch.ops.distances import pairwise_distance

_NEG_INF = -1e30
_POS_INF = 1e30


class MinedTriplets(NamedTuple):
    """Fixed-size mined triplet batch (padded, with a validity mask)."""

    anchor: torch.Tensor     # [T] int64 indices into the event batch
    positive: torch.Tensor   # [T]
    negative: torch.Tensor   # [T]
    mask: torch.Tensor       # [T] float32, 1.0 = real triplet
    active_count: torch.Tensor  # scalar: mean admissible negatives a pair


def _gumbel(shape, generator: Optional[torch.Generator], device
            ) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(U)) of ``shape``; U in [tiny, 1) as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(
        min=torch.finfo(torch.float32).tiny)))


def _draw_gumbels(num_pairs: int, n: int, num_negative: int,
                  generator: Optional[torch.Generator], device
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Sequence[torch.Tensor]]:
    """Standard Gumbel draws for the anchor, positive and each negative
    categorical over [num_pairs, n]."""
    def one():
        return _gumbel((num_pairs, n), generator, device)

    return one(), one(), [one() for _ in range(num_negative)]


def _categorical(gumbel: torch.Tensor, allowed: torch.Tensor,
                 logits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax(gumbel + logits) along rows, logits -1e30 where not allowed
    (the first maximum on ties, as ``jnp.argmax``)."""
    base = torch.zeros_like(gumbel) if logits is None else logits
    return torch.argmax(
        gumbel + torch.where(allowed, base, torch.full_like(base, _NEG_INF)),
        dim=1)


def _mine(labels: torch.Tensor, valid: Optional[torch.Tensor],
          dist_rows: Callable[[torch.Tensor], torch.Tensor], gumbels,
          triplet_per_batch: int, alpha: float,
          num_negative: int) -> MinedTriplets:
    """Semi-hard sampling from given Gumbel draws; ``dist_rows(anchors)``
    gives the sampled anchors' [P, N] distance rows."""
    labels = labels.reshape(-1)
    n = labels.shape[0]
    num_pairs = -(-triplet_per_batch // num_negative)
    valid_b = (torch.ones(n, dtype=torch.bool, device=labels.device)
               if valid is None else valid.reshape(-1).to(torch.bool))
    g_anchor, g_pos, g_negs = gumbels

    # per-class valid-member counts (self included) without an [N, N] mask:
    # sort-rank the raw labels into dense ids, every size fixed by N, so
    # nothing waits for the device (torch.unique's output size depends on
    # the data, which makes the host read it back)
    sorted_lab, order = torch.sort(labels)
    new_group = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=labels.device),
        (sorted_lab[1:] != sorted_lab[:-1]).to(torch.int64)])
    dense = torch.empty_like(order).scatter_(0, order,
                                             torch.cumsum(new_group, 0))
    counts = torch.zeros(n, dtype=torch.float32, device=labels.device)
    counts.index_add_(0, dense, valid_b.to(torch.float32))
    class_count = counts[dense]
    can_anchor = (labels > 0) & valid_b & (class_count >= 2)
    anchor_logw = -torch.log(class_count)
    anchors = _categorical(g_anchor, can_anchor.expand(num_pairs, n),
                           anchor_logw.expand(num_pairs, n))

    same_rows = labels[anchors][:, None] == labels[None, :]       # [P, N]
    notself = anchors[:, None] != torch.arange(n, device=labels.device)
    positives = _categorical(g_pos, same_rows & notself & valid_b)

    neg_rows = dist_rows(anchors).float()                         # [P, N]
    pos_dist = neg_rows.gather(1, positives[:, None])
    semihard = (~same_rows & valid_b & (neg_rows - pos_dist < alpha)
                & (pos_dist < neg_rows))
    has_neg = semihard.any(dim=1)
    negatives = torch.stack([_categorical(g, semihard) for g in g_negs],
                            dim=1)                                # [P, R]

    t = num_pairs * num_negative
    mask = has_neg.repeat_interleave(num_negative)[:t].float()
    return MinedTriplets(
        anchor=anchors.repeat_interleave(num_negative)[:t],
        positive=positives.repeat_interleave(num_negative)[:t],
        negative=negatives.reshape(-1)[:t],
        mask=mask * can_anchor.any().float(),
        active_count=semihard.sum(dim=1).float().mean())


def mine_semihard_triplets(dists: torch.Tensor, labels: torch.Tensor,
                           generator: Optional[torch.Generator],
                           triplet_per_batch: int, alpha: float = 0.2,
                           num_negative: int = 3,
                           valid: Optional[torch.Tensor] = None
                           ) -> MinedTriplets:
    """Sample semi-hard triplets on the device from an [N, N] distance
    matrix.

    ceil(T / num_negative) anchor-positive pairs with class-balanced
    anchors (weight 1/class-count, foreground classes with >= 2 valid
    members), a uniform same-class positive, then ``num_negative`` uniform
    draws from each pair's semi-hard set (neg - pos < alpha and pos < neg);
    pairs with none are masked out, and everything is when no class can
    anchor.  ``valid`` rows are neither anchors, positives nor negatives.
    ``generator`` (on the tensors' device) drives the draws."""
    n = labels.reshape(-1).shape[0]
    gumbels = _draw_gumbels(-(-triplet_per_batch // num_negative), n,
                            num_negative, generator, dists.device)
    return _mine(labels, valid, lambda a: dists[a], gumbels,
                 triplet_per_batch, alpha, num_negative)


def mine_semihard_triplets_from_embeddings(
        embeddings: torch.Tensor, labels: torch.Tensor,
        generator: Optional[torch.Generator], triplet_per_batch: int,
        alpha: float = 0.2, num_negative: int = 3,
        valid: Optional[torch.Tensor] = None,
        metric: str = "squaredeuclidean") -> MinedTriplets:
    """:func:`mine_semihard_triplets` with distances for the sampled anchor
    rows only ([P, N] through ``pairwise_distance``), never [N, N]."""
    emb = embeddings.float()
    n = emb.shape[0]
    gumbels = _draw_gumbels(-(-triplet_per_batch // num_negative), n,
                            num_negative, generator, emb.device)
    return _mine(labels, valid,
                 lambda a: pairwise_distance(emb[a], emb, metric), gumbels,
                 triplet_per_batch, alpha, num_negative)


class MinedMultimodal(NamedTuple):
    """Fixed-size hard + structure triplets mined from pseudo-similarities."""

    hard: torch.Tensor          # [H, 3] anchor / hard-pos / hard-neg
    hard_mask: torch.Tensor     # [H] float32
    struct: torch.Tensor        # [S, 3] anchor / hard-neg / far-neg
    struct_mask: torch.Tensor   # [S] float32
    margins: torch.Tensor       # [S] the struct group's margins


def _draw_structure_gumbels(hard_budget: int, struct_rows: int, n: int,
                            generator: Optional[torch.Generator], device
                            ) -> Tuple[torch.Tensor, ...]:
    """Standard Gumbel draws for the anchor, hard-positive and
    hard-negative categoricals over [hard_budget, n] and the far-negative
    one over [struct_rows, n], in that order."""
    return tuple(_gumbel((rows, n), generator, device) for rows in
                 (hard_budget, hard_budget, hard_budget, struct_rows))


def mine_hard_structure_triplets_rowwise(
        score_rows_fn: Callable[[torch.Tensor], torch.Tensor],
        labels: torch.Tensor, class_margins: torch.Tensor,
        generator: Optional[torch.Generator], hard_budget: int,
        struct_budget: int, threshold_up: float = 0.8,
        threshold_down: float = 0.2,
        valid: Optional[torch.Tensor] = None) -> MinedMultimodal:
    """Hard + structure mining on the device, with the pseudo-similarity
    rows of the sampled anchors only: ``score_rows_fn(anchors)`` gives
    their [H, N] rows, never [N, N].

    ``hard_budget`` anchors, drawn uniformly (with replacement) from the
    valid foreground rows; for each, a hard positive (a uniform same-label
    row with similarity under ``threshold_down``, else the least similar
    same-label row) and a hard negative (a uniform other-label row over
    ``threshold_up``, else the most similar one).  A hard triplet is masked
    out when its anchor has no positive or no negative.  The first
    ``struct_budget`` anchors also get a structure triplet (anchor, hard
    negative, far negative): a uniform row of the hard negative's label
    with similarity under ``threshold_down``, masked out when there is
    none; its margin is ``class_margins[label of the far negative]`` (an
    index past the table takes its last entry, as a JAX gather clamps).
    ``valid`` rows are neither anchors nor picked.  Nothing is read back
    to the host."""
    labels = labels.reshape(-1)
    n = labels.shape[0]
    device = labels.device
    valid_b = (torch.ones(n, dtype=torch.bool, device=device)
               if valid is None else valid.reshape(-1).to(torch.bool))
    s = min(struct_budget, hard_budget)
    g_a, g_p, g_n, g_f = _draw_structure_gumbels(hard_budget, s, n,
                                                 generator, device)
    foreground = (labels > 0) & valid_b
    anchors = _categorical(g_a, foreground.expand(hard_budget, n))

    sim_a = score_rows_fn(anchors).float()                       # [H, N]
    same_rows = labels[anchors][:, None] == labels[None, :]
    notself = anchors[:, None] != torch.arange(n, device=device)
    same_a = same_rows & notself & valid_b
    diff_a = ~same_rows & valid_b

    hp_mask = same_a & (sim_a < threshold_down)
    hard_pos = torch.where(
        hp_mask.any(dim=1), _categorical(g_p, hp_mask),
        torch.argmin(torch.where(same_a, sim_a,
                                 torch.full_like(sim_a, _POS_INF)), dim=1))
    hn_mask = diff_a & (sim_a > threshold_up)
    hard_neg = torch.where(
        hn_mask.any(dim=1), _categorical(g_n, hn_mask),
        torch.argmax(torch.where(diff_a, sim_a,
                                 torch.full_like(sim_a, -_POS_INF)), dim=1))
    hard_mask = (foreground[anchors] & same_a.any(dim=1)
                 & diff_a.any(dim=1)).float()
    hard = torch.stack([anchors, hard_pos, hard_neg], dim=1)

    s_hn = hard_neg[:s]
    fn_mask = ((labels[None, :] == labels[s_hn][:, None])
               & (sim_a[:s] < threshold_down) & valid_b)         # [S, N]
    far_neg = _categorical(g_f, fn_mask)
    struct_mask = hard_mask[:s] * fn_mask.any(dim=1).float()
    margin_idx = labels[far_neg].long().clamp(max=class_margins.shape[0] - 1)
    return MinedMultimodal(
        hard=hard, hard_mask=hard_mask,
        struct=torch.stack([anchors[:s], s_hn, far_neg], dim=1),
        struct_mask=struct_mask,
        margins=class_margins[margin_idx] * struct_mask)


def mine_hard_structure_triplets(
        sim_prob: torch.Tensor, labels: torch.Tensor,
        class_margins: torch.Tensor, generator: Optional[torch.Generator],
        hard_budget: int, struct_budget: int, threshold_up: float = 0.8,
        threshold_down: float = 0.2,
        valid: Optional[torch.Tensor] = None) -> MinedMultimodal:
    """:func:`mine_hard_structure_triplets_rowwise` on a whole [N, N]
    pseudo-similarity matrix (it reads the sampled anchors' rows)."""
    return mine_hard_structure_triplets_rowwise(
        lambda rows: sim_prob[rows], labels, class_margins, generator,
        hard_budget, struct_budget, threshold_up, threshold_down, valid)


def _shuffled_classes(np_lab: np.ndarray, rng: random.Random):
    idx_dict: dict[int, list[int]] = {}
    for i, l in enumerate(np_lab):
        idx_dict.setdefault(int(l), []).append(i)
    for key in idx_dict:
        rng.shuffle(idx_dict[key])
    return idx_dict


def select_triplets_facenet(lab, all_dist: np.ndarray,
                            triplet_per_batch: int, alpha: float = 0.2,
                            num_negative: int = 3,
                            rng: random.Random | None = None
                            ) -> Tuple[List[int], float]:
    """The reference's facenet semi-hard miner, a copy of the JAX
    package's: a flat [a, p, n, a, p, n, ...] index list and the mean count
    of admissible negatives."""
    rng = rng or random
    idx_dict = _shuffled_classes(np.asarray(lab).reshape(-1), rng)
    foreground = {k: itertools.permutations(v, 2)
                  for k, v in idx_dict.items() if k != 0}

    triplet_idx: List[int] = []
    neg_counts: List[int] = []
    while len(triplet_idx) < triplet_per_batch * 3:
        keys = list(foreground.keys())
        if not keys:
            break
        for key in keys:
            try:
                an_idx, pos_idx = next(foreground[key])
            except StopIteration:
                del foreground[key]
                continue

            pos_dist = all_dist[an_idx, pos_idx]
            neg_dist = np.array(all_dist[an_idx], dtype="float64")
            neg_dist[idx_dict[key]] = np.nan

            with np.errstate(invalid="ignore"):
                all_neg = np.where((neg_dist - pos_dist < alpha)
                                   & (pos_dist < neg_dist))[0]
            neg_counts.append(len(all_neg))

            if len(all_neg) > 0:
                for _ in range(min(len(all_neg), num_negative)):
                    neg_idx = int(all_neg[rng.randrange(len(all_neg))])
                    triplet_idx.extend([an_idx, pos_idx, neg_idx])
                    if len(triplet_idx) >= triplet_per_batch * 3:
                        return triplet_idx, float(np.mean(neg_counts))

    if triplet_idx:
        return triplet_idx, float(np.mean(neg_counts))
    return [], 0.0


def select_triplets_random(lab, triplet_per_batch: int,
                           num_negative: int = 3,
                           rng: random.Random | None = None) -> List[int]:
    """The reference's random-negative miner, a copy of the JAX package's:
    a flat [a, p, n, ...] index list (the gather happens on the device)."""
    rng = rng or random
    np_lab = np.asarray(lab).reshape(-1)
    idx_dict = _shuffled_classes(np_lab, rng)
    foreground = {k: itertools.permutations(v, 2)
                  for k, v in idx_dict.items() if k != 0}

    triplet_idx: List[int] = []
    while len(triplet_idx) < triplet_per_batch * 3:
        keys = list(foreground.keys())
        if not keys:
            break
        for key in keys:
            all_neg = np.where(np_lab != key)[0]
            try:
                an_idx, pos_idx = next(foreground[key])
            except StopIteration:
                del foreground[key]
                continue
            for _ in range(num_negative):
                neg_idx = int(all_neg[rng.randrange(len(all_neg))])
                triplet_idx.extend([an_idx, pos_idx, neg_idx])
    return triplet_idx


def select_batch_balanced(
    labels,
    batch_size: int,
    rng: random.Random | None = None,
) -> np.ndarray:
    """Class-balanced round-robin batch builder for batch-hard / lifted
    training: cycle foreground classes, taking one shuffled index from each
    until ``batch_size`` is reached; classes are recycled if exhausted.
    A copy of the JAX package's ``ops/mining.py`` function: the same rng
    state gives the same indices."""
    rng = rng or random
    np_lab = np.asarray(labels).reshape(-1)
    idx_dict: dict[int, list[int]] = {}
    for i, l in enumerate(np_lab):
        if int(l) != 0:
            idx_dict.setdefault(int(l), []).append(i)
    if not idx_dict:
        return np.zeros((0,), dtype=np.int64)
    pools = {k: list(v) for k, v in idx_dict.items()}
    for key in pools:
        rng.shuffle(pools[key])
    out: List[int] = []
    keys = list(pools.keys())
    cursor = {k: 0 for k in keys}
    while len(out) < batch_size:
        for key in keys:
            if cursor[key] >= len(pools[key]):
                rng.shuffle(pools[key])
                cursor[key] = 0
            out.append(pools[key][cursor[key]])
            cursor[key] += 1
            if len(out) >= batch_size:
                break
    return np.asarray(out, dtype=np.int64)
