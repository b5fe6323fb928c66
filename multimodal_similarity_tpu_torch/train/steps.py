"""Train steps and embedding helpers shared by the trainers.

``make_triplet_train_step`` is the JAX package's fused semi-hard step:
an eval-mode embedding of the whole event batch (no gradient, no dropout),
semi-hard mining on the device, then a train-mode re-forward of the
selected triplets alone, the masked triplet loss and one optimizer step.
``make_gathered_triplet_step`` trains on host-mined triplet indices.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch.data.device_feed import (
    dequant_features, take_features)
from multimodal_similarity_tpu_torch.ops.distances import pairwise_distance
from multimodal_similarity_tpu_torch.ops.losses import triplet_loss_masked
from multimodal_similarity_tpu_torch.ops.mining import (
    mine_semihard_triplets_from_embeddings)
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, l2_regularization)


def l2_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    # tf.nn.l2_normalize floors the squared SUM at epsilon (not epsilon^2):
    # x * rsqrt(max(sum(x^2), eps)); near-zero vectors stay near zero
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


_PAD_DIST = 1e30


def masked_self_distance(emb: torch.Tensor, mask: torch.Tensor,
                         metric: str) -> torch.Tensor:
    """[N, N] self-distances with a zero diagonal, and padding rows and
    columns (``mask`` 0) pushed to +1e30 off the diagonal."""
    d = pairwise_distance(emb, emb, metric)
    n = d.shape[0]
    d = d * (1.0 - torch.eye(n, dtype=d.dtype, device=d.device))
    invalid = 1.0 - mask.to(d.dtype)
    return d + invalid[None, :] * _PAD_DIST + invalid[:, None] * _PAD_DIST


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
                    chunk: int = 256,
                    beat: Optional[Callable[[], None]] = None
                    ) -> torch.Tensor:
    """Embed a host array or a tensor ``chunk`` rows at a time; returns the
    embeddings on ``device``.  ``beat`` (a watchdog heartbeat) is called
    after each chunk."""
    out = []
    for start in range(0, events.shape[0], chunk):
        block = events[start:start + chunk]
        if isinstance(block, np.ndarray):
            block = torch.from_numpy(np.ascontiguousarray(block))
        out.append(embed_fn(block.to(device)))
        if beat is not None:
            beat()
    return torch.cat(out, dim=0)


def _triplet_update(model: nn.Module, optimizer, events, tri_idx, tri_mask,
                    alpha: float, normalized: bool, lambda_l2: float,
                    learning_rate: float):
    """Train-mode forward of the [a; p; n] rows ``tri_idx`` of ``events``
    (gathered in the feed's storage type, then dequantized), the masked
    triplet loss (+ L2) and one optimizer step.  Returns (total, metric
    loss) as device scalars."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    emb = model(dequant_features(take_features(events, tri_idx)))
    if normalized:
        emb = l2_normalize(emb)
    t = tri_mask.shape[0]
    metric_loss = triplet_loss_masked(emb[:t], emb[t:2 * t], emb[2 * t:],
                                      tri_mask, alpha)
    total = metric_loss
    if lambda_l2:
        total = total + lambda_l2 * l2_regularization(model)
    total.backward()
    apply_gradients(optimizer, learning_rate)
    return total.detach(), metric_loss.detach()


def make_triplet_train_step(model: nn.Module, optimizer, *,
                            triplet_per_batch: int, alpha: float = 0.2,
                            num_negative: int = 3,
                            metric: str = "squaredeuclidean",
                            normalized: bool = True, lambda_l2: float = 0.0,
                            generator: Optional[torch.Generator] = None
                            ) -> Callable:
    """Fused embed -> mine -> re-forward -> triplet-loss step.

    Returns step(events, labels, mask, learning_rate) -> device scalars.
    ``events`` is a dense tensor or the int8 feed's {"q", "scale"};
    ``generator`` (on the device) drives the mining draws."""
    embed = make_embed_fn(model, normalized)

    def step(events, labels: torch.Tensor, mask: torch.Tensor,
             learning_rate: float):
        mined = mine_semihard_triplets_from_embeddings(
            embed(dequant_features(events)), labels, generator,
            triplet_per_batch, alpha=alpha, num_negative=num_negative,
            valid=mask, metric=metric)
        tri_idx = torch.cat([mined.anchor, mined.positive, mined.negative])
        total, metric_loss = _triplet_update(
            model, optimizer, events, tri_idx, mined.mask, alpha,
            normalized, lambda_l2, learning_rate)
        return {"loss": total, "metric_loss": metric_loss,
                "active_count": mined.active_count,
                "triplet_num": mined.mask.sum()}

    return step


def make_gathered_triplet_step(model: nn.Module, optimizer, *,
                               alpha: float = 0.2, normalized: bool = True,
                               lambda_l2: float = 0.0) -> Callable:
    """Step for host-mined triplets: step(events, tri_idx [3T] in [a; p;
    n] order, tri_mask [T], learning_rate) -> device scalars."""

    def step(events, tri_idx: torch.Tensor, tri_mask: torch.Tensor,
             learning_rate: float):
        total, metric_loss = _triplet_update(
            model, optimizer, events, tri_idx, tri_mask, alpha, normalized,
            lambda_l2, learning_rate)
        return {"loss": total, "metric_loss": metric_loss,
                "triplet_num": tri_mask.sum()}

    return step
