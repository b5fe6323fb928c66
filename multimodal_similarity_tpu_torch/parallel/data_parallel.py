"""Data-parallel training step on the process mesh.

The step body is the single-device fused semi-hard step (train/steps.py):
each rank embeds its own rows of the batch (eval mode, no gradient), the
embeddings are all-gathered for the global rowwise semi-hard mining (every
rank mines the same triplets from the same draws), and the mined [a; p; n]
rows are re-forwarded with a gradient, each rank taking its contiguous
share of the 3T rows (the JAX step's ``P("data")`` placement of
``tri_events``).  The JAX gradient is that of one global loss: every rank
computes that loss from the gathered triplet embeddings, takes the
gradient of its own share's rows, and the parameter gradients are summed
over the ranks (DDP would average them).  Adam then steps identically on
every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from multimodal_similarity_tpu_torch.data.device_feed import (
    dequant_features, take_features)
from multimodal_similarity_tpu_torch.ops.losses import triplet_loss_masked
from multimodal_similarity_tpu_torch.ops.mining import (
    mine_semihard_triplets_from_embeddings)
from multimodal_similarity_tpu_torch.parallel.mesh import ProcessMesh
from multimodal_similarity_tpu_torch.parallel.ring_mining import (
    all_gather_rows)
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, l2_regularization)
from multimodal_similarity_tpu_torch.train.steps import (
    l2_normalize, make_embed_fn)


def sum_gradients(model: nn.Module, mesh: ProcessMesh) -> None:
    """Sum every parameter gradient over the mesh, in place (one flat
    all-reduce)."""
    if mesh.size == 1:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def backward_once(loss: torch.Tensor, reg: Optional[torch.Tensor],
                  mesh: ProcessMesh) -> None:
    """``loss`` (each rank's part) backward, with the regulariser ``reg``
    (the same value on every rank) counted in rank 0's graph alone, so the
    summed gradients count it once.  The other ranks take it times zero:
    every rank then holds a gradient for the same parameters (those of
    the loss and of the regulariser), which ``sum_gradients`` needs."""
    if reg is not None:
        loss = loss + (reg if mesh.rank == 0 else 0.0 * reg)
    loss.backward()


def share(n: int, mesh: ProcessMesh) -> slice:
    """This rank's contiguous share of ``n`` rows: ceil(n / size) rows a
    rank, the last share short (or empty)."""
    c = -(-n // mesh.size)
    return slice(min(mesh.rank * c, n), min((mesh.rank + 1) * c, n))


class _GatherShares(torch.autograd.Function):
    """Every rank's share concatenated (all-gather, padded to equal
    shares); the backward keeps this rank's rows of the cotangent: every
    rank computes the same loss from the gathered rows."""

    @staticmethod
    def forward(ctx, part, n, mesh):
        c = -(-n // mesh.size)
        ctx.rows = share(n, mesh)
        pad = part.new_zeros((c,) + part.shape[1:])
        pad[:part.shape[0]] = part
        return all_gather_rows(pad, mesh)[:n]

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None, None


def gather_shares(part: torch.Tensor, n: int, mesh: ProcessMesh
                  ) -> torch.Tensor:
    """Every rank's ``share`` of ``n`` rows concatenated, on every rank,
    with a gradient for this rank's rows (the global loss is computed on
    every rank from the gathered rows)."""
    return _GatherShares.apply(part, n, mesh)


def gather_rows(events, rows: torch.Tensor, mesh: ProcessMesh, m: int):
    """This rank's ``share`` of ``rows``, read from a batch whose rank r
    holds the global rows [r m, (r + 1) m) as ``events`` (dense or the int8
    feed's {"q", "scale"}); ``rows`` is the same on every rank.  One
    all-to-all: each rank reads every rank's share from its own rows
    (clamped junk where another rank owns the row) and sends it there, so
    a rank sends and receives ceil(len(rows) / size) rows per rank; each
    kept row is then taken from its owner's block."""
    n = rows.shape[0]
    keep = share(n, mesh)
    if mesh.size == 1:
        return take_features(events, rows[keep])
    c = -(-n // mesh.size)
    # block d of the send buffer is rank d's share, padded to c rows
    local = (F.pad(rows, (0, c * mesh.size - n)) - mesh.rank * m).clamp(
        0, m - 1)
    owner = torch.div(rows[keep], m, rounding_mode="floor")
    pick = torch.arange(owner.shape[0], device=rows.device)

    def one(x):
        send = x.index_select(0, local)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group)
        return recv.view((mesh.size, c) + send.shape[1:])[owner, pick]

    if isinstance(events, dict):
        return {k: one(v) for k, v in events.items()}
    return one(events)


def make_dp_triplet_step(
    model: nn.Module,
    optimizer,
    mesh: ProcessMesh,
    *,
    triplet_per_batch: int,
    alpha: float = 0.2,
    num_negative: int = 3,
    metric: str = "squaredeuclidean",
    normalized: bool = True,
    lambda_l2: float = 0.0,
    gather_smalls: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Callable:
    """step(events, labels, mask, learning_rate) -> device scalars, with
    ``events`` this rank's rows [m, ...] of the global batch (dense or
    {"q", "scale"}) and ``labels`` / ``mask`` the global [N] vectors.

    ``gather_smalls=True`` is the ``--multihost`` feeding mode: labels and
    mask arrive as this rank's rows too, and the step all-gathers them (a
    few KB) before the global mining.  ``generator`` (on the rank's
    device, seeded alike on every rank) drives the mining draws."""
    embed = make_embed_fn(model, normalized)

    def step(events, labels: torch.Tensor, mask: torch.Tensor,
             learning_rate: float):
        if gather_smalls:
            labels = all_gather_rows(labels, mesh)
            mask = all_gather_rows(mask, mesh)
        dense = dequant_features(events)
        m = dense.shape[0]
        emb = all_gather_rows(embed(dense), mesh)
        mined = mine_semihard_triplets_from_embeddings(
            emb, labels, generator, triplet_per_batch, alpha=alpha,
            num_negative=num_negative, valid=mask, metric=metric)
        tri_idx = torch.cat([mined.anchor, mined.positive, mined.negative])

        model.train()
        optimizer.zero_grad(set_to_none=True)
        part = model(dequant_features(gather_rows(events, tri_idx, mesh,
                                                  m)))
        if normalized:
            part = l2_normalize(part)
        tri_emb = gather_shares(part, tri_idx.shape[0], mesh)
        t = mined.anchor.shape[0]
        metric_loss = triplet_loss_masked(
            tri_emb[:t], tri_emb[t:2 * t], tri_emb[2 * t:], mined.mask,
            alpha)
        reg = lambda_l2 * l2_regularization(model) if lambda_l2 else None
        backward_once(metric_loss, reg, mesh)
        sum_gradients(model, mesh)
        apply_gradients(optimizer, learning_rate)
        total = metric_loss.detach()
        if reg is not None:
            total = total + reg.detach()
        return {"loss": total, "metric_loss": metric_loss.detach(),
                "active_count": mined.active_count,
                "triplet_num": mined.mask.sum()}

    return step
