"""Ring lifted-structured statistics: the multi-process counterpart of the
fused lifted kernels (the JAX package's ``parallel/ring_lifted.py``).

Same topology as ``ring_mining``: each rank holds one embedding shard; at
every ring step it folds its anchors' online-logsumexp accumulators
against the visiting shard (one f32 product and exp tiles) and passes the
shard on to rank ``(r + 1) % n``.  The N x N value matrices never exist.

Reference semantics: networks.py:835-870, as ``ops/kernels/lifted.py`` —
fp_i = logsumexp over positives' distances with valid non-positives
contributing exp(0); cn_i = logsumexp over margin - dist for negatives.

Trainable: the backward (:class:`_RingLifted`) runs a SECOND ring of ``n``
rotations.  Each step recomputes the C tile for (local anchors x visiting
shard), C = g_fp softmax_pos - g_cn softmax_neg, adds the row side to the
local gradient and the column side, 2 (colsum(C) e_r - C^T E_l), to a
gradient buffer that TRAVELS WITH the visiting shard; after ``n``
rotations every buffer is home with every rank's contribution.

Products are IEEE f32 (``ieee_f32``); the folds are plain PyTorch, as the
JAX ring's are XLA, not Pallas.
"""

from __future__ import annotations

import torch

from multimodal_similarity_tpu_torch.ops.chunked_topk import ieee_f32
from multimodal_similarity_tpu_torch.parallel.mesh import ProcessMesh
from multimodal_similarity_tpu_torch.parallel.ring_mining import (
    global_sum, global_value, local_rows_index, rotate)

_POS_INF = 1e30
_NEG_INF = -1e30


def _pack(emb, lab, idx, sq, val):
    return torch.cat([emb, lab[:, None], idx[:, None].float(), sq[:, None],
                      val[:, None]], dim=1)


def _tile_vals(emb_l, sq_l, lab_l, idx_l, visiting, margin):
    """(v_pos, v_neg, pos_m, neg_m, emb_r) for the local anchors x the
    visiting shard (packed as [emb | label | index | norm | valid])."""
    d = emb_l.shape[1]
    emb_r, lab_r = visiting[:, :d], visiting[:, d]
    idx_r, sq_r, val_r = (visiting[:, d + 1].long(), visiting[:, d + 2],
                          visiting[:, d + 3])
    with ieee_f32():
        inner = emb_l @ emb_r.T
    dist = torch.clamp(sq_l[:, None] + sq_r[None, :] - 2.0 * inner, min=0.0)
    same = lab_l[:, None] == lab_r[None, :]
    eye = idx_l[:, None] == idx_r[None, :]
    pos_m = same & ~eye
    penalty = (1.0 - val_r[None, :]) * _POS_INF
    v_pos = torch.where(pos_m, dist, torch.zeros_like(dist)) - penalty
    v_neg = torch.where(same, torch.full_like(dist, _NEG_INF),
                        margin - dist - penalty)
    neg_m = torch.where(same, torch.zeros_like(dist),
                        val_r[None, :].expand_as(dist))
    return v_pos, v_neg, pos_m, neg_m, emb_r


def _merge(acc_m, acc_s, v):
    t_max = v.max(dim=1).values
    t_sum = torch.exp(v - t_max[:, None]).sum(dim=1)
    new_m = torch.maximum(acc_m, t_max)
    new_s = acc_s * torch.exp(acc_m - new_m) + t_sum * torch.exp(t_max - new_m)
    return new_m, new_s


def _local(emb, labels, valid, mesh):
    emb = emb.float()
    lab = labels.reshape(-1).float()
    idx = local_rows_index(emb.shape[0], mesh, emb.device)
    sq = (emb * emb).sum(dim=1)
    return emb, lab, idx, sq, _pack(emb, lab, idx, sq,
                                    valid.reshape(-1).float())


def _ring_lifted_fwd(mesh, emb, labels, valid, margin):
    """Forward ring; the local shard is folded first, so only the n - 1
    rotations whose shards are folded happen."""
    emb, lab, idx, sq, ring = _local(emb, labels, valid, mesh)
    m = emb.shape[0]
    fp_m = torch.full((m,), _NEG_INF, device=emb.device)
    cn_m = fp_m.clone()
    fp_s = torch.zeros(m, device=emb.device)
    cn_s, nc = fp_s.clone(), fp_s.clone()
    for s in range(mesh.size):
        if s:
            ring = rotate(ring, mesh)
        v_pos, v_neg, _, neg_m, _ = _tile_vals(emb, sq, lab, idx, ring,
                                               margin)
        fp_m, fp_s = _merge(fp_m, fp_s, v_pos)
        cn_m, cn_s = _merge(cn_m, cn_s, v_neg)
        nc = nc + neg_m.sum(dim=1)
    fp = fp_m + torch.log(torch.clamp(fp_s, min=1e-30))
    cn = cn_m + torch.log(torch.clamp(cn_s, min=1e-30))
    return fp, cn, nc


def _ring_lifted_bwd(mesh, emb, labels, valid, fp, cn, g_fp, g_cn, margin):
    """Backward ring: the local row-side gradient plus the column-side
    buffer that rotates with the visiting shard and comes home after n
    rotations."""
    emb, lab, idx, sq, ring = _local(emb, labels, valid, mesh)
    grad_l = torch.zeros_like(emb)
    grad_r = torch.zeros_like(emb)
    for _ in range(mesh.size):
        v_pos, v_neg, pos_m, neg_m, emb_r = _tile_vals(emb, sq, lab, idx,
                                                       ring, margin)
        soft_pos = torch.exp(v_pos - fp[:, None]) * pos_m
        soft_neg = torch.exp(v_neg - cn[:, None]) * neg_m
        c = g_fp[:, None] * soft_pos - g_cn[:, None] * soft_neg
        with ieee_f32():
            grad_l = grad_l + 2.0 * (c.sum(dim=1)[:, None] * emb - c @ emb_r)
            grad_r = grad_r + 2.0 * (c.sum(dim=0)[:, None] * emb_r
                                     - c.T @ emb)
        both = rotate(torch.cat([ring, grad_r], dim=1), mesh)
        ring, grad_r = both[:, :ring.shape[1]], both[:, ring.shape[1]:]
    return grad_l + grad_r


class _RingLifted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, labels, valid, mesh, margin):
        fp, cn, nc = _ring_lifted_fwd(mesh, emb, labels, valid, margin)
        if ctx.needs_input_grad[0]:
            ctx.mesh, ctx.margin, ctx.emb_dtype = mesh, margin, emb.dtype
            ctx.save_for_backward(emb, labels, valid, fp, cn)
        ctx.mark_non_differentiable(nc)
        return fp, cn, nc

    @staticmethod
    def backward(ctx, g_fp, g_cn, g_nc):
        emb, labels, valid, fp, cn = ctx.saved_tensors
        grad = _ring_lifted_bwd(ctx.mesh, emb, labels, valid, fp, cn, g_fp,
                                g_cn, ctx.margin)
        return grad.to(ctx.emb_dtype), None, None, None, None


def make_ring_lifted_stats_grad(mesh: ProcessMesh, margin: float):
    """Differentiable (emb [m, d] this rank's rows, labels [m], valid [m])
    -> (fp, cn, nc) of those rows against the whole global batch."""

    def stats(emb, labels, valid):
        return _RingLifted.apply(emb, labels.reshape(-1),
                                 valid.reshape(-1).float(), mesh, margin)

    return stats


def make_ring_lifted_loss(mesh: ProcessMesh, margin: float):
    """(emb [m, d] this rank's rows, pids [m], valid [m] or None) -> the
    tuple of ``ops.losses.lifted_loss``, each valid foreground anchor
    weighted by its negative count over their sum; ``loss`` holds the
    global value with this rank's part's gradient
    (``ring_mining.global_value``)."""
    stats = make_ring_lifted_stats_grad(mesh, margin)

    def loss_fn(emb, pids, valid=None):
        pids_f = pids.reshape(-1).float()
        valid_f = (torch.ones_like(pids_f) if valid is None
                   else valid.reshape(-1).float())
        fp, cn, neg_count = stats(emb, pids, valid_f)
        diff = torch.clamp(fp + cn, min=0.0)
        foreground = (pids_f != 0.0).float() * valid_f
        weights = neg_count * foreground
        weights = weights / global_sum(weights.sum(), mesh)
        loss = global_value((diff * weights).sum(), mesh)
        one = torch.ones((), dtype=torch.float32, device=emb.device)
        return loss, one, diff, weights, fp, cn

    return loss_fn
