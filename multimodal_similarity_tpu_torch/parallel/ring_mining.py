"""Ring batch-hard mining: embedding shards rotate around the process mesh.

Each rank holds one shard of the embeddings (its rows of the global
batch).  The rank first folds its own shard, then ``n - 1`` times passes
the visiting shard to rank ``(r + 1) % n`` and receives one from
``(r - 1) % n`` (``torch.distributed.batch_isend_irecv``): after rotation
s, rank r holds shard ``(r - s) mod n``.  Each fold is one f32 product of
the rank's anchors with the visiting shard and a masked max/min, so the
N x N matrix never exists and no rank holds more than two shards (the JAX
package's ``parallel/ring_mining.py``, its visit order and its strict
``>`` / ``<`` winner updates, so the winners equal JAX's, ties included).

The fold is f32 in IEEE products (``ieee_f32``: no TF32), as the JAX ring
is, not the bf16 of the single-device batch-hard kernel.  It is plain
PyTorch: the JAX ring's per-shard fold is XLA, not a Pallas kernel.

Trainable: the forward also tracks each anchor's winning positive and
negative GLOBAL index; the backward (:class:`_RingStats`) all-gathers the
embeddings, routes each rank's anchors' gradient through their winning
pairs into a global [N, d] buffer (``winning_pair_grad``), and a
reduce-scatter gives each rank the gradient of its rows.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
import torch.nn.functional as F

from multimodal_similarity_tpu_torch.ops.chunked_topk import ieee_f32
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    winning_pair_grad)
from multimodal_similarity_tpu_torch.parallel.mesh import (
    ProcessMesh, global_rank)

_POS_INF = 1e30


def rotate(buf: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """``buf`` sent to rank (r + 1) % n of the mesh; returns the one rank
    (r - 1) % n sent (``buf`` itself on a mesh of one)."""
    n, r = mesh.size, mesh.rank
    if n == 1:
        return buf
    out = torch.empty_like(buf)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf.contiguous(),
                   global_rank(mesh, (r + 1) % n), mesh.group),
        dist.P2POp(dist.irecv, out, global_rank(mesh, (r - 1) % n),
                   mesh.group)])
    for req in reqs:
        req.wait()
    return out


def all_gather_rows(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order along axis 0."""
    if mesh.size == 1:
        return x
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def reduce_scatter_rows(buf: torch.Tensor, mesh: ProcessMesh
                        ) -> torch.Tensor:
    """This rank's rows of the sum of every rank's ``buf`` [N, ...]:
    ``reduce_scatter_tensor`` under NCCL; gloo has none, so an all-reduce
    and this rank's slice there."""
    if mesh.size == 1:
        return buf
    if dist.get_backend(mesh.group) == "nccl":
        out = buf.new_empty((buf.shape[0] // mesh.size,) + buf.shape[1:])
        dist.reduce_scatter_tensor(out, buf.contiguous(), group=mesh.group)
        return out
    buf = buf.contiguous()
    dist.all_reduce(buf, group=mesh.group)
    return buf[mesh.rows(buf.shape[0])].clone()


def global_sum(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh (a detached copy, every rank)."""
    x = x.detach().clone()
    if mesh.size > 1:
        dist.all_reduce(x, group=mesh.group)
    return x


def global_value(part: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """``part`` with the value of its sum over the mesh and the gradient
    of ``part`` alone: each rank's backward then carries its own part of a
    loss whose parts sum to the global one."""
    return part + (global_sum(part, mesh) - part.detach())


def local_rows_index(m: int, mesh: ProcessMesh, device) -> torch.Tensor:
    """The global row indices of this rank's ``m`` rows."""
    return torch.arange(mesh.rank * m, (mesh.rank + 1) * m, device=device)


def _first(vals: torch.Tensor, target: torch.Tensor,
           idx_r: torch.Tensor) -> torch.Tensor:
    """Per row, the global index of the first column where ``vals``
    equals ``target`` (jnp.argmax / argmin's tie rule)."""
    cols = torch.arange(vals.shape[1], device=vals.device)
    pick = torch.where(vals == target[:, None], cols[None, :],
                       torch.full_like(cols, vals.shape[1])[None, :])
    return idx_r[pick.min(dim=1).values]


def _fold(acc, emb_l, sq_l, lab_l, idx_l, visiting, with_idx):
    """Fold the local anchors' accumulators against one visiting shard
    (packed as [emb | label | global index | norm])."""
    fp, fpi, cn, cni, nc = acc
    d = emb_l.shape[1]
    emb_r, lab_r = visiting[:, :d], visiting[:, d]
    idx_r, sq_r = visiting[:, d + 1].long(), visiting[:, d + 2]
    with ieee_f32():
        inner = emb_l @ emb_r.T
    dist_ = torch.clamp(sq_l[:, None] + sq_r[None, :] - 2.0 * inner, min=0.0)
    same = lab_l[:, None] == lab_r[None, :]
    eye = idx_l[:, None] == idx_r[None, :]
    pos_val = dist_ * (same & ~eye).to(dist_.dtype)
    neg_val = torch.where(same, torch.full_like(dist_, _POS_INF), dist_)
    t_fp = pos_val.max(dim=1).values
    t_cn = neg_val.min(dim=1).values
    if with_idx:
        fpi = torch.where(t_fp > fp, _first(pos_val, t_fp, idx_r), fpi)
        cni = torch.where(t_cn < cn, _first(neg_val, t_cn, idx_r), cni)
    fp = torch.maximum(fp, t_fp)
    cn = torch.minimum(cn, t_cn)
    nc = nc + (~same).to(dist_.dtype).sum(dim=1)
    return fp, fpi, cn, cni, nc


def _ring_stats(mesh: ProcessMesh, emb: torch.Tensor, labels: torch.Tensor,
                with_idx: bool):
    """(fp, fpi, cn, cni, nc) of this rank's rows; fpi / cni are global
    row indices (int64)."""
    emb = emb.float()
    m = emb.shape[0]
    lab = labels.reshape(-1).float()
    idx = local_rows_index(m, mesh, emb.device)
    sq = (emb * emb).sum(dim=1)
    ring = torch.cat([emb, lab[:, None], idx[:, None].float(), sq[:, None]],
                     dim=1)
    acc = (torch.zeros(m, device=emb.device),
           torch.zeros(m, dtype=torch.int64, device=emb.device),
           torch.full((m,), _POS_INF, device=emb.device),
           torch.zeros(m, dtype=torch.int64, device=emb.device),
           torch.zeros(m, device=emb.device))
    # the local shard first: only the n - 1 rotations whose shards are
    # folded happen
    acc = _fold(acc, emb, sq, lab, idx, ring, with_idx)
    for _ in range(mesh.size - 1):
        ring = rotate(ring, mesh)
        acc = _fold(acc, emb, sq, lab, idx, ring, with_idx)
    return acc


def ring_batch_hard_stats(mesh: ProcessMesh, embeddings: torch.Tensor,
                          labels: torch.Tensor):
    """This rank's rows [m, d] -> (furthest_positive [m], closest_negative
    [m], neg_count [m]) of those rows against the whole global batch.

    Semantics of the fused batch-hard stats (squared euclidean, positives
    exclude self, negatives are label-inequality).  Not differentiable:
    :func:`make_ring_batch_hard_stats_grad` is."""
    with torch.no_grad():
        fp, _, cn, _, nc = _ring_stats(mesh, embeddings, labels, False)
    return fp, cn, nc


class _RingStats(torch.autograd.Function):
    """(fp, cn, nc) of the local rows with the winner-pair gradient
    (the JAX ring's custom VJP)."""

    @staticmethod
    def forward(ctx, emb, labels, mesh):
        with_idx = ctx.needs_input_grad[0]
        fp, fpi, cn, cni, nc = _ring_stats(mesh, emb, labels, with_idx)
        if with_idx:
            ctx.mesh, ctx.emb_dtype = mesh, emb.dtype
            ctx.save_for_backward(emb.float(), fp, cn, fpi, cni)
        ctx.mark_non_differentiable(nc)
        return fp, cn, nc

    @staticmethod
    def backward(ctx, g_fp, g_cn, g_nc):
        emb, fp, cn, fpi, cni = ctx.saved_tensors
        mesh = ctx.mesh
        emb_all = all_gather_rows(emb, mesh)
        n = emb_all.shape[0]
        rows = mesh.rows(n)

        def full(x):
            out = x.new_zeros(n)
            out[rows] = x
            return out

        # this rank's anchors only: every other row has a zero cotangent
        buf = winning_pair_grad(emb_all, full(fp), full(cn), full(fpi),
                                full(cni), full(g_fp), full(g_cn))
        return reduce_scatter_rows(buf, mesh).to(ctx.emb_dtype), None, None


def make_ring_batch_hard_stats_grad(mesh: ProcessMesh):
    """Differentiable (emb [m, d], labels [m]) -> (fp, cn, nc) via the
    ring pass: gradients flow through each anchor's winning pair only."""

    def stats(emb, labels):
        return _RingStats.apply(emb, labels.reshape(-1), mesh)

    return stats


def make_ring_batch_hard_loss(mesh: ProcessMesh, margin="soft"):
    """(emb [m, d] this rank's rows, pids [m]) -> the tuple of
    ``ops.losses.batch_hard``: (loss, num_active, diff, weights,
    furthest_positive, closest_negative), weighted as the trainers take
    it: each foreground anchor by its negative count over their sum.

    ``loss`` and ``num_active`` hold the global batch's values on every
    rank (the weights' denominator and the foreground count are sums over
    the mesh); ``loss``'s gradient is that of this rank's part, so the
    parts' gradients, summed over the ranks, are the global loss's.
    ``diff``, ``weights`` and the stats are this rank's rows."""
    stats = make_ring_batch_hard_stats_grad(mesh)

    def loss_fn(emb, pids):
        pids_f = pids.reshape(-1).float()
        fp, cn, neg_count = stats(emb, pids)
        diff = fp - cn
        if margin == "soft":
            diff = F.softplus(diff)
        else:
            diff = torch.clamp(diff + margin, min=0.0)
        foreground = (pids_f != 0.0).float()
        foreground_num = global_sum(foreground.sum(), mesh)
        weights = neg_count * foreground
        weights = weights / global_sum(weights.sum(), mesh)
        loss = global_value((diff * weights).sum(), mesh)
        num_active = global_sum(
            (diff.detach() * foreground > 1e-5).float().sum(), mesh)
        return loss, num_active / foreground_num, diff, weights, fp, cn

    return loss_fn
