"""Sharded-gallery retrieval on the process mesh.

Each rank holds a contiguous block of the gallery's rows (rank r the rows
``[r m, (r + 1) m)``) and the same queries.  A rank takes the top-k of the
queries against its own rows, with global indices; one all-gather brings
every rank's candidates to every rank, in rank order, and a second top-k
over them gives every rank the same [Q, k] answer.  No rank ever holds
more than its own [Q, m] distances, and the local top-k goes through
``ops/chunked_topk.py``: on a card the fused kernel, which holds no
distance block at all, elsewhere the walk in chunks of ``chunk`` rows (the
JAX package's ``parallel/sharded_eval.py`` takes the dense [Q, m] block;
they give the same candidates).

Ties: the merge selects with ``smallest_k``, which takes the lowest
position among equal distances, as ``jax.lax.top_k`` does.  A position in
the gathered list is rank-major, then local order, and each rank's list
is ascending with the lowest row first among equals, so equal distances
come out in global-index order, the JAX functions' order.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from multimodal_similarity_tpu_torch.ops.chunked_topk import (
    chunked_topk, chunked_topk_quantized, smallest_k)
from multimodal_similarity_tpu_torch.parallel.mesh import ProcessMesh
from multimodal_similarity_tpu_torch.parallel.multihost import GlobalRows
from multimodal_similarity_tpu_torch.parallel.ring_mining import (
    all_gather_rows)


def _shard(mesh: ProcessMesh, gallery: Union[torch.Tensor, GlobalRows]
           ) -> Tuple[torch.Tensor, int]:
    """(this rank's rows, the global index of its first row).  A tensor is
    this rank's rows of a gallery of ``size x rows`` rows; a
    :class:`GlobalRows` also names the gallery's size, which must divide
    by the world size, and its rows must be this rank's block of it."""
    if isinstance(gallery, GlobalRows):
        n = gallery.global_rows
        if n % mesh.size:
            raise ValueError(f"gallery size {n} not divisible by mesh "
                             f"{mesh.size}")
        rows = mesh.rows(n)
        if (gallery.offset, gallery.local.shape[0]) != (
                rows.start, rows.stop - rows.start):
            raise ValueError(
                f"rank {mesh.rank} holds gallery rows [{gallery.offset}, "
                f"{gallery.offset + gallery.local.shape[0]}), not its "
                f"block [{rows.start}, {rows.stop})")
        return gallery.local, gallery.offset
    return gallery, mesh.rank * gallery.shape[0]


def _merge(mesh: ProcessMesh, cand_d: torch.Tensor, cand_i: torch.Tensor,
           k: int):
    """Every rank's [Q, kk] candidates gathered along the columns in rank
    order, then their k smallest: the same (d, idx) [Q, k] on every
    rank."""
    if mesh.size == 1:
        return cand_d, cand_i
    q, kk = cand_d.shape
    all_d = all_gather_rows(cand_d[None], mesh).permute(1, 0, 2).reshape(
        q, mesh.size * kk)
    all_i = all_gather_rows(cand_i[None], mesh).permute(1, 0, 2).reshape(
        q, mesh.size * kk)
    best_d, pos = smallest_k(all_d, min(k, all_d.shape[1]))
    return best_d, all_i.gather(1, pos)


def sharded_retrieval_topk(mesh: ProcessMesh, queries: torch.Tensor,
                           gallery: Union[torch.Tensor, GlobalRows],
                           k: int = 32, metric: str = "euclidean",
                           chunk: Optional[int] = None):
    """-> (dists [Q, k], global indices [Q, k]), ascending, the same on
    every rank.  ``queries`` are replicated; ``gallery`` is this rank's
    rows (a tensor, or a :class:`GlobalRows` that names the gallery's
    size: one that does not divide by the world size raises ValueError).
    Pad a gallery upstream with rows far from every query (the index pads
    with 1e15).  ``chunk`` bounds the local distance block (default: the
    whole shard)."""
    shard, offset = _shard(mesh, gallery)
    m = shard.shape[0]
    kk = min(k, m)
    d, loc = chunked_topk(queries, shard, k=kk, chunk=chunk or m,
                          metric=metric)
    return _merge(mesh, d, loc + offset, k)


def sharded_retrieval_topk_quantized(
        mesh: ProcessMesh, queries: torch.Tensor,
        q_gallery: Union[torch.Tensor, GlobalRows], scale: torch.Tensor,
        gsq: torch.Tensor, k: int = 32, metric: str = "euclidean",
        chunk: Optional[int] = None):
    """:func:`sharded_retrieval_topk` over an int8 gallery (rows g = s *
    qg): this rank's ``q_gallery`` rows with their ``scale`` and exact
    squared norms ``gsq``, distances by the exact scale-factored identity
    of ``chunked_topk_quantized``.  Euclidean metrics only.  Padding rows
    must carry a ``gsq`` far above every real row's (the index uses 1e30)
    so that they never win a local top-k."""
    if metric not in ("euclidean", "squaredeuclidean"):
        raise NotImplementedError(
            f"int8 gallery supports euclidean metrics, not {metric!r}")
    shard, offset = _shard(mesh, q_gallery)
    m = shard.shape[0]
    kk = min(k, m)
    d, loc = chunked_topk_quantized(queries, shard, scale, gsq, k=kk,
                                    chunk=chunk or m, metric=metric)
    return _merge(mesh, d, loc + offset, k)
