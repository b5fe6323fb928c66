"""Streaming top-k retrieval over a chunked gallery.

For galleries too large for the [Q, N] distance matrix, walk the gallery in
chunks of C rows with a running top-k merge: per chunk one [Q, d] x [d, C]
product and one k-smallest selection over the [Q, k + C] candidates.  The
loop is plain Python with no host sync inside, so the chunks queue on the
stream; memory is O(Q (k + C)), independent of N.

On a CUDA device, :func:`chunked_topk` at a euclidean metric and k <= 64
runs instead one hand-written kernel over the whole gallery
(``ops/kernels/topk.py``): the same exact top-k, in the same order, of
distances whose products it forms in 3xTF32, with no [Q, C] block and no
sort in device memory; ``chunk`` then does not apply.  The counters
``topk.fused`` and ``topk.walk`` (``utils/profiling.py``) count the calls
each way took.

Precision: every product of the walk is IEEE f32 (``ieee_f32``: no TF32,
whatever the process-wide setting), as the JAX package's products are.

Ties: :func:`smallest_k` returns the lowest position first among equal
distances (``jax.lax.top_k``'s rule, which ``torch.topk`` does not
promise).  The candidates are [best so far, this chunk], both in gallery
order, so the lowest gallery index wins a tie.  Slots beyond N (k > N)
carry distance 1e30 and index -1.
"""

from __future__ import annotations

import contextlib

import torch

from multimodal_similarity_tpu_torch.ops.distances import pairwise_distance
from multimodal_similarity_tpu_torch.ops.kernels.topk import (
    sqdist_topk_kernel, takes_kernel)
from multimodal_similarity_tpu_torch.utils.profiling import count, span

_POS_INF = 1e30


@contextlib.contextmanager
def ieee_f32():
    """cuBLAS f32 products in IEEE f32 (no TF32) inside the block, whatever
    the process-wide setting, which is restored after it.  Set through
    ``fp32_precision`` where torch has it: torch refuses a read of either
    TF32 flag once the two APIs disagree, and restoring the value read
    leaves the flags as the caller set them."""
    flags = torch.backends.cuda.matmul
    key, ieee = (("fp32_precision", "ieee") if hasattr(flags, "fp32_precision")
                 else ("allow_tf32", False))
    prev = getattr(flags, key)
    setattr(flags, key, ieee)
    try:
        yield
    finally:
        setattr(flags, key, prev)


def smallest_k(d: torch.Tensor, k: int):
    """The k smallest entries of each row of the non-negative f32 ``d``
    [Q, M], ascending, the lower column first among equal values: (values
    [Q, k], columns [Q, k] int64).

    A non-negative f32 orders as its bit pattern does, so each entry
    becomes the int64 key (bits << 32) | column: the keys are distinct and
    one ``torch.topk`` over them gives jax.lax.top_k's order exactly."""
    key = (d + 0.0).view(torch.int32).to(torch.int64)  # -0.0 -> +0.0
    key <<= 32
    key |= torch.arange(d.shape[1], device=d.device)
    key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    values = (key >> 32).to(torch.int32).view(torch.float32)
    return values, key & 0xFFFFFFFF


def _merge(best_d, best_i, d, start: int, k: int):
    """Top-k of [best so far, chunk distances ``d`` of gallery rows start,
    start + 1, ...]."""
    with span("topk.select"):
        best_d_new, pos = smallest_k(torch.cat([best_d, d], dim=1), k)
        from_best = best_i.gather(1, pos.clamp(max=k - 1))
        return best_d_new, torch.where(pos < k, from_best, pos - k + start)


def _init(nq: int, k: int, device):
    """The running top-k before the first chunk: no row yet."""
    with span("topk.select"):
        return (torch.full((nq, k), _POS_INF, dtype=torch.float32,
                           device=device),
                torch.full((nq, k), -1, dtype=torch.int64, device=device))


def split_bf16_inner(q: torch.Tensor, g16: torch.Tensor) -> torch.Tensor:
    """f32-accurate [Q, d] x [C, d]^T contraction against gallery rows that
    bf16 holds exactly (int8 values).

    The f32 query splits into bf16 hi + lo parts (q = hi + lo, |lo| <=
    2^-8 |q|), as the JAX function does.  Its two bf16 products accumulate
    in f32 there; here each is an IEEE f32 product of the bf16-rounded
    operands, exact per term in f32, so the sum equals the JAX one up to
    summation order.  Both halves go through one product ([2Q, d])."""
    qhi = q.to(torch.bfloat16)
    qlo = (q - qhi.float()).to(torch.bfloat16)
    with ieee_f32():
        both = torch.cat([qhi, qlo]).float() @ g16.float().T
    return both[:q.shape[0]] + both[q.shape[0]:]


def chunked_topk(queries: torch.Tensor, gallery: torch.Tensor, k: int = 32,
                 chunk: int = 4096, metric: str = "euclidean"):
    """-> (dists [Q, k], indices [Q, k]) ascending, exact; ``gallery`` on
    the queries' device.  The kernel where :func:`takes_kernel` says so,
    else :func:`walk_topk`."""
    if takes_kernel(queries, metric, k):
        count("topk.fused")
        return sqdist_topk_kernel(queries, gallery, k, metric)
    return walk_topk(queries, gallery, k, chunk, metric)


def walk_topk(queries: torch.Tensor, gallery: torch.Tensor, k: int,
              chunk: int, metric: str):
    """The walk: ``chunk`` gallery rows a product, each merged into the
    running top-k."""
    count("topk.walk")
    q = queries.float()
    best_d, best_i = _init(q.shape[0], k, q.device)
    with ieee_f32():
        for start in range(0, gallery.shape[0], chunk):
            with span("topk.product"):
                d = pairwise_distance(q, gallery[start:start + chunk],
                                      metric)
            best_d, best_i = _merge(best_d, best_i, d, start, k)
    return best_d, best_i


def chunked_topk_quantized(queries: torch.Tensor, q_gallery: torch.Tensor,
                           scale: torch.Tensor, gsq: torch.Tensor,
                           k: int = 32, chunk: int = 4096,
                           metric: str = "euclidean"):
    """Streaming top-k over an int8 gallery (rows g = s * qg, per-row
    scale ``scale`` and exact quantized-row squared norms ``gsq``).

    d^2(x, g) = |x|^2 + s^2 |qg|^2 - 2 s (x . qg), clamped at zero, with
    the contraction by :func:`split_bf16_inner`; "euclidean" takes its
    square root with no epsilon (the JAX function's form).  Euclidean
    metrics only: l1 has no scale-factored form."""
    if metric not in ("euclidean", "squaredeuclidean"):
        raise NotImplementedError(
            f"int8 gallery supports euclidean metrics, not {metric!r}")
    count("topk.walk")
    q = queries.float()
    xsq = (q * q).sum(dim=1, keepdim=True)                    # [Q, 1]
    s = scale.reshape(-1).float()
    gsq = gsq.reshape(-1).float()
    best_d, best_i = _init(q.shape[0], k, q.device)
    for start in range(0, q_gallery.shape[0], chunk):
        stop = start + chunk
        with span("topk.product"):
            inner = split_bf16_inner(
                q, q_gallery[start:stop].to(torch.bfloat16))
            d = torch.clamp(xsq + gsq[None, start:stop]
                            - 2.0 * s[None, start:stop] * inner, min=0.0)
            if metric == "euclidean":
                d = torch.sqrt(d)
        best_d, best_i = _merge(best_d, best_i, d, start, k)
    return best_d, best_i
