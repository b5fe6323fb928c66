"""Exact top-k retrieval in one pass over the gallery, written out.

Kernel (CUDA C++, ``csrc/topk.cu``): ``sqdist_topk`` forms the f32
distances of the queries to the gallery rows on the tensor cores through
3xTF32, as K7 (``csrc/distance.cu``) does, and keeps each query's k nearest
in its epilogue, so that neither the [Q, N] distance matrix nor a sort of
it reaches device memory; a second small kernel (``topk_merge``) merges the
gallery slices' lists.  It replaces no TPU kernel: the JAX package's
``ops/chunked_topk.py`` leaves the product and ``jax.lax.top_k`` to XLA.
It was added because the port's walk of that function
(``ops/chunked_topk.py``) spent 30 of a 1,024-query call's 37 ms over
400,000 rows of width 128 on an H100 writing, widening and radix-sorting
[Q, 65,536] distance blocks around a 0.4 ms product.  The products bound
it (2 Q N d operations at the 3xTF32 rate); reading the gallery once is a
tenth of that.

The result is the exact top-k of the kernel's own distances, in
``smallest_k``'s order (ascending, the lowest row first among equal
distances), deterministic whatever the order in which its blocks run;
slots past the gallery's rows, and rows at a distance of 1e30 or more,
come out as the walk's empty slots (1e30, -1).  ``ops/chunked_topk.py
chunked_topk`` routes a call to it by :func:`takes_kernel` (CUDA queries,
a euclidean metric, k <= 64); every other call takes
:func:`sqdist_topk_plain`, the walk.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_similarity_tpu_torch.ops.kernels._build import LAUNCHES, bind
from multimodal_similarity_tpu_torch.ops.kernels.distance import tma_depth
from multimodal_similarity_tpu_torch.utils.profiling import span

LAUNCHES.update(sqdist_topk=0)
MAX_K = 64
METRICS = ("euclidean", "squaredeuclidean")
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "sqdist_topk_slices": [_I, _I, _I],
    "sqdist_topk": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    "topk_merge": [_P, _I, _I, _I, _P, _P, _P],
}


def _fn(name: str):
    return bind("topk", name, _ARGTYPES[name])


def takes_kernel(queries: torch.Tensor, metric: str, k: int) -> bool:
    """Whether the f32 top-k of ``queries`` runs the kernel: they lie on a
    CUDA device, the metric is euclidean or squared euclidean, and k is at
    most MAX_K.  Everything else takes the walk."""
    return queries.is_cuda and metric in METRICS and k <= MAX_K


def sqdist_topk_plain(queries: torch.Tensor, gallery: torch.Tensor, k: int,
                      metric: str = "squaredeuclidean", chunk: int = 65536):
    """Plain PyTorch version: the walk of ``ops/chunked_topk.py``, IEEE f32
    products ``chunk`` gallery rows at a time, each merged into the
    running top-k by ``smallest_k``."""
    # imported here: ops/chunked_topk.py imports this module to route
    from multimodal_similarity_tpu_torch.ops.chunked_topk import walk_topk
    return walk_topk(queries, gallery, k, chunk, metric)


def sqdist_topk_kernel(queries: torch.Tensor, gallery: torch.Tensor, k: int,
                       metric: str = "squaredeuclidean"):
    """-> (dists [Q, k] f32, gallery rows [Q, k] int64), ascending: the
    kernel on the operands' CUDA device, on the current stream.  The
    distance kernel runs in the ``topk.product`` span, the slices' merge in
    ``topk.select``."""
    if queries.dim() != 2 or gallery.dim() != 2 or \
            queries.shape[1] != gallery.shape[1]:
        raise ValueError(f"sqdist_topk takes [Q, d] and [N, d], got "
                         f"{tuple(queries.shape)} and {tuple(gallery.shape)}")
    if queries.device != gallery.device:
        raise ValueError(f"operands on {queries.device} and {gallery.device}")
    if not queries.is_cuda:
        raise ValueError("sqdist_topk_kernel needs CUDA tensors")
    if metric not in METRICS:
        raise ValueError(f"sqdist_topk supports {METRICS}, not {metric!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"sqdist_topk takes 1 <= k <= {MAX_K}, not {k}")
    (nq, d), n = queries.shape, gallery.shape[0]
    if n == 0:
        raise ValueError("sqdist_topk needs a gallery of one row or more")
    if max(nq, n, d + 4) >= 2 ** 31:
        raise ValueError(f"shapes {tuple(queries.shape)}, "
                         f"{tuple(gallery.shape)} exceed the kernel's int32 "
                         "indexing")
    q4 = tma_depth(queries.float().contiguous())
    g4 = tma_depth(gallery.float().contiguous())
    dev = queries.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        slices = _fn("sqdist_topk_slices")(nq, n, k)
        keys = torch.empty(nq, slices, k, dtype=torch.int64, device=dev)
        with span("topk.product"):
            rc = _fn("sqdist_topk")(
                q4.data_ptr(), nq, g4.data_ptr(), n, q4.shape[1], k, slices,
                int(metric == "euclidean"), keys.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"sqdist_topk launch failed: CUDA error {rc}")
        dist = torch.empty(nq, k, dtype=torch.float32, device=dev)
        idx = torch.empty(nq, k, dtype=torch.int64, device=dev)
        with span("topk.select"):
            rc = _fn("topk_merge")(keys.data_ptr(), nq, slices, k,
                                   dist.data_ptr(), idx.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"topk_merge launch failed: CUDA error {rc}")
    LAUNCHES["sqdist_topk"] += 1
    return dist, idx

