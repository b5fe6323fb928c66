"""Train steps that gather their batch from the device feature cache.

Counterpart of the JAX package's ``train/cached_steps.py``.  A fused
cached step takes a batch's index plan on the device and runs the TSN
gather from the resident int8 arrays (data/device_cache.py), then the
trainer's own step, with nothing read back: a batch costs one KB-sized
upload.  Each step draws the gather's uniforms first, modality by
modality, then its own mining and dropout draws, the order of the JAX
steps' key splits.

On a process mesh (a cache built over one) each rank gathers its own row
block of the batch and the step is the data-parallel one: the semi-hard
step of parallel/data_parallel.py, or the trainer's own step on its mesh.

``--steps_per_dispatch`` K > 1 (``dispatch_plan_window``): the K fused
steps of a window are issued back to back, each after its plan's upload,
with no host synchronisation between them; their scalars stay on the
device until the trainer's deferred flush.  The JAX package runs such a
window as one ``lax.scan`` program; here it is exactly the K calls of the
K=1 step, and a short window (the epoch's tail) is just fewer of them, so
no batch is dropped.  Capturing a window as one CUDA graph is ROADMAP
§1.5.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from multimodal_similarity_tpu_torch.parallel.data_parallel import (
    make_dp_triplet_step)
from multimodal_similarity_tpu_torch.train.steps import (
    make_triplet_train_step)
from multimodal_similarity_tpu_torch.utils.profiling import span


def make_cached_triplet_step(model, optimizer, cache, *,
                             triplet_per_batch: int, alpha: float = 0.2,
                             num_negative: int = 3,
                             metric: str = "squaredeuclidean",
                             normalized: bool = True, lambda_l2: float = 0.0,
                             gather_generator: torch.Generator = None,
                             mine_generator: torch.Generator = None
                             ) -> Callable:
    """The fused semi-hard step over ``cache``: step(packed, learning_rate)
    -> device scalars, ``packed`` a plan of ``cache.epoch_plans()`` on the
    device.  The gather draws from ``gather_generator``, the miner from
    ``mine_generator``.  Over a cache on a process mesh the step is
    ``make_dp_triplet_step`` on the rank's row block, with the whole
    batch's labels and mask."""
    kw = dict(triplet_per_batch=triplet_per_batch, alpha=alpha,
              num_negative=num_negative, metric=metric,
              normalized=normalized, lambda_l2=lambda_l2,
              generator=mine_generator)
    triplet_step = (make_triplet_train_step(model, optimizer, **kw)
                    if cache.mesh is None else
                    make_dp_triplet_step(model, optimizer, cache.mesh, **kw))

    def step(packed: torch.Tensor, learning_rate: float):
        gathered, labels, mask = cache.gather(packed, gather_generator)
        return triplet_step(gathered[0], labels, mask, learning_rate)

    return step


def make_cached_body_step(body: Callable, cache,
                          gather_generator: torch.Generator) -> Callable:
    """Any trainer's step over ``cache``: step(packed, learning_rate) ->
    ``body(events, labels, mask, learning_rate)``, ``events`` one entry a
    cached modality in the cache's form (the int8 ``{"q", "scale"}`` of a
    TSN modality, the dense mean of a ``meanpool`` one), as the two-call
    path's ``cache.epoch_batches`` gives them."""

    def step(packed: torch.Tensor, learning_rate: float):
        gathered, labels, mask = cache.gather(packed, gather_generator)
        return body(gathered, labels, mask, learning_rate)

    return step


def upload_plans(plan: np.ndarray, device) -> torch.Tensor:
    """A host plan to ``device`` in a copy that does not wait for the
    device's queued work."""
    return torch.from_numpy(np.ascontiguousarray(plan, np.int32)).to(
        device, non_blocking=True)


def dispatch_plan_window(win: Sequence[np.ndarray], learning_rate: float, *,
                         fused: Callable, device) -> List[dict]:
    """One window of host plans through the fused step ``fused(plan on the
    device, learning_rate)``, issued back to back.  Returns one
    device-scalars dict a step, in step order; each step, its plan's
    upload included, is a unit of the spans (``trainer.step``)."""
    out = []
    for plan in win:
        with span("trainer.step", unit=True):
            out.append(fused(upload_plans(plan, device), learning_rate))
    return out
